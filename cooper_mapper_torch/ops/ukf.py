"""Generic unscented Kalman filter, batched (port of ``cooper_mapper_tpu/ops/ukf.py``;
``kf::UnscentedKalmanFilterX``, unscented_kalman_filter.hpp:16-244).

Sigma points from the Cholesky factor of (n + lambda) P, the unscented
predict through a process model plus additive noise, and the
augmented-state correct (state stacked with the measurement noise, the
Kalman gain from the cross-covariance).  Every function broadcasts over
leading batch dimensions.

Two things differ from the JAX package in how, not in what:

- JAX's ``cholesky`` returns NaN for a matrix that is not positive
  definite, and ``_safe_cholesky`` reads that to switch to a larger jitter.
  ``torch.linalg.cholesky`` raises instead, and on a card checks on the
  host.  ``cholesky_ex`` reports failure in ``info`` on the device, so the
  switch is a ``torch.where`` on ``info != 0`` or a NaN, with no host read.
- The gain's linear solve is ``solve_ex`` for the same reason.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class UKFState:
    mean: torch.Tensor  # [..., N]
    cov: torch.Tensor   # [..., N, N]


def _safe_cholesky(P, jitter=1e-9):
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    # symmetrize + escalating jitter keeps the factor finite
    P = 0.5 * (P + P.transpose(-1, -2))
    L, info = torch.linalg.cholesky_ex(P + jitter * eye)
    bad = (info != 0) | torch.isnan(L).any(dim=(-2, -1))
    L2, _ = torch.linalg.cholesky_ex(P + 1e-4 * eye)
    return torch.where(bad[..., None, None], L2, L)


def sigma_points(mean, cov, lam=1.0):
    """[..., N], [..., N, N] -> points [..., 2N+1, N], weights [2N+1]."""
    n = mean.shape[-1]
    L = _safe_cholesky((n + lam) * cov)
    cols = L.transpose(-1, -2)                  # rows are scaled sqrt columns
    m = mean[..., None, :]
    pts = torch.cat([m, m + cols, m - cols], dim=-2)
    w0 = lam / (n + lam)
    wi = 1.0 / (2.0 * (n + lam))
    weights = torch.cat([torch.tensor([w0], dtype=mean.dtype, device=mean.device),
                         torch.full((2 * n,), wi, dtype=mean.dtype, device=mean.device)])
    return pts, weights


def unscented_moments(pts, weights):
    mean = torch.einsum("s,...sn->...n", weights, pts)
    d = pts - mean[..., None, :]
    cov = torch.einsum("s,...sn,...sm->...nm", weights, d, d)
    return mean, cov


def predict(state: UKFState, f: Callable, control, Q, lam=1.0) -> UKFState:
    """Unscented predict: x' = f(x, control) for each sigma point, + Q."""
    pts, w = sigma_points(state.mean, state.cov, lam)
    mean, cov = unscented_moments(f(pts, control), w)
    return UKFState(mean, cov + Q)


def correct(state: UKFState, h: Callable, measurement, R, lam=1.0) -> UKFState:
    """Augmented-state unscented correct (reference :104-148): the state is
    extended with K measurement-noise components (zero mean, covariance R),
    and the extended sigma points run through h with the noise added."""
    n = state.mean.shape[-1]
    k = measurement.shape[-1]
    batch = state.mean.shape[:-1]
    dt, dev = state.mean.dtype, state.mean.device

    ext_mean = torch.cat([state.mean, torch.zeros(batch + (k,), dtype=dt, device=dev)], -1)
    ext_cov = torch.zeros(batch + (n + k, n + k), dtype=dt, device=dev)
    ext_cov[..., :n, :n] = state.cov
    ext_cov[..., n:, n:] = R.expand(batch + (k, k))

    pts, w = sigma_points(ext_mean, ext_cov, lam)
    x_pts = pts[..., :n]
    z_pts = h(x_pts) + pts[..., n:]

    z_mean = torch.einsum("s,...sk->...k", w, z_pts)
    dz = z_pts - z_mean[..., None, :]
    dx = x_pts - torch.einsum("s,...sn->...n", w, x_pts)[..., None, :]
    S = torch.einsum("s,...sk,...sl->...kl", w, dz, dz)
    C = torch.einsum("s,...sn,...sk->...nk", w, dx, dz)

    K, _ = torch.linalg.solve_ex(S.transpose(-1, -2), C.transpose(-1, -2))
    K = K.transpose(-1, -2)                      # C S^-1
    innov = measurement - z_mean
    mean = state.mean + torch.einsum("...nk,...k->...n", K, innov)
    cov = state.cov - K @ S @ K.transpose(-1, -2)
    return UKFState(mean, cov)
