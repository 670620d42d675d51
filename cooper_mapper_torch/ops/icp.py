"""Point-to-point ICP, the coarse loop-closure aligner
(port of ``cooper_mapper_tpu/ops/icp.py``; the PCL ICP of
``LoopDetector::corseMatching``, loop_detector.hpp:228-250).

Nearest-neighbour correspondences and a closed-form weighted rigid fit
(Kabsch / Umeyama), iterated on masked fixed-shape clouds.  The
correspondence search is the odometry's race A, ``ops/races.nn1``: on the
card the nn1 kernel (M split across blocks and merged where one query row
would not fill the card), on the CPU its plain version.  The fine
alignment stays ``ops/scan_match.scan_match_local``.
"""

from __future__ import annotations

import torch

from ..utils import se3
from ..utils.cloud import Cloud
from . import races


def _kabsch(src, dst, w):
    """Weighted rigid fit dst ~ R src + t.  src / dst [N, 3], w [N].

    With no weight at all the cross-covariance S is zero and its SVD is not
    unique; LAPACK, which the JAX package runs on the CPU, gives U = V = I
    there, so R = I, and the port selects I explicitly on either device."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mu_s = torch.sum(src * w[:, None], 0) / wsum
    mu_d = torch.sum(dst * w[:, None], 0) / wsum
    S = (src - mu_s).T @ ((dst - mu_d) * w[:, None])
    U, _, Vt = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    one = torch.ones_like(d)
    R = Vt.T @ torch.diag(torch.stack([one, one, d])) @ U.T
    R = torch.where(torch.all(S == 0), torch.eye(3, dtype=R.dtype, device=R.device), R)
    t = mu_d - R @ mu_s
    return se3.make_mat(R, t)


def _nearest(T, source: Cloud, target: Cloud, max_corr_dist: float):
    """Source moved by T, its nearest target points (idx, squared distance)
    and the inlier mask."""
    src_w = se3.apply(T, source.xyz)
    idx, d = races.nn1(src_w[None], target.xyz, target.mask)
    idx, d = idx[0].long(), d[0]
    return src_w, idx, d, source.mask & (d < max_corr_dist ** 2)


def icp(source: Cloud, target: Cloud, T0, max_iterations: int = 10,
        max_corr_dist: float = 2.0):
    """Align ``source`` onto ``target`` starting from T0 [4, 4].  Returns
    (T, rmse, n_inliers) as tensors; ``max_iterations`` fits run with no host
    read between them."""
    T = T0
    for _ in range(max_iterations):
        src_w, idx, _, ok = _nearest(T, source, target, max_corr_dist)
        T = _kabsch(src_w, target.xyz[idx], ok.to(torch.float32)) @ T
    _, _, d, ok = _nearest(T, source, target, max_corr_dist)
    n = torch.sum(ok)
    rmse = torch.sqrt(torch.sum(torch.where(ok, d, 0.0)) / torch.clamp(n, min=1))
    return T, rmse, n
