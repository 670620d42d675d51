"""Batched 6-DoF Gauss-Newton machinery (port of ``cooper_mapper_tpu/ops/gauss_newton.py``).

Masked normal-equation assembly, the 6x6 solve, the iteration-0 degeneracy
projector, NaN scrubbing and the deltaR/deltaT convergence test
(LaserOdometry.cpp:505-644).  Two modes, as in the JAX package: the native
one (Cholesky with a relative Tikhonov floor, the spectral projector, the
projected system on degenerate lanes) and the reference mode of the parity
solves (an LU solve of the full system, then the Eigen port's row-zeroing
projector ``matV.inverse() @ matV2``).  No function here reads a value back
to the host: the LU factorisation reports failure in its ``info`` tensor,
which is never read, and a singular system gives inf/NaN that ``nan_guard``
scrubs, as ``jnp.linalg.solve`` does in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import profiling


def assemble_normal_eqs(J, b, valid):
    """J [..., N, 6], b [..., N], valid [..., N] bool ->
    (JtJ [..., 6, 6], Jtb [..., 6], n_valid [...]).

    Invalid rows are hard-zeroed with ``torch.where``, never multiplied:
    masked rows can hold NaN/Inf from FAR-sentinel geometry and 0 * NaN = NaN
    would poison the whole system.  Span ``gn.normal_eqs``; counter ``rows``
    (the valid rows).
    """
    with profiling.span("gn.normal_eqs"):
        profiling.count("rows", valid)
        Jm = torch.where(valid[..., None], J, torch.zeros((), dtype=J.dtype, device=J.device))
        bm = torch.where(valid, b, torch.zeros((), dtype=b.dtype, device=b.device))
        JtJ = Jm.transpose(-1, -2) @ Jm
        Jtb = (Jm.transpose(-1, -2) @ bm[..., None])[..., 0]
        return JtJ, Jtb, valid.to(J.dtype).sum(dim=-1)


def _eye6(like):
    return torch.eye(6, dtype=like.dtype, device=like.device)


def solve_6x6(JtJ, Jtb, spd: bool = True):
    """Solve JtJ dx = Jtb, [..., 6, 6] x [..., 6].

    ``spd=True`` (native mode): JtJ is symmetric PSD by construction, so the
    solve is Cholesky with a RELATIVE Tikhonov floor (1e-7 x mean diagonal),
    which keeps a rank-deficient system positive definite in f32; the
    degeneracy projector then removes the huge-but-finite null-direction
    update.

    ``spd=False`` (parity mode): LU with partial pivoting after a 1e-12
    absolute floor, the JAX package's ``jnp.linalg.solve`` (the reference
    solves with ColPivHouseholderQR, LaserOdometry.cpp:577-581).
    ``lu_factor_ex`` leaves its ``info`` unread, so an exactly singular
    system neither raises nor waits for the card: it comes back inf/NaN.
    """
    if not spd:
        LU, pivots, _ = torch.linalg.lu_factor_ex(JtJ + 1e-12 * _eye6(JtJ))
        return torch.linalg.lu_solve(LU, pivots, Jtb[..., None])[..., 0]
    tr = torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = JtJ + (1e-7 / 6.0 * tr + 1e-12) * _eye6(JtJ)
    return _cholesky6_solve(A, Jtb)


def _cholesky6_solve(A, b):
    """Unrolled batched 6x6 Cholesky solve, elementwise over the batch.
    Non-PSD input yields NaN from sqrt, which nan_guard scrubs."""
    n = 6
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    inv = [None] * n
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv[j] = 1.0 / d
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv[i]
    return torch.stack(x, dim=-1)


# Matrices per eigh call: on the card, cuSOLVER's batched solver
# (cusolverDnXsyevBatched) rejects 32768 or more in one call
# (CUSOLVER_STATUS_INVALID_VALUE), and a batch of problems may hold more.
EIGH_BATCH = 1 << 14


def eigh(A):
    """``torch.linalg.eigh`` of a batch [..., n, n], EIGH_BATCH matrices per
    call where the batch is larger (each matrix is solved on its own, so the
    pieces give what one call would)."""
    lead = A.shape[:-2]
    flat = A.reshape(-1, *A.shape[-2:])
    if flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_BATCH)]
    return (torch.cat([p[0] for p in parts]).reshape(*lead, -1),
            torch.cat([p[1] for p in parts]).reshape(A.shape))


def degeneracy_projector(JtJ, eig_threshold, reference_mode: bool = False):
    """Projector that removes the update directions whose eigenvalue of JtJ
    is below the threshold (LaserOdometry.cpp:583-608, ScanMatch.cpp:211-235).
    Returns (P [..., 6, 6], is_degenerate [...]).

    Native mode: the spectral projector P = V diag(lam >= thr) V^T.
    ``reference_mode=True``: the Eigen port's literal
    ``matV.inverse() @ matV2``, which zeroes ROWS of the column-eigenvector
    matrix: P = V^T Vz.  That P depends on the sign each eigenvector comes
    back with (flipping column a flips P[a, b] for every b != a), so it is
    as reproducible as the eigensolver's signs (ROADMAP Queue 3).
    ``torch.linalg.eigh`` stays a library call, as ``jnp.linalg.eigh`` does
    in the JAX package (``eigh``: in pieces of EIGH_BATCH)."""
    evals, V = eigh(JtJ)       # ascending
    keep = evals >= eig_threshold
    is_degenerate = torch.any(~keep, dim=-1)
    if reference_mode:
        Vz = torch.where(keep[..., :, None], V, torch.zeros((), dtype=V.dtype, device=V.device))
        return V.transpose(-1, -2) @ Vz, is_degenerate
    P = (V * keep.to(JtJ.dtype)[..., None, :]) @ V.transpose(-1, -2)
    return P, is_degenerate


def nan_guard(x):
    """Reset non-finite components to 0 (LaserOdometry.cpp:622-634)."""
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def convergence_deltas(dx):
    """(deltaR [deg], deltaT [cm]) of an update (rx,ry,rz,tx,ty,tz)
    (LaserOdometry.cpp:636-640)."""
    delta_r = torch.rad2deg(torch.linalg.vector_norm(dx[..., :3], dim=-1))
    delta_t = 100.0 * torch.linalg.vector_norm(dx[..., 3:], dim=-1)
    return delta_r, delta_t


@dataclasses.dataclass
class GNState:
    """Carry of the batched iterative solve."""

    x: torch.Tensor              # [..., 6] current estimate
    P: torch.Tensor              # [..., 6, 6] degeneracy projector
    is_degenerate: torch.Tensor  # [...] bool
    converged: torch.Tensor      # [...] bool: freezes further updates
    n_matched: torch.Tensor      # [...] residuals in the last build
    iter_used: torch.Tensor      # [...] int32 iterations applied


def gn_init(x0):
    batch = x0.shape[:-1]
    dev = x0.device
    return GNState(
        x=x0,
        P=_eye6(x0).expand(batch + (6, 6)),
        is_degenerate=torch.zeros(batch, dtype=torch.bool, device=dev),
        converged=torch.zeros(batch, dtype=torch.bool, device=dev),
        n_matched=torch.zeros(batch, dtype=x0.dtype, device=dev),
        iter_used=torch.zeros(batch, dtype=torch.int32, device=dev),
    )


def _clamp_norm(v, limit):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v * torch.clamp(limit / torch.clamp(n, min=1e-12), max=1.0)


def gn_step(state: GNState, JtJ, Jtb, n_valid, iteration: int, eig_threshold,
            delta_r_abort, delta_t_abort, min_matched, reference_mode: bool = False,
            trust_region_t=0.0, trust_region_r=0.0, min_converge_iter=0,
            compute_projector: bool = False, lm_damping: float = 0.0):
    """One masked GN update with the reference's guards.

    Converged lanes and lanes with too few matches keep their state
    (LaserOdometry.cpp:501).  ``trust_region_t/r`` clamp the step's
    translation/rotation norms; ``min_converge_iter`` forbids convergence
    before the first refresh.  ``compute_projector`` eigendecomposes JtJ
    (iteration 0 only).  Native mode: degenerate lanes solve the projected
    system ``P JtJ P + (I - P)`` with right-hand side ``P Jtb``.
    ``reference_mode=True``: the literal reference dynamics, an LU solve of
    the full system, then ``P @ dx`` on degenerate lanes
    (LaserOdometry.cpp:609-613), with the row-zeroing projector.
    ``lm_damping`` is added before the solve in both modes, as the JAX
    package does (ROADMAP Queue 3).  Span ``gn.update``.
    """
    with profiling.span("gn.update"):
        if compute_projector:
            P, is_degenerate = degeneracy_projector(JtJ, eig_threshold, reference_mode)
        else:
            P, is_degenerate = state.P, state.is_degenerate

        if lm_damping > 0.0:
            diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
            JtJ = JtJ + lm_damping * torch.diag_embed(diag)

        if reference_mode:
            dx = solve_6x6(JtJ, Jtb, spd=False)
            dx = torch.where(is_degenerate[..., None], (P @ dx[..., None])[..., 0], dx)
        else:
            eye = _eye6(JtJ)
            A_eff = torch.where(is_degenerate[..., None, None], P @ JtJ @ P + (eye - P), JtJ)
            b_eff = torch.where(is_degenerate[..., None], (P @ Jtb[..., None])[..., 0], Jtb)
            dx = solve_6x6(A_eff, b_eff)

        if trust_region_t > 0.0:
            dx = torch.cat([dx[..., :3], _clamp_norm(dx[..., 3:], trust_region_t)], dim=-1)
        if trust_region_r > 0.0:
            dx = torch.cat([_clamp_norm(dx[..., :3], trust_region_r), dx[..., 3:]], dim=-1)
        dx = nan_guard(dx)

        active = (~state.converged) & (n_valid >= min_matched)
        x_new = nan_guard(state.x + torch.where(active[..., None], dx, torch.zeros_like(dx)))

        delta_r, delta_t = convergence_deltas(dx)
        just_converged = (active & (delta_r < delta_r_abort) & (delta_t < delta_t_abort)
                          & (iteration >= min_converge_iter))
        return GNState(
            x=x_new,
            P=P,
            is_degenerate=is_degenerate,
            converged=state.converged | just_converged,
            n_matched=n_valid,
            iter_used=state.iter_used + active.to(torch.int32),
        )
