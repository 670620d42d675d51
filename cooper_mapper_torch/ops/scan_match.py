"""Scan-to-map Gauss-Newton solve with match-quality gating, batched
(port of ``cooper_mapper_tpu/ops/scan_match.py``; ScanMatch.cpp:51-398).

Per iteration: register the frame's corner/surf features into the map frame
at the current pose, find their ``cfg.knn`` (5) nearest reference points
(``ops/knn.py``, any k on the card),
fit a PCA line to each corner neighbourhood and an LSQ plane to each surf
neighbourhood, build masked 6-DoF normal equations with the map-variant
robust weights and take a GN step (the iteration-0 degeneracy projector,
eigen threshold 100).  After the loop the residuals are rebuilt at the
solved pose and the result is gated on the score ``sum(exp(-|d|))`` and the
matched fraction.

The batch is an explicit leading dimension: frames are ``[B, N, 3]``; the
reference clouds are shared (xyz ``[M, 3]``, one map matched by every
frame) or per problem (xyz ``[B, M, 3]``), as in ``batch_odometry_solve``.
``parity_mode=True`` reproduces the reference's literal iteration dynamics
(ScanMatch.cpp:51-260): the port-typo arz Jacobian row, no collinearity
rejection in the plane fits, the LU solve and the row-zeroing degeneracy
projector (tests/ref_oracle.scan_match_scan holds it, iteration by
iteration).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ScanMatchConfig
from ..utils import profiling, twist
from ..utils.cloud import Cloud
from . import gauss_newton as gn
from . import neighbors, residuals
from .odometry import _reference_jacobian_rows, check_knobs
from .voxel import voxel_downsample


@dataclasses.dataclass
class ScanMatchResult:
    x: torch.Tensor               # [..., 6] refined pose (TZYX twist)
    success: torch.Tensor         # [...] bool: converged, passed the score gate, enough_ref
    converged: torch.Tensor       # [...] bool
    score: torch.Tensor           # [...] sum(exp(-|weighted residual|))
    match_fraction: torch.Tensor  # [...] geometric fits found / valid frame points
    n_matched: torch.Tensor       # [...] residuals in the last GN step
    is_degenerate: torch.Tensor   # [...] bool
    iter_used: torch.Tensor       # [...] int32
    enough_ref: torch.Tensor      # [...] bool: the reference clouds met the size floor


def _neighbour_planes(ref_xyz, idx, shared: bool):
    """Neighbour coordinates as per-axis lists of K [B, N] component planes.
    One gather of the [B, N*K, 3] neighbour points, then views."""
    B, N, K = idx.shape
    nb = neighbors.take_ref(ref_xyz, idx.reshape(B, N * K), shared).reshape(B, N, K, 3)
    return tuple([nb[..., j, ax] for j in range(K)] for ax in range(3))


def _build_residuals(x, corner: Cloud, surf: Cloud, ref_corner: Cloud,
                     ref_surf: Cloud, cfg: ScanMatchConfig, parity_mode: bool = False):
    """One correspondence + residual build at poses x [B, 6].

    Returns (J [B, Nc+Ns, 6], b, ok, found), the last three [B, Nc+Ns]:
    ``ok`` gates the normal equations, ``found`` (the geometric fit alone,
    ScanMatch.cpp:111,129) counts matches.  ``parity_mode`` drops the
    collinearity rejection of the plane fits (the reference's findPlane,
    feature_utils.h:158-204, has none) and takes the port-typo Jacobian.
    Spans ``scan_match.search`` (counter ``knn_gated``: valid frame points
    whose k-th neighbour is near enough), ``scan_match.fit`` (counter
    ``fits_accepted``: those whose line or plane fit holds) and
    ``gn.residuals``.
    """
    with profiling.span("scan_match.search"):
        pc = twist.point_to_map(x, corner.xyz)
        ps = twist.point_to_map(x, surf.xyz)
        idx_c, d_c = neighbors.knn_search(pc, ref_corner.xyz, ref_corner.mask, cfg.knn)
        idx_s, d_s = neighbors.knn_search(ps, ref_surf.xyz, ref_surf.mask, cfg.knn)
        gate_c = (d_c[..., -1] < cfg.nn_sq_dist_max) & corner.mask
        gate_s = (d_s[..., -1] < cfg.nn_sq_dist_max) & surf.mask
        profiling.count("knn_gated", gate_c)
        profiling.count("knn_gated", gate_s)

    with profiling.span("scan_match.fit"):
        cx, cy, cz = _neighbour_planes(ref_corner.xyz, idx_c, ref_corner.xyz.dim() == 2)
        A, B, line_ok = residuals.fit_line_planes(cx, cy, cz, gate_c, cfg.line_eig_ratio)
        sx, sy, sz = _neighbour_planes(ref_surf.xyz, idx_s, ref_surf.xyz.dim() == 2)
        plane, plane_ok = residuals.fit_plane_planes(sx, sy, sz, gate_s, cfg.plane_max_dist,
                                                     planar_ratio=0.0 if parity_mode else 0.05)
        found_c, found_s = line_ok & gate_c, plane_ok & gate_s
        profiling.count("fits_accepted", found_c)
        profiling.count("fits_accepted", found_s)

    with profiling.span("gn.residuals"):
        dir_c, res_c, w_ok_c = residuals.corner_coeff_map(A, B, pc, cfg.weight_slope,
                                                          cfg.weight_min)
        dir_s, res_s, w_ok_s = residuals.surf_coeff_map(plane, ps, cfg.weight_slope,
                                                        cfg.weight_min)
        J_c = _reference_jacobian_rows(x, corner.xyz, dir_c, port_typo=parity_mode)
        J_s = _reference_jacobian_rows(x, surf.xyz, dir_s, port_typo=parity_mode)
        J = torch.cat([J_c, J_s], dim=-2)
        b = torch.cat([-res_c, -res_s], dim=-1)
        ok = torch.cat([line_ok & w_ok_c & gate_c, plane_ok & w_ok_s & gate_s], dim=-1)
        found = torch.cat([found_c, found_s], dim=-1)
    return J, b, ok, found


def batch_scan_match(corner: Cloud, surf: Cloud, ref_corner: Cloud, ref_surf: Cloud,
                     x0, cfg: ScanMatchConfig = ScanMatchConfig(), chunk: int = 512,
                     parity_mode: bool = False) -> ScanMatchResult:
    """Refine B world poses against reference feature clouds.

    corner/surf: frame clouds with xyz [B, N, 3]; ref_corner/ref_surf: shared
    (xyz [M, 3]) or per problem (xyz [B, M, 3]); x0: [B, 6] TZYX twists.
    Runs on the tensors' device.  ``chunk`` is the JAX package's query-chunk
    memory knob: accepted for signature parity, it changes nothing.
    Every lane runs ``max_iterations`` steps; a converged lane keeps its state.
    ``parity_mode=True`` takes the reference's iteration dynamics.

    Span ``scan_match.solve``, a call's root; counters ``query_points``
    (valid corner and surf points), ``lanes`` (B), ``steps``
    (``max_iterations``) and ``lane_steps`` (sum of ``iter_used``).  The
    score gate's build is span ``scan_match.score``.
    """
    check_knobs(cfg.kernel_backend)
    with profiling.span("scan_match.solve", call=True):
        profiling.count("query_points", corner.mask)
        profiling.count("query_points", surf.mask)
        profiling.count("lanes", x0.shape[0])
        profiling.count("steps", cfg.max_iterations)
        res = _solve(corner, surf, ref_corner, ref_surf, x0, cfg, parity_mode)
        profiling.count("lane_steps", res.iter_used)
    return res


def _solve(corner, surf, ref_corner, ref_surf, x0, cfg, parity_mode) -> ScanMatchResult:
    n_batch = x0.shape[0]
    enough_ref = ((ref_corner.mask.sum(-1) >= 50) & (ref_surf.mask.sum(-1) >= 100)
                  ).expand(n_batch)

    def step(st, it, compute_projector=False):
        J, b, ok, _ = _build_residuals(st.x, corner, surf, ref_corner, ref_surf, cfg,
                                       parity_mode)
        JtJ, Jtb, n_valid = gn.assemble_normal_eqs(J, b, ok)
        return gn.gn_step(
            st, JtJ, Jtb, torch.where(enough_ref, n_valid, 0.0), it,
            cfg.eig_threshold, cfg.delta_r_abort, cfg.delta_t_abort, cfg.min_matched,
            reference_mode=parity_mode, compute_projector=compute_projector,
            lm_damping=cfg.lm_damping,
        )

    # iteration 0 peeled: the degeneracy eigendecomposition runs once
    st = step(gn.gn_init(x0), 0, compute_projector=True)
    for it in range(1, cfg.max_iterations):
        st = step(st, it)

    with profiling.span("scan_match.score"):
        # score gate at the solved pose (ScanMatch.cpp:263-341); the reference
        # scores the last pre-update build, which differs by one sub-threshold step
        _, b, ok, found = _build_residuals(st.x, corner, surf, ref_corner, ref_surf, cfg,
                                           parity_mode)
        score = torch.sum(torch.where(ok, torch.exp(-torch.abs(b)), 0.0), dim=-1)
        total = corner.mask.sum(-1) + surf.mask.sum(-1)
        match_fraction = found.sum(-1).float() / torch.clamp(total, min=1).float()
        if cfg.use_score:
            gated = (score >= cfg.score_threshold) & (
                match_fraction >= cfg.match_percentage_threshold)
        else:
            gated = torch.ones_like(st.converged)
    return ScanMatchResult(
        x=st.x,
        success=st.converged & gated & enough_ref,
        converged=st.converged,
        score=score,
        match_fraction=match_fraction,
        n_matched=st.n_matched,
        is_degenerate=st.is_degenerate,
        iter_used=st.iter_used,
        enough_ref=enough_ref,
    )


def _add_batch(c: Cloud) -> Cloud:
    return Cloud(c.xyz[None], c.mask[None], c.ring[None], c.rel_time[None])


def scan_match(corner: Cloud, surf: Cloud, ref_corner: Cloud, ref_surf: Cloud, x0,
               cfg: ScanMatchConfig = ScanMatchConfig(), chunk: int = 512,
               parity_mode: bool = False) -> ScanMatchResult:
    """One problem: clouds without a batch dimension, x0 [6].  Result fields
    carry no batch dimension."""
    res = batch_scan_match(_add_batch(corner), _add_batch(surf), ref_corner, ref_surf,
                           x0[None], cfg, chunk, parity_mode)
    return ScanMatchResult(*(getattr(res, f.name)[0]
                             for f in dataclasses.fields(ScanMatchResult)))


def scan_match_local(corner: Cloud, surf: Cloud, ref_corner: Cloud, ref_surf: Cloud,
                     x0, cfg: ScanMatchConfig = ScanMatchConfig(),
                     chunk: int = 512) -> ScanMatchResult:
    """scanMatchLocal (ScanMatch.cpp:375-398) for one problem: voxel-downsample
    both sides (corner 0.2 m / surf 0.4 m leaves), then ``scan_match``."""
    return scan_match(
        voxel_downsample(corner, cfg.local_corner_leaf),
        voxel_downsample(surf, cfg.local_surf_leaf),
        voxel_downsample(ref_corner, cfg.local_corner_leaf),
        voxel_downsample(ref_surf, cfg.local_surf_leaf),
        x0, cfg, chunk,
    )
