"""Scan-to-scan Gauss-Newton odometry solve, batched
(port of ``cooper_mapper_tpu/ops/odometry.py``; LaserOdometry.cpp:328-647).

Per iteration: warp the sharp/flat query features, find point-to-line and
point-to-plane correspondences against the previous sweep's features
(refreshed every ``refresh_every`` iterations, :358), assemble masked 6-DoF
normal equations and take a guarded GN step.  The batch is an explicit
leading dimension; the reference clouds are shared (xyz ``[M, 3]``) or per
problem (xyz ``[B, M, 3]``).

Two solver modes, as in the JAX package:
* ``parity_mode=False`` (default): exact per-point Jacobians of the in-sweep
  warp (rigid per-problem trig under ``cv_dewarp``), full GN steps, trust
  regions; with ``cfg.dewarp_passes > 1`` each further pass re-de-warps the
  original clouds with the previous pass's twist.
* ``parity_mode=True``: the reference's literal iteration dynamics: the
  closed-form Jacobian at s = 1 with the port's missing-parenthesis arz
  term (LaserOdometry.cpp:567), the -0.05 residual under-relaxation
  (:575), the LU solve and the row-zeroing degeneracy projector (:583-613),
  no trust region and no cv de-warp.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import OdometryConfig
from ..utils import profiling, twist
from ..utils.cloud import Cloud
from . import gauss_newton as gn
from . import neighbors, races, residuals


@dataclasses.dataclass
class Correspondences:
    """Correspondence geometry of one refresh block, gathered once so the
    inner GN iterations run gather-free.  [B, N, 3] points, [B, N] masks."""

    A_c: torch.Tensor
    B_c: torch.Tensor
    ok_c: torch.Tensor
    A_s: torch.Tensor
    B_s: torch.Tensor
    C_s: torch.Tensor
    ok_s: torch.Tensor


def _tzyx_rotation_rows(srx, crx, sry, cry, srz, crz, points, coeff_dir):
    """coeff . d(Rz Ry Rx p)/d(rx, ry, rz): the closed-form trig rows of
    LaserOdometry.cpp:557-575 with elementwise angle sines/cosines."""
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    cx, cy, cz = coeff_dir[..., 0], coeff_dir[..., 1], coeff_dir[..., 2]
    arx = (
        ((crz * sry * crx + srz * srx) * py + (srz * crx - crz * sry * srx) * pz) * cx
        + ((srz * sry * crx - crz * srx) * py - (srz * sry * srx + crz * crx) * pz) * cy
        + (cry * crx * py - cry * srx * pz) * cz
    )
    ary = (
        (-crz * sry * px + crz * cry * srx * py + crz * cry * crx * pz) * cx
        + (-srz * sry * px + srz * cry * srx * py + srz * cry * crx * pz) * cy
        + (-cry * px - sry * srx * py - sry * crx * pz) * cz
    )
    arz = (
        (-srz * cry * px - (srz * sry * srx + crz * crx) * py + (crz * srx - srz * sry * crx) * pz) * cx
        + (crz * cry * px + (crz * sry * srx - srz * crx) * py + (crz * sry * crx + srz * srx) * pz) * cy
    )
    return arx, ary, arz


def _jacobian_rows(arx, ary, arz, coeff_dir):
    return torch.stack([arx, ary, arz, coeff_dir[..., 0], coeff_dir[..., 1],
                        coeff_dir[..., 2]], dim=-1)


def _exact_jacobian_rows(x, pts, s, coeff_dir):
    """Exact d(coeff . warp_to_start(x, p, s))/dx rows: ``s * J_tzyx(s*x, p)``.
    x [B, 6], pts [B, N, 3], s [B, N] -> [B, N, 6]."""
    a, b, c = (s * x[..., None, i] for i in range(3))
    rows = _jacobian_rows(*_tzyx_rotation_rows(
        torch.sin(a), torch.cos(a), torch.sin(b), torch.cos(b), torch.sin(c),
        torch.cos(c), pts, coeff_dir), coeff_dir)
    return s[..., None] * rows


def _reference_jacobian_rows(x, points, coeff_dir, port_typo: bool = False):
    """The reference's closed-form Jacobian rows at s = 1
    (LaserOdometry.cpp:557-575, ScanMatch.cpp:185-195) with per-problem
    sines and cosines: the exact ``d(coeff . (Rz Ry Rx p + t))/dx``, which
    is also the rigid (cv_dewarp) solve's, since that solve rewrites every
    time fraction to 1.  x [B, 6], points [B, N, 3] -> [B, N, 6].

    ``port_typo=True`` reproduces the reference's missing-parenthesis arz
    row (LaserOdometry.cpp:567, identically ScanMatch.cpp:194): its coeff.y
    term reads ``crz*sry*crx + srz*srx*pz``, so the row gains
    ``crz*sry*crx*(1 - pz)*c_y``, which vanishes near sry ~ 0.  The parity
    modes use it."""
    sc = [(torch.sin(x[..., i, None]), torch.cos(x[..., i, None])) for i in range(3)]
    (srx, crx), (sry, cry), (srz, crz) = sc
    arx, ary, arz = _tzyx_rotation_rows(srx, crx, sry, cry, srz, crz, points, coeff_dir)
    if port_typo:
        arz = arz + (crz * sry * crx) * (1.0 - points[..., 2]) * coeff_dir[..., 1]
    return _jacobian_rows(arx, ary, arz, coeff_dir)


def _warp(x, c: Cloud, rigid: bool):
    if rigid:
        return twist.point_to_map(x, c.xyz)
    return twist.warp_to_start(x, c.xyz, c.rel_time)


def _find_correspondences(x, sharp: Cloud, flat: Cloud, last_corner: Cloud,
                          last_surf: Cloud, cfg: OdometryConfig, rigid: bool,
                          lists: tuple):
    """One refresh block's searches and gathers (span ``odometry.refresh``;
    counter ``race_matched``: the valid query points that found their
    line or plane; the races' ``race_pairs_walked`` / ``race_pairs_padded``).
    The races walk ``lists``, ``races.valid_list`` of the sharp, flat,
    last_corner and last_surf masks: the valid queries against the valid
    reference points."""
    sharp_l, flat_l, corner_l, surf_l = lists
    with profiling.span("odometry.refresh"):
        pc = _warp(x, sharp, rigid)
        ps = _warp(x, flat, rigid)
        ia_c, ib_c, ok_c = neighbors.corner_pairs(pc, last_corner, cfg.nn_sq_dist_max,
                                                  cfg.ring_span, cfg.nn_query_chunk,
                                                  sharp_l, corner_l)
        ia_s, ib_s, ic_s, ok_s = neighbors.surf_triples(ps, last_surf, cfg.nn_sq_dist_max,
                                                        cfg.ring_span, cfg.nn_query_chunk,
                                                        flat_l, surf_l)
        shared_c = last_corner.xyz.dim() == 2
        shared_s = last_surf.xyz.dim() == 2
        take = neighbors.take_ref
        corr = Correspondences(
            A_c=take(last_corner.xyz, ia_c, shared_c),
            B_c=take(last_corner.xyz, ib_c, shared_c),
            ok_c=ok_c & sharp.mask,
            A_s=take(last_surf.xyz, ia_s, shared_s),
            B_s=take(last_surf.xyz, ib_s, shared_s),
            C_s=take(last_surf.xyz, ic_s, shared_s),
            ok_s=ok_s & flat.mask,
        )
        profiling.count("race_matched", corr.ok_c)
        profiling.count("race_matched", corr.ok_s)
        return corr


# The JAX package's kernel_backend values, and the nn_precision strings it
# accepts (jax.lax.Precision's names): on the CPU each gives the default's
# distances there, and the port's products stay full f32 at every one.
KERNEL_BACKENDS = ("auto", "pallas", "dense")
NN_PRECISIONS = (None, "default", "high", "highest", "bfloat16", "bfloat16_3x",
                 "tensorfloat32", "float32", "fastest")


def check_knobs(kernel_backend, nn_precision=None, nn_query_chunk=0):
    """Validate the JAX package's dispatch, precision and memory knobs.
    None of them changes a result: ``kernel_backend`` names the same search
    (the tensors' device picks kernel or plain version, never the knob), the
    products are full f32 at every ``nn_precision``, and ``nn_query_chunk``
    only caps the plain versions' distance tile."""
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}, got "
                         f"{kernel_backend!r}")
    if nn_precision not in NN_PRECISIONS:
        raise ValueError(f"nn_precision must be one of {NN_PRECISIONS}, got {nn_precision!r}")
    if not (isinstance(nn_query_chunk, int) and nn_query_chunk >= 0):
        raise ValueError(f"nn_query_chunk must be an int >= 0, got {nn_query_chunk!r}")


def _odometry_solve_pass(sharp: Cloud, flat: Cloud, last_corner: Cloud,
                         last_surf: Cloud, x0, cfg: OdometryConfig,
                         parity_mode: bool = False):
    """One de-warp/solve pass over the batch.  Returns (x [B, 6], GNState).

    An outer loop over correspondence refreshes, each followed by GN steps on
    the frozen correspondences; iteration 0, the only one that
    eigendecomposes JtJ for the degeneracy projector, is peeled off.
    """
    rigid = cfg.cv_dewarp and not parity_mode

    def residual_rows(st, corr, it):
        """The iteration's warps, coefficients and Jacobian rows (span
        ``gn.residuals``): (J, b, ok)."""
        with profiling.span("gn.residuals"):
            pc = _warp(st.x, sharp, rigid)
            ps = _warp(st.x, flat, rigid)
            dir_c, res_c, w_ok_c = residuals.corner_coeff_odometry(
                corr.A_c, corr.B_c, pc, it, cfg.corner_weight_slope, cfg.weight_min)
            dir_s, res_s, w_ok_s = residuals.surf_coeff_odometry(
                corr.A_s, corr.B_s, corr.C_s, ps, it, cfg.corner_weight_slope,
                cfg.weight_min)
            if parity_mode:
                J_c = _reference_jacobian_rows(st.x, sharp.xyz, dir_c, port_typo=True)
                J_s = _reference_jacobian_rows(st.x, flat.xyz, dir_s, port_typo=True)
                res_c, res_s = cfg.residual_scale * res_c, cfg.residual_scale * res_s
            elif rigid:
                J_c = _reference_jacobian_rows(st.x, sharp.xyz, dir_c)
                J_s = _reference_jacobian_rows(st.x, flat.xyz, dir_s)
            else:
                J_c = _exact_jacobian_rows(st.x, sharp.xyz, sharp.rel_time, dir_c)
                J_s = _exact_jacobian_rows(st.x, flat.xyz, flat.rel_time, dir_s)
            return (torch.cat([J_c, J_s], dim=-2), torch.cat([-res_c, -res_s], dim=-1),
                    torch.cat([w_ok_c & corr.ok_c, w_ok_s & corr.ok_s], dim=-1))

    def step(st, corr, it, compute_projector=False):
        JtJ, Jtb, n_valid = gn.assemble_normal_eqs(*residual_rows(st, corr, it))
        return gn.gn_step(
            st, JtJ, Jtb, n_valid, it, cfg.eig_threshold, cfg.delta_r_abort,
            cfg.delta_t_abort, cfg.min_matched, reference_mode=parity_mode,
            trust_region_t=0.0 if parity_mode else cfg.trust_region_t,
            trust_region_r=0.0 if parity_mode else cfg.trust_region_r,
            min_converge_iter=0 if parity_mode else cfg.min_converge_iter,
            compute_projector=compute_projector,
        )

    x_base = None
    if rigid:
        # constant-velocity de-warp: remove the predicted in-sweep motion x0
        # from the query clouds, then solve the residual motion rigidly
        # (rel_time = 1 for every point); see OdometryConfig.cv_dewarp
        sharp = dataclasses.replace(
            sharp, xyz=twist.warp_to_start(x0, sharp.xyz, sharp.rel_time),
            rel_time=torch.ones_like(sharp.rel_time))
        flat = dataclasses.replace(
            flat, xyz=twist.warp_to_start(x0, flat.xyz, flat.rel_time),
            rel_time=torch.ones_like(flat.rel_time))
        x_base = x0
        x0 = torch.zeros_like(x0)

    st = gn.gn_init(x0)
    # the walk lists, once: no mask changes across the refreshes
    lists = tuple(races.valid_list(c.mask) for c in (sharp, flat, last_corner, last_surf))
    n_blocks = -(-cfg.max_iterations // cfg.refresh_every)
    for block in range(n_blocks):
        corr = _find_correspondences(st.x, sharp, flat, last_corner, last_surf,
                                     cfg, rigid, lists)
        start = block * cfg.refresh_every
        stop = min(start + cfg.refresh_every, cfg.max_iterations)
        if block == 0:
            st = step(st, corr, 0, compute_projector=True)
            start = 1
        for it in range(start, stop):
            st = step(st, corr, it)
    if x_base is not None:
        # compose the de-warp prior back in: M = TZYX(delta) @ TZYX(x_prev)
        x_total = twist.from_relative_motion(twist.to_mat(st.x) @ twist.to_mat(x_base))
        st = dataclasses.replace(st, x=x_total)
    return st.x, st


def batch_odometry_solve(sharp: Cloud, flat: Cloud, last_corner: Cloud,
                         last_surf: Cloud, x0, cfg: OdometryConfig = OdometryConfig(),
                         parity_mode: bool = False):
    """Solve the in-sweep motion twist of B problems at once.

    sharp/flat: query clouds with xyz [B, N, 3]; last_corner/last_surf:
    reference clouds, shared (xyz [M, 3]) or per problem (xyz [B, M, 3]);
    x0: [B, 6] initial guesses.  Runs on the tensors' device.
    Returns (x [B, 6], GNState of the last pass).

    With ``cfg.dewarp_passes > 1`` (cv_dewarp only, not in parity mode),
    pass k re-de-warps the ORIGINAL clouds with pass k-1's twist and solves
    again: the constant-velocity prior is exact only at constant motion
    (OdometryConfig.dewarp_passes).

    Span ``odometry.solve``, a call's root; counters ``query_points`` (valid
    sharp and flat points), ``lanes`` (B), ``steps`` (GN steps a lane may
    take) and ``lane_steps`` (the steps the lanes took: sum of ``iter_used``).
    """
    check_knobs(cfg.kernel_backend, cfg.nn_precision, cfg.nn_query_chunk)
    passes = max(cfg.dewarp_passes, 1) if cfg.cv_dewarp and not parity_mode else 1
    with profiling.span("odometry.solve", call=True):
        profiling.count("query_points", sharp.mask)
        profiling.count("query_points", flat.mask)
        profiling.count("lanes", x0.shape[0])
        x = x0
        for _ in range(passes):
            x, st = _odometry_solve_pass(sharp, flat, last_corner, last_surf, x, cfg,
                                         parity_mode)
            profiling.count("steps", cfg.max_iterations)
            profiling.count("lane_steps", st.iter_used)
    return x, st


def odometry_solve(sharp: Cloud, flat: Cloud, last_corner: Cloud,
                   last_surf: Cloud, x0, cfg: OdometryConfig = OdometryConfig(),
                   parity_mode: bool = False):
    """One problem: clouds without a batch dimension, x0 [6].
    Returns (x [6], GNState of batch 1)."""
    add = lambda c: Cloud(c.xyz[None], c.mask[None], c.ring[None], c.rel_time[None])
    x, st = batch_odometry_solve(add(sharp), add(flat), last_corner, last_surf,
                                 x0[None], cfg, parity_mode)
    return x[0], st
