"""Feature extraction (port of ``cooper_mapper_tpu/ops/features.py``).

``ScanRegistration::extractFeatures`` (ScanRegistration.cpp:190-666) as
masked tensor ops over an organized sweep grid ``[n_rings, W]``.  The JAX
package maps its per-ring pickers over rings with ``vmap``; here the ring is
an explicit batch dimension of every op.  Semantics, including the order of
each f32 reduction, follow the JAX package line for line.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RegistrationConfig
from ..utils import cloud as cloud_lib
from ..utils.cloud import Cloud
from . import eig3
from .voxel import voxel_downsample

# point status labels (ScanRegistration.h:23-40)
EDGE_BROKEN = -2
NEAR_BLOCK = -3
BLIND_BLOCK = -4
STATUS_NONE = 0

# classification labels
MESSY = 0
CLS_SURFACE_FLAT = 1
CLS_CORNER_SHARP = 2
CLS_ONESIDE_FLAT = 3


@dataclasses.dataclass
class Sweep:
    """Organized sweep grid: xyz [R, W, 3], mask [R, W] (front-packed per
    ring), rel_time [R, W] in-sweep time fraction."""

    xyz: torch.Tensor
    mask: torch.Tensor
    rel_time: torch.Tensor


@dataclasses.dataclass
class FeatureClouds:
    sharp: Cloud
    less_sharp: Cloud
    flat: Cloud
    less_flat: Cloud


@dataclasses.dataclass
class FeatureDebug:
    """Per-point extraction internals, the /point_blind, /point_block,
    /point_slop and /point_curvature debug clouds (ScanRegistration.cpp:81-86,
    679-682) as grids.  Every field is [R, W], aligned with the Sweep."""

    curvature: torch.Tensor     # squared-norm curvature (setRegionBuffersFor)
    status: torch.Tensor        # int32: BLIND_BLOCK / NEAR_BLOCK / EDGE_BROKEN / STATUS_NONE
    label: torch.Tensor         # int32 classification (pointClassify)
    region_id: torch.Tensor     # azimuthal region id, -1 outside the feature span
    sharp_picked: torch.Tensor  # bool: the point entered the sharp cloud
    flat_picked: torch.Tensor   # bool: the point entered the flat cloud


def _shift(x, k, fill):
    """Shift along the last axis by k (value from index i+k), ``fill`` outside."""
    if k == 0:
        return x
    pad = torch.full_like(x[..., :abs(k)], fill)
    if k > 0:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., :k]], dim=-1)


def _shift_pts(p, k):
    """Shift [..., W, 3] along W; out-of-range -> zeros."""
    if k == 0:
        return p
    pad = torch.zeros_like(p[..., :abs(k), :])
    if k > 0:
        return torch.cat([p[..., k:, :], pad], dim=-2)
    return torch.cat([pad, p[..., :k, :]], dim=-2)


def _sum3(a):
    """Sum over a trailing axis of 3, left to right."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def _norm3(a):
    return torch.sqrt(_sum3(a * a))


def curvature(xyz, cr: int):
    """[..., W, 3] -> [..., W] squared-norm curvature (setRegionBuffersFor)."""
    acc = -2.0 * cr * xyz
    for j in range(1, cr + 1):
        acc = acc + _shift_pts(xyz, j) + _shift_pts(xyz, -j)
    return _sum3(acc * acc)


def scan_status(xyz, mask, cfg: RegistrationConfig):
    """Occlusion / blind-area statuses per point, [..., W] int32
    (setScanBuffersFor, ScanRegistration.cpp:462-522)."""
    cr = cfg.curvature_region
    nxt = _shift_pts(xyz, 1)
    prv = _shift_pts(xyz, -1)
    mask_nxt = _shift(mask, 1, False)

    pair_valid = mask & mask_nxt
    den = _norm3(xyz) * _norm3(nxt)
    cosang = _sum3(xyz * nxt) / torch.clamp(den, min=1e-12)
    blind_trig = pair_valid & (cosang < cfg.blind_threshold)

    blind = torch.zeros_like(mask)
    for j in range(-cr + 1, cr + 1):
        blind = blind | _shift(blind_trig, -j, False)

    diff_next = _sum3((nxt - xyz) ** 2)
    diff_prev = _sum3((prv - xyz) ** 2)
    depth_i = _norm3(xyz)
    depth_n = _norm3(nxt)

    jump = pair_valid & (diff_next > 1.0) & ~blind_trig
    occ_here = jump & (depth_i <= depth_n)
    occ_next = jump & (depth_i > depth_n)

    near = torch.zeros_like(mask)
    for j in range(1, cr + 1):
        near = near | _shift(occ_here, -j, False)
    for j in range(0, cr):
        near = near | _shift(occ_next, j, False)

    smooth_prev = diff_prev / torch.clamp(diff_next, min=1e-12) < 0.2
    edge_pt = occ_here & smooth_prev
    edge_pt = edge_pt | _shift(occ_next & smooth_prev, -1, False)
    edge = edge_pt & ~near & ~blind

    status = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    status = torch.where(edge, EDGE_BROKEN, status)
    status = torch.where(near, NEAR_BLOCK, status)
    status = torch.where(blind, BLIND_BLOCK, status)
    return status


def classify(xyz, mask, cfg: RegistrationConfig):
    """Two-sided PCA line classification (pointClassify, :547-666), [..., W]
    int32 in {MESSY, CLS_SURFACE_FLAT, CLS_CORNER_SHARP, CLS_ONESIDE_FLAT}."""
    cr = cfg.curvature_region
    k = cr + 1
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    def side(offsets):
        xs = [_shift(x, o, 0.0) for o in offsets]
        ys = [_shift(y, o, 0.0) for o in offsets]
        zs = [_shift(z, o, 0.0) for o in offsets]
        mx = sum(xs) / k
        my = sum(ys) / k
        mz = sum(zs) / k
        ax = [c - mx for c in xs]
        ay = [c - my for c in ys]
        az = [c - mz for c in zs]
        cxx = sum(a * a for a in ax) / k
        cyy = sum(a * a for a in ay) / k
        czz = sum(a * a for a in az) / k
        cxy = sum(a * b for a, b in zip(ax, ay)) / k
        cxz = sum(a * b for a, b in zip(ax, az)) / k
        cyz = sum(a * b for a, b in zip(ay, az)) / k
        lam0, lam1, lam2 = eig3.eigvalsh3(cxx, cxy, cxz, cyy, cyz, czz)
        vx, vy, vz = eig3.principal_evec3(cxx, cxy, cxz, cyy, cyz, czz, lam2)
        is_line = (lam2 > cfg.classify_eig_ratio12 * lam1) & (
            lam2 > cfg.classify_eig_ratio13 * lam0
        )
        tol2 = cfg.classify_line_tol * cfg.classify_line_tol
        for axj, ayj, azj in zip(ax, ay, az):
            d2 = (
                (ayj * vz - azj * vy) ** 2
                + (azj * vx - axj * vz) ** 2
                + (axj * vy - ayj * vx) ** 2
            )
            is_line = is_line & (d2 <= tol2)
        return is_line, (vx, vy, vz)

    line1, v1 = side([-j for j in range(0, cr + 1)])
    line2, v2 = side([+j for j in range(0, cr + 1)])

    diff = v1[0] * v2[0] + v1[1] * v2[1] + v1[2] * v2[2]
    flat_cond = (diff < float(np.cos(np.deg2rad(175.0)))) | (diff > float(np.cos(np.deg2rad(5.0))))
    corner_cond = (diff > float(np.cos(np.deg2rad(135.0)))) & (diff < float(np.cos(np.deg2rad(45.0))))

    label = torch.full(mask.shape, MESSY, dtype=torch.int32, device=mask.device)
    label = torch.where(line1 | line2, CLS_ONESIDE_FLAT, label)
    both = line1 & line2
    label = torch.where(both & corner_cond, CLS_CORNER_SHARP, label)
    label = torch.where(both & flat_cond, CLS_SURFACE_FLAT, label)
    return label


def _region_ids(mask, cfg: RegistrationConfig):
    """Azimuthal region id per point, -1 outside the feature span; the
    reference's exact integer region bounds (:248-257)."""
    cr = cfg.curvature_region
    nreg = cfg.n_feature_regions
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    count = torch.sum(mask.to(torch.int32), dim=-1, keepdim=True)
    end = count - 1
    j = torch.arange(nreg + 1, dtype=torch.int32, device=mask.device)
    sp = torch.div(cr * (nreg - j) + (end - cr) * j, nreg, rounding_mode="floor")
    rid = torch.sum(rank[..., None] >= sp[..., None, :-1], dim=-1) - 1
    rid = torch.clamp(rid, 0, nreg - 1)
    region_ok = (sp[..., 1:] - 1) > sp[..., :-1]
    ok = torch.gather(region_ok.expand(rank.shape[:-1] + (nreg,)), -1, rid)
    in_span = mask & ok & (rank >= cr) & (rank <= end - cr - 1) & (end > 2 * cr)
    return torch.where(in_span, rid, torch.full_like(rid, -1))


def _pick_topk_per_region(score, eligible, region_id, nreg, k,
                          suppress_radius=None, mode="max"):
    """Greedy per-region top-k with optional +/-suppress_radius suppression.

    score, eligible, region_id: [R, W] (rings as the batch dimension).
    Returns the picked mask [R, W].
    """
    inf = torch.tensor(torch.inf, dtype=score.dtype, device=score.device)
    sign = 1.0 if mode == "min" else -1.0
    base = torch.where(eligible, sign * score, inf)
    regions = torch.arange(nreg, device=score.device)
    onehot = region_id[:, None, :] == regions[None, :, None]          # [R, nreg, W]

    picked = torch.zeros_like(eligible)
    suppressed = torch.zeros_like(eligible)
    for _ in range(k):
        free = ~(picked | suppressed)
        cand = torch.where(onehot & free[:, None, :], base[:, None, :], inf)
        i = torch.argmin(cand, dim=-1)                                  # [R, nreg]
        ok = torch.gather(cand, -1, i[..., None])[..., 0] < inf
        # scatter-max: a failed region's default index 0 must not clear a hit
        hit = torch.zeros(picked.shape, dtype=torch.int32, device=score.device)
        hit = hit.scatter_reduce(-1, i, ok.to(torch.int32), reduce="amax") > 0
        picked = picked | hit
        if suppress_radius:
            dil = hit
            for j in range(1, suppress_radius + 1):
                dil = dil | _shift(hit, j, False) | _shift(hit, -j, False)
            suppressed = suppressed | dil
    return picked


def _mask_cloud(xyz, rel_time, ring_ids, mask2d, capacity):
    """The selected grid points as a compact Cloud, in ring-major order."""
    m = mask2d.reshape(-1)
    flat_xyz = xyz.reshape(-1, 3)
    c = cloud_lib.make(
        torch.where(m[:, None], flat_xyz, torch.full_like(flat_xyz, cloud_lib.FAR)),
        m, ring_ids.reshape(-1), rel_time.reshape(-1),
    )
    return cloud_lib.compact(c, capacity)


def extract_features_debug(sweep: Sweep, cfg: RegistrationConfig):
    """``extract_features`` plus the per-point internals, the optional
    classification debug clouds of the reference (ScanRegistration.cpp:81-86).
    Returns (FeatureClouds, FeatureDebug); ``extract_features`` returns the
    clouds of this same computation."""
    xyz, mask, rel_time = sweep.xyz, sweep.mask, sweep.rel_time
    R, W = mask.shape
    cr = cfg.curvature_region
    nreg = cfg.n_feature_regions

    ring_ids = torch.arange(R, dtype=torch.int32, device=mask.device)[:, None].expand(R, W)

    curv = curvature(xyz, cr)
    status = scan_status(xyz, mask, cfg)
    region_id = _region_ids(mask, cfg)
    in_span = region_id >= 0

    low_curv = curv < cfg.surface_curvature_threshold
    high_curv = ~low_curv

    cls = classify(xyz, mask, cfg)

    # flat: per (ring, region) greedy lowest curvature with +/-cr suppression
    flat_picked = _pick_topk_per_region(
        curv, in_span & low_curv, region_id, nreg, cfg.max_surface_flat,
        suppress_radius=cr, mode="min",
    )
    # sharp: top-k per region among classified corners not near occlusions
    sharp_elig = in_span & high_curv & (cls == CLS_CORNER_SHARP) & (status > EDGE_BROKEN)
    sharp_picked = _pick_topk_per_region(
        curv, sharp_elig, region_id, nreg, cfg.max_corner_sharp, mode="max",
    )
    edge_broken = in_span & (status == EDGE_BROKEN)

    # oneside-flat: the surfPickedNum bound is shared with classify-
    # SURFACE_FLAT points (:318-353), so pick over the union and keep only
    # the oneside members
    oneside_elig = in_span & high_curv & (cls == CLS_ONESIDE_FLAT)
    oneside_union = oneside_elig | (in_span & high_curv & (cls == CLS_SURFACE_FLAT))
    oneside_picked = _pick_topk_per_region(
        curv, oneside_union, region_id, nreg, cfg.max_surface_flat, mode="max",
    ) & oneside_elig

    sharp_mask = sharp_picked | edge_broken
    less_sharp_mask = sharp_elig | edge_broken
    flat_mask = flat_picked | oneside_picked
    less_flat_mask = ((in_span & low_curv)
                      | (high_curv & in_span & (cls == CLS_SURFACE_FLAT))
                      | oneside_elig)

    sharp = _mask_cloud(xyz, rel_time, ring_ids, sharp_mask, cfg.max_sharp)
    less_sharp = _mask_cloud(xyz, rel_time, ring_ids, less_sharp_mask, cfg.max_less_sharp)
    flat = _mask_cloud(xyz, rel_time, ring_ids, flat_mask, cfg.max_flat)
    less_flat_raw = _mask_cloud(xyz, rel_time, ring_ids, less_flat_mask, cfg.max_less_flat)
    less_flat = voxel_downsample(less_flat_raw, cfg.less_flat_filter_size)
    dbg = FeatureDebug(curvature=curv, status=status, label=cls, region_id=region_id,
                       sharp_picked=sharp_mask, flat_picked=flat_mask)
    return FeatureClouds(sharp, less_sharp, flat, less_flat), dbg


def extract_features(sweep: Sweep, cfg: RegistrationConfig) -> FeatureClouds:
    """Full feature extraction for one sweep, on the sweep's device."""
    return extract_features_debug(sweep, cfg)[0]
