"""The benchmark's own feature extraction and voxel filter: a frozen, batched
copy of the port's ``ops/features.extract_features`` (ScanRegistration's
extractFeatures) and ``ops/voxel.voxel_downsample`` (pcl::VoxelGrid).

The port extracts one sweep at a time; here the sweeps are a leading batch
dimension, and the compaction and the voxel filter run over many clouds in
one pass (a group key in front of the sort keys keeps each cloud's points
together and in the order its own filter would give them).  Per sweep the
operations and their order are the port's, so a sweep's features are the
ones the port would extract from it (``portbench/tests`` holds them
together).  Clouds are dicts of tensors: ``xyz`` [n, C, 3] f32, ``mask``
[n, C] bool, ``ring`` [n, C] int32, ``rel_time`` [n, C] f32.
"""

from __future__ import annotations

import numpy as np
import torch

FAR = 1.0e6                      # the invalid points' sentinel (utils/cloud.FAR)
EDGE_BROKEN, NEAR_BLOCK, BLIND_BLOCK = -2, -3, -4
MESSY, CLS_SURFACE_FLAT, CLS_CORNER_SHARP, CLS_ONESIDE_FLAT = 0, 1, 2, 3
_TWO_PI_3 = 2.0943951023931953


def _shift(x, k, fill):
    if k == 0:
        return x
    pad = torch.full_like(x[..., :abs(k)], fill)
    if k > 0:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., :k]], dim=-1)


def _shift_pts(p, k):
    if k == 0:
        return p
    pad = torch.zeros_like(p[..., :abs(k), :])
    if k > 0:
        return torch.cat([p[..., k:, :], pad], dim=-2)
    return torch.cat([pad, p[..., :k, :]], dim=-2)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def _norm3(a):
    return torch.sqrt(_sum3(a * a))


def eigvalsh3(cxx, cxy, cxz, cyy, cyz, czz):
    """Eigenvalues (ascending) of symmetric 3x3 matrices on component planes."""
    q = (cxx + cyy + czz) / 3.0
    dxx, dyy, dzz = cxx - q, cyy - q, czz - q
    p2 = dxx * dxx + dyy * dyy + dzz * dzz + 2.0 * (cxy * cxy + cxz * cxz + cyz * cyz)
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    safe_p = torch.where(p > 0.0, p, torch.ones_like(p))
    bxx, byy, bzz = dxx / safe_p, dyy / safe_p, dzz / safe_p
    bxy, bxz, byz = cxy / safe_p, cxz / safe_p, cyz / safe_p
    detb = (bxx * (byy * bzz - byz * byz) - bxy * (bxy * bzz - byz * bxz)
            + bxz * (bxy * byz - byy * bxz))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    l1 = 3.0 * q - l2 - l0
    return l0, l1, l2


def principal_evec3(cxx, cxy, cxz, cyy, cyz, czz, lam):
    """Unit eigenvector for eigenvalue ``lam`` (+x where isotropic)."""
    m00, m11, m22 = cxx - lam, cyy - lam, czz - lam
    c01 = (cxy * cyz - cxz * m11, cxz * cxy - m00 * cyz, m00 * m11 - cxy * cxy)
    c02 = (cxy * m22 - cxz * cyz, cxz * cxz - m00 * m22, m00 * cyz - cxy * cxz)
    c12 = (m11 * m22 - cyz * cyz, cyz * cxz - cxy * m22, cxy * cyz - m11 * cxz)
    n01 = c01[0] ** 2 + c01[1] ** 2 + c01[2] ** 2
    n02 = c02[0] ** 2 + c02[1] ** 2 + c02[2] ** 2
    n12 = c12[0] ** 2 + c12[1] ** 2 + c12[2] ** 2
    use02 = n02 >= n01
    bx = torch.where(use02, c02[0], c01[0])
    by = torch.where(use02, c02[1], c01[1])
    bz = torch.where(use02, c02[2], c01[2])
    bn = torch.where(use02, n02, n01)
    use12 = n12 >= bn
    bx = torch.where(use12, c12[0], bx)
    by = torch.where(use12, c12[1], by)
    bz = torch.where(use12, c12[2], bz)
    bn = torch.where(use12, n12, bn)
    ok = bn > 0.0
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, bn, torch.ones_like(bn))),
                      torch.zeros_like(bn))
    return (torch.where(ok, bx * inv, torch.ones_like(bx)),
            torch.where(ok, by * inv, torch.zeros_like(by)),
            torch.where(ok, bz * inv, torch.zeros_like(bz)))


def curvature(xyz, cr: int):
    acc = -2.0 * cr * xyz
    for j in range(1, cr + 1):
        acc = acc + _shift_pts(xyz, j) + _shift_pts(xyz, -j)
    return _sum3(acc * acc)


def scan_status(xyz, mask, reg: dict):
    cr = reg["curvature_region"]
    nxt = _shift_pts(xyz, 1)
    prv = _shift_pts(xyz, -1)
    pair_valid = mask & _shift(mask, 1, False)
    den = _norm3(xyz) * _norm3(nxt)
    cosang = _sum3(xyz * nxt) / torch.clamp(den, min=1e-12)
    blind_trig = pair_valid & (cosang < reg["blind_threshold"])
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
    return torch.where(blind, BLIND_BLOCK, status)


def classify(xyz, mask, reg: dict):
    cr = reg["curvature_region"]
    k = cr + 1
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    def side(offsets):
        xs = [_shift(x, o, 0.0) for o in offsets]
        ys = [_shift(y, o, 0.0) for o in offsets]
        zs = [_shift(z, o, 0.0) for o in offsets]
        mx, my, mz = sum(xs) / k, sum(ys) / k, sum(zs) / k
        ax = [c - mx for c in xs]
        ay = [c - my for c in ys]
        az = [c - mz for c in zs]
        cxx = sum(a * a for a in ax) / k
        cyy = sum(a * a for a in ay) / k
        czz = sum(a * a for a in az) / k
        cxy = sum(a * b for a, b in zip(ax, ay)) / k
        cxz = sum(a * b for a, b in zip(ax, az)) / k
        cyz = sum(a * b for a, b in zip(ay, az)) / k
        lam0, lam1, lam2 = eigvalsh3(cxx, cxy, cxz, cyy, cyz, czz)
        vx, vy, vz = principal_evec3(cxx, cxy, cxz, cyy, cyz, czz, lam2)
        is_line = ((lam2 > reg["classify_eig_ratio12"] * lam1)
                   & (lam2 > reg["classify_eig_ratio13"] * lam0))
        tol2 = reg["classify_line_tol"] * reg["classify_line_tol"]
        for axj, ayj, azj in zip(ax, ay, az):
            d2 = ((ayj * vz - azj * vy) ** 2 + (azj * vx - axj * vz) ** 2
                  + (axj * vy - ayj * vx) ** 2)
            is_line = is_line & (d2 <= tol2)
        return is_line, (vx, vy, vz)

    line1, v1 = side([-j for j in range(0, cr + 1)])
    line2, v2 = side([+j for j in range(0, cr + 1)])
    diff = v1[0] * v2[0] + v1[1] * v2[1] + v1[2] * v2[2]
    flat_cond = ((diff < float(np.cos(np.deg2rad(175.0))))
                 | (diff > float(np.cos(np.deg2rad(5.0)))))
    corner_cond = ((diff > float(np.cos(np.deg2rad(135.0))))
                   & (diff < float(np.cos(np.deg2rad(45.0)))))
    label = torch.full(mask.shape, MESSY, dtype=torch.int32, device=mask.device)
    label = torch.where(line1 | line2, CLS_ONESIDE_FLAT, label)
    both = line1 & line2
    label = torch.where(both & corner_cond, CLS_CORNER_SHARP, label)
    return torch.where(both & flat_cond, CLS_SURFACE_FLAT, label)


def _region_ids(mask, reg: dict):
    cr = reg["curvature_region"]
    nreg = reg["n_feature_regions"]
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


def _pick_topk_per_region(score, eligible, region_id, nreg, k, suppress_radius=None,
                          mode="max"):
    """Greedy per-region top-k over rows [R, W] (sweeps x rings as rows)."""
    inf = torch.tensor(torch.inf, dtype=score.dtype, device=score.device)
    sign = 1.0 if mode == "min" else -1.0
    base = torch.where(eligible, sign * score, inf)
    regions = torch.arange(nreg, device=score.device)
    onehot = region_id[:, None, :] == regions[None, :, None]
    picked = torch.zeros_like(eligible)
    suppressed = torch.zeros_like(eligible)
    for _ in range(k):
        free = ~(picked | suppressed)
        cand = torch.where(onehot & free[:, None, :], base[:, None, :], inf)
        i = torch.argmin(cand, dim=-1)
        ok = torch.gather(cand, -1, i[..., None])[..., 0] < inf
        hit = torch.zeros(picked.shape, dtype=torch.int32, device=score.device)
        hit = hit.scatter_reduce(-1, i, ok.to(torch.int32), reduce="amax") > 0
        picked = picked | hit
        if suppress_radius:
            dil = hit
            for j in range(1, suppress_radius + 1):
                dil = dil | _shift(hit, j, False) | _shift(hit, -j, False)
            suppressed = suppressed | dil
    return picked


def compact(cloud: dict, capacity: int) -> dict:
    """Stable-sort each cloud's valid points to the front and keep
    ``capacity`` slots, padding with invalid FAR points where the clouds
    hold fewer (a map of few sweeps still has its configured capacity)."""
    order = torch.argsort((~cloud["mask"]).to(torch.int8), dim=-1, stable=True)[:, :capacity]
    pad = capacity - order.shape[1]
    out = {}
    for key, val in cloud.items():
        idx = order[..., None].expand(-1, -1, 3) if key == "xyz" else order
        out[key] = torch.gather(val, 1, idx)
        if pad > 0:
            fill = torch.full((val.shape[0], pad) + val.shape[2:], FAR if key == "xyz" else 0,
                              dtype=val.dtype, device=val.device)
            out[key] = torch.cat([out[key], fill], dim=1)
    return out


def _mask_cloud(xyz, rel_time, ring_ids, mask, capacity):
    """The selected grid points of each sweep as a cloud, ring-major order."""
    n = xyz.shape[0]
    m = mask.reshape(n, -1)
    flat = xyz.reshape(n, -1, 3)
    cloud = {"xyz": torch.where(m[..., None], flat, torch.full_like(flat, FAR)), "mask": m,
             "ring": ring_ids.reshape(n, -1), "rel_time": rel_time.reshape(n, -1)}
    return compact(cloud, capacity)


def _lexsort(keys):
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def voxel_downsample(cloud: dict, leaf: float, capacity: int | None = None) -> dict:
    """pcl::VoxelGrid of each of the n clouds: one point per occupied voxel at
    the centroid of its valid points, carrying the ring and time of the
    voxel's first point in sort order; compacted to ``capacity`` (default:
    the input's)."""
    xyz, mask = cloud["xyz"], cloud["mask"]
    n, cap_in = mask.shape
    group = torch.arange(n, device=mask.device).repeat_interleave(cap_in)
    xyz, mask = xyz.reshape(-1, 3), mask.reshape(-1)
    ijk = torch.floor(xyz / torch.tensor(leaf, dtype=xyz.dtype, device=xyz.device)
                      ).to(torch.int32)
    ijk = torch.where(mask[:, None], ijk, torch.full_like(ijk, 2**20))
    lead = group.to(torch.int32) * 2 + (~mask).to(torch.int32)
    order = _lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0], lead))
    ijk_s, xyz_s, mask_s, g_s = ijk[order], xyz[order], mask[order], group[order]
    total = xyz.shape[0]
    new_seg = torch.ones(total, dtype=torch.bool, device=xyz.device)
    new_seg[1:] = torch.any(ijk_s[1:] != ijk_s[:-1], dim=-1) | (g_s[1:] != g_s[:-1])
    out_mask = new_seg & mask_s
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    w = mask_s.to(torch.float32)
    lengths = torch.bincount(seg_id, minlength=total)
    sums = torch.segment_reduce(xyz_s * w[:, None], "sum", lengths=lengths)
    cnts = torch.segment_reduce(w, "sum", lengths=lengths)
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    out_xyz = torch.where(out_mask[:, None], centroids[seg_id], torch.full_like(xyz_s, FAR))
    # each cloud's points stay one contiguous run of cap_in entries
    out = {"xyz": out_xyz.reshape(n, cap_in, 3), "mask": out_mask.reshape(n, cap_in),
           "ring": cloud["ring"].reshape(-1)[order].reshape(n, cap_in),
           "rel_time": cloud["rel_time"].reshape(-1)[order].reshape(n, cap_in)}
    return compact(out, capacity or cap_in)


def extract_features(xyz, mask, rel_time, reg: dict) -> dict:
    """Feature clouds of n organized sweeps: xyz [n, R, W, 3], mask and
    rel_time [n, R, W].  ``reg`` holds RegistrationConfig's fields.
    Returns {"sharp", "less_sharp", "flat", "less_flat"} clouds."""
    n, R, W = mask.shape
    cr = reg["curvature_region"]
    nreg = reg["n_feature_regions"]
    ring_ids = torch.arange(R, dtype=torch.int32, device=mask.device)[None, :, None]
    ring_ids = ring_ids.expand(n, R, W)
    curv = curvature(xyz, cr)
    status = scan_status(xyz, mask, reg)
    region_id = _region_ids(mask, reg)
    in_span = region_id >= 0
    low_curv = curv < reg["surface_curvature_threshold"]
    high_curv = ~low_curv
    cls = classify(xyz, mask, reg)
    rows = lambda t: t.reshape(n * R, W)
    flat_picked = _pick_topk_per_region(
        rows(curv), rows(in_span & low_curv), rows(region_id), nreg,
        reg["max_surface_flat"], suppress_radius=cr, mode="min").reshape(n, R, W)
    sharp_elig = in_span & high_curv & (cls == CLS_CORNER_SHARP) & (status > EDGE_BROKEN)
    sharp_picked = _pick_topk_per_region(
        rows(curv), rows(sharp_elig), rows(region_id), nreg, reg["max_corner_sharp"],
        mode="max").reshape(n, R, W)
    edge_broken = in_span & (status == EDGE_BROKEN)
    oneside_elig = in_span & high_curv & (cls == CLS_ONESIDE_FLAT)
    oneside_union = oneside_elig | (in_span & high_curv & (cls == CLS_SURFACE_FLAT))
    oneside_picked = _pick_topk_per_region(
        rows(curv), rows(oneside_union), rows(region_id), nreg, reg["max_surface_flat"],
        mode="max").reshape(n, R, W) & oneside_elig
    sharp_mask = sharp_picked | edge_broken
    less_sharp_mask = sharp_elig | edge_broken
    flat_mask = flat_picked | oneside_picked
    less_flat_mask = ((in_span & low_curv)
                      | (high_curv & in_span & (cls == CLS_SURFACE_FLAT)) | oneside_elig)
    pick = lambda m, cap: _mask_cloud(xyz, rel_time, ring_ids, m, cap)
    return {
        "sharp": pick(sharp_mask, reg["max_sharp"]),
        "less_sharp": pick(less_sharp_mask, reg["max_less_sharp"]),
        "flat": pick(flat_mask, reg["max_flat"]),
        "less_flat": voxel_downsample(pick(less_flat_mask, reg["max_less_flat"]),
                                      reg["less_flat_filter_size"]),
    }
