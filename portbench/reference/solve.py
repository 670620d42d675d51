"""The plain reference of the two batch solves: LOAM's laserOdometry
scan-to-scan solve (LaserOdometry.cpp:328-647) and laserMapping's
scan-to-map solve (ScanMatch.cpp:51-347), in plain PyTorch with
brute-force searches (``search.py``).

It follows the method that the program's configuration runs (the native
solver mode: Cholesky with a relative Tikhonov floor, the spectral
degeneracy projector, trust regions, the constant-velocity de-warp) and
the program's order of f32 operations, so that a sound program agrees
with it to rounding; it shares no code with the program.  Float32, with
TF32 off in PyTorch's matmuls (the caller's setting).  ``tf32=True`` is
the benchmark's control: every matrix product (the distance tiles' cross
terms, the normal equations, the projector, the pose compositions) takes
its operands rounded to TF32, as tensor cores would, and sums in f32.
"""

from __future__ import annotations

import torch

from . import search

# ---------------------------------------------------------------------------
# Pose parameterisation: x = [rx, ry, rz, tx, ty, tz], p' = Rz Ry Rx p + t
# ---------------------------------------------------------------------------


def _stack_rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot(axis, a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        return _stack_rows([[o, z, z], [z, c, -s], [z, s, c]])
    if axis == 1:
        return _stack_rows([[c, z, s], [z, o, z], [-s, z, c]])
    return _stack_rows([[c, -s, z], [s, c, z], [z, z, o]])


def mm(a, b, tf32: bool = False):
    """a @ b, with TF32-rounded operands under ``tf32``."""
    if tf32:
        return search.tf32_round(a) @ search.tf32_round(b)
    return a @ b


def to_mat(x, tf32: bool = False):
    R = mm(mm(_rot(2, x[..., 2]), _rot(1, x[..., 1]), tf32), _rot(0, x[..., 0]), tf32)
    top = torch.cat([R, x[..., 3:6, None]], dim=-1)
    bottom = torch.zeros(x.shape[:-1] + (1, 4), dtype=x.dtype, device=x.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_mat(T):
    R = T[..., :3, :3]
    rx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ry = torch.asin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    rz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.cat([torch.stack([rx, ry, rz], -1), T[..., :3, 3]], dim=-1)


def _apply(rx, ry, rz, tx, ty, tz, p):
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    ox = cz * cy * px + (cz * sy * sx - sz * cx) * py + (cz * sy * cx + sz * sx) * pz + tx
    oy = sz * cy * px + (sz * sy * sx + cz * cx) * py + (sz * sy * cx - cz * sx) * pz + ty
    oz = -sy * px + cy * sx * py + cy * cx * pz + tz
    return torch.stack([ox, oy, oz], dim=-1)


def warp(x, p, s=None):
    """TZYX(s * x) p; x [B, 6], p [B, N, 3], s [B, N] or None (s = 1)."""
    if s is None:
        return _apply(*(x[..., None, i] for i in range(6)), p)
    return _apply(*(s * x[..., None, i] for i in range(6)), p)


def jacobian_rows(x, p, c):
    """d(c . (Rz Ry Rx p + t))/dx, [B, N, 6]: the closed-form trig rows of
    LaserOdometry.cpp:557-575 without the port's missing parenthesis."""
    sc = [(torch.sin(x[..., i, None]), torch.cos(x[..., i, None])) for i in range(3)]
    (srx, crx), (sry, cry), (srz, crz) = sc
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    arx = (((crz * sry * crx + srz * srx) * py + (srz * crx - crz * sry * srx) * pz) * cx
           + ((srz * sry * crx - crz * srx) * py - (srz * sry * srx + crz * crx) * pz) * cy
           + (cry * crx * py - cry * srx * pz) * cz)
    ary = ((-crz * sry * px + crz * cry * srx * py + crz * cry * crx * pz) * cx
           + (-srz * sry * px + srz * cry * srx * py + srz * cry * crx * pz) * cy
           + (-cry * px - sry * srx * py - sry * crx * pz) * cz)
    arz = ((-srz * cry * px - (srz * sry * srx + crz * crx) * py
            + (crz * srx - srz * sry * crx) * pz) * cx
           + (crz * cry * px + (crz * sry * srx - srz * crx) * py
              + (crz * sry * crx + srz * srx) * pz) * cy)
    return torch.stack([arx, ary, arz, cx, cy, cz], dim=-1)


# ---------------------------------------------------------------------------
# Gauss-Newton step (LaserOdometry.cpp:505-644), native mode
# ---------------------------------------------------------------------------


def normal_eqs(J, b, ok, tf32: bool = False):
    Jm = torch.where(ok[..., None], J, torch.zeros((), dtype=J.dtype, device=J.device))
    bm = torch.where(ok, b, torch.zeros((), dtype=b.dtype, device=b.device))
    JtJ = mm(Jm.transpose(-1, -2), Jm, tf32)
    Jtb = mm(Jm.transpose(-1, -2), bm[..., None], tf32)[..., 0]
    return JtJ, Jtb, ok.to(J.dtype).sum(dim=-1)


def _eye6(like):
    return torch.eye(6, dtype=like.dtype, device=like.device)


def _cholesky_solve(A, b):
    """Unrolled 6x6 Cholesky solve, elementwise over the batch."""
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


def solve6(JtJ, Jtb):
    tr = torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return _cholesky_solve(JtJ + (1e-7 / 6.0 * tr + 1e-12) * _eye6(JtJ), Jtb)


def projector(JtJ, eig_threshold, tf32: bool = False):
    """P = V diag(lambda >= threshold) V^T and whether any was dropped."""
    flat = JtJ.reshape(-1, 6, 6)
    parts = [torch.linalg.eigh(c) for c in flat.split(1 << 14)]
    evals = torch.cat([p[0] for p in parts]).reshape(JtJ.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(JtJ.shape)
    keep = evals >= eig_threshold
    return (mm(V * keep.to(JtJ.dtype)[..., None, :], V.transpose(-1, -2), tf32),
            torch.any(~keep, -1))


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def _clamp_norm(v, limit):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v * torch.clamp(limit / torch.clamp(n, min=1e-12), max=1.0)


class GN:
    """The solve's carry: x, the projector, and the per-lane flags."""

    def __init__(self, x0, tf32: bool = False):
        dev, batch = x0.device, x0.shape[:-1]
        self.tf32 = tf32
        self.x = x0
        self.P = _eye6(x0).expand(batch + (6, 6))
        self.degenerate = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.converged = torch.zeros(batch, dtype=torch.bool, device=dev)

    def step(self, JtJ, Jtb, n_valid, it, cfg, first, trust_t=0.0, trust_r=0.0,
             min_converge_iter=0):
        if first:
            self.P, self.degenerate = projector(JtJ, cfg["eig_threshold"], self.tf32)
        P, eye, t = self.P, _eye6(JtJ), self.tf32
        dg = self.degenerate
        A = torch.where(dg[..., None, None], mm(mm(P, JtJ, t), P, t) + (eye - P), JtJ)
        rhs = torch.where(dg[..., None], mm(P, Jtb[..., None], t)[..., 0], Jtb)
        dx = solve6(A, rhs)
        if trust_t > 0.0:
            dx = torch.cat([dx[..., :3], _clamp_norm(dx[..., 3:], trust_t)], dim=-1)
        if trust_r > 0.0:
            dx = torch.cat([_clamp_norm(dx[..., :3], trust_r), dx[..., 3:]], dim=-1)
        dx = _finite(dx)
        active = (~self.converged) & (n_valid >= cfg["min_matched"])
        self.x = _finite(self.x + torch.where(active[..., None], dx, torch.zeros_like(dx)))
        dr = torch.rad2deg(torch.linalg.vector_norm(dx[..., :3], dim=-1))
        dt = 100.0 * torch.linalg.vector_norm(dx[..., 3:], dim=-1)
        self.converged = self.converged | (active & (dr < cfg["delta_r_abort"])
                                           & (dt < cfg["delta_t_abort"])
                                           & (it >= min_converge_iter))


# ---------------------------------------------------------------------------
# Residuals (feature_utils.h)
# ---------------------------------------------------------------------------


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def line_distance(A, B, X, eps=1e-12):
    cr = torch.linalg.cross(X - B, X - A)
    cr_norm = _norm(cr)
    ab = _norm(A - B)
    direction = -torch.linalg.cross(cr, B - A) / torch.clamp(cr_norm * ab, min=eps)[..., None]
    return cr_norm / torch.clamp(ab, min=eps), direction


def plane_distance(A, B, C, X, eps=1e-12):
    n = torch.linalg.cross(B - A, C - A)
    n = n / torch.clamp(_norm(n)[..., None], min=eps)
    signed = torch.sum((X - A) * n, dim=-1)
    return torch.abs(signed), torch.where(signed[..., None] < 0, -n, n)


def _take(values, idx):
    """values [B, M, ...] at int32 indices [B, Q] -> [B, Q, ...]."""
    idx = idx.long()
    if values.dim() == 2:
        return torch.gather(values, 1, idx)
    return torch.gather(values, 1, idx[..., None].expand(-1, -1, values.shape[-1]))


# ---------------------------------------------------------------------------
# The scan-to-scan solve
# ---------------------------------------------------------------------------


def odometry(sharp, flat, corner, surf, x0, cfg: dict, tf32: bool = False):
    """B problems: query clouds ``sharp``/``flat`` and reference clouds
    ``corner``/``surf`` (dicts of xyz, mask, ring, rel_time; per problem),
    x0 [B, 6].  Returns (x [B, 6], converged [B])."""
    # constant-velocity de-warp: remove the prior's in-sweep motion, solve rigidly
    qc = warp(x0, sharp["xyz"], sharp["rel_time"])
    qs = warp(x0, flat["xyz"], flat["rel_time"])
    gn = GN(torch.zeros_like(x0), tf32)
    slope, wmin, gate = cfg["corner_weight_slope"], cfg["weight_min"], cfg["nn_sq_dist_max"]
    n_iter, every = cfg["max_iterations"], cfg["refresh_every"]
    for block in range(-(-n_iter // every)):
        pc, ps = warp(gn.x, qc), warp(gn.x, qs)
        ia, da, ib, db = search.odometry_races(pc, corner["xyz"], corner["mask"],
                                               corner["ring"], cfg["ring_span"], False, tf32)
        ok_c = (da < gate) & (db < gate) & sharp["mask"]
        A_c, B_c = _take(corner["xyz"], ia), _take(corner["xyz"], ib)
        ja, ea, jc, ec, jb, eb = search.odometry_races(
            ps, surf["xyz"], surf["mask"], surf["ring"], cfg["ring_span"], True, tf32)
        ok_s = (ea < gate) & (eb < gate) & (ec < gate) & flat["mask"]
        A_s, B_s, C_s = _take(surf["xyz"], ja), _take(surf["xyz"], jb), _take(surf["xyz"], jc)
        for it in range(block * every, min((block + 1) * every, n_iter)):
            pc, ps = warp(gn.x, qc), warp(gn.x, qs)
            d, dir_c = line_distance(A_c, B_c, pc)
            w = 1.0 - slope * torch.abs(d) if it >= 5 else torch.ones_like(d)
            w_ok_c = (w > wmin) & (d != 0.0)
            dir_c, res_c = dir_c * w[..., None], d * w
            e, n = plane_distance(A_s, B_s, C_s, ps)
            xn = torch.sqrt(torch.clamp(_norm(ps), min=1e-12))
            w = 1.0 - slope * torch.abs(e) / xn if it >= 5 else torch.ones_like(e)
            w_ok_s = (w > wmin) & (e != 0.0)
            dir_s, res_s = n * w[..., None], e * w
            J = torch.cat([jacobian_rows(gn.x, qc, dir_c), jacobian_rows(gn.x, qs, dir_s)], -2)
            b = torch.cat([-res_c, -res_s], dim=-1)
            ok = torch.cat([w_ok_c & ok_c, w_ok_s & ok_s], dim=-1)
            JtJ, Jtb, n_valid = normal_eqs(J, b, ok, tf32)
            gn.step(JtJ, Jtb, n_valid, it, cfg, it == 0, cfg["trust_region_t"],
                    cfg["trust_region_r"], cfg["min_converge_iter"])
    # compose the de-warp prior back in: TZYX(delta) @ TZYX(x0)
    return from_mat(mm(to_mat(gn.x, tf32), to_mat(x0, tf32), tf32)), gn.converged


# ---------------------------------------------------------------------------
# The scan-to-map solve
# ---------------------------------------------------------------------------


def _eig3(cxx, cxy, cxz, cyy, cyz, czz):
    """Eigenvalues (ascending) of symmetric 3x3 matrices (Smith, 1961)."""
    q = (cxx + cyy + czz) / 3.0
    dxx, dyy, dzz = cxx - q, cyy - q, czz - q
    p2 = dxx * dxx + dyy * dyy + dzz * dzz + 2.0 * (cxy * cxy + cxz * cxz + cyz * cyz)
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    safe_p = torch.where(p > 0.0, p, torch.ones_like(p))
    bxx, byy, bzz = dxx / safe_p, dyy / safe_p, dzz / safe_p
    bxy, bxz, byz = cxy / safe_p, cxz / safe_p, cyz / safe_p
    detb = (bxx * (byy * bzz - byz * byz) - bxy * (bxy * bzz - byz * bxz)
            + bxz * (bxy * byz - byy * bxz))
    phi = torch.arccos(torch.clamp(detb / 2.0, -1.0, 1.0)) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    return l0, 3.0 * q - l2 - l0, l2


def _evec3(cxx, cxy, cxz, cyy, cyz, czz, lam):
    """Unit eigenvector of eigenvalue ``lam`` by the largest cross product."""
    m00, m11, m22 = cxx - lam, cyy - lam, czz - lam
    c01 = (cxy * cyz - cxz * m11, cxz * cxy - m00 * cyz, m00 * m11 - cxy * cxy)
    c02 = (cxy * m22 - cxz * cyz, cxz * cxz - m00 * m22, m00 * cyz - cxy * cxz)
    c12 = (m11 * m22 - cyz * cyz, cyz * cxz - cxy * m22, cxy * cyz - m11 * cxz)
    n01, n02, n12 = (c[0] ** 2 + c[1] ** 2 + c[2] ** 2 for c in (c01, c02, c12))
    use02 = n02 >= n01
    best = [torch.where(use02, a, b) for a, b in zip(c02, c01)]
    bn = torch.where(use02, n02, n01)
    use12 = n12 >= bn
    best = [torch.where(use12, a, b) for a, b in zip(c12, best)]
    bn = torch.where(use12, n12, bn)
    ok = bn > 0.0
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, bn, torch.ones_like(bn))),
                      torch.zeros_like(bn))
    return (torch.where(ok, best[0] * inv, torch.ones_like(bn)),
            torch.where(ok, best[1] * inv, torch.zeros_like(bn)),
            torch.where(ok, best[2] * inv, torch.zeros_like(bn)))


def _centred(px, py, pz):
    k = len(px)
    mx, my, mz = sum(px) / k, sum(py) / k, sum(pz) / k
    return (mx, my, mz), [c - mx for c in px], [c - my for c in py], [c - mz for c in pz]


def fit_line(px, py, pz, eig_ratio, h=0.1):
    """findLine (feature_utils.h:108-154): the centroid +- h along the
    principal direction; valid iff lambda_max > eig_ratio * lambda_mid."""
    k = len(px)
    (mx, my, mz), ax, ay, az = _centred(px, py, pz)
    cov = [sum(a * b for a, b in zip(u, v)) / k
           for u, v in ((ax, ax), (ax, ay), (ax, az), (ay, ay), (ay, az), (az, az))]
    _, lam1, lam2 = _eig3(*cov)
    vx, vy, vz = _evec3(*cov, lam2)
    A = torch.stack([mx - h * vx, my - h * vy, mz - h * vz], dim=-1)
    B = torch.stack([mx + h * vx, my + h * vy, mz + h * vz], dim=-1)
    return A, B, lam2 > eig_ratio * lam1


def fit_plane(px, py, pz, max_dist, planar_ratio=0.05, eps=1e-12):
    """findPlane (feature_utils.h:156-204): the n.p = -1 least-squares
    plane by the centred covariance's adjugate, rejected where a neighbour
    lies over ``max_dist`` from it or the neighbours are collinear."""
    (mx, my, mz), ax, ay, az = _centred(px, py, pz)
    cxx = sum(a * a for a in ax) + 1e-8
    cyy = sum(a * a for a in ay) + 1e-8
    czz = sum(a * a for a in az) + 1e-8
    cxy = sum(a * b for a, b in zip(ax, ay))
    cxz = sum(a * b for a, b in zip(ax, az))
    cyz = sum(a * b for a, b in zip(ay, az))
    adj00, adj01, adj02 = cyy * czz - cyz * cyz, cxz * cyz - cxy * czz, cxy * cyz - cyy * cxz
    adj11, adj12, adj22 = cxx * czz - cxz * cxz, cxy * cxz - cxx * cyz, cxx * cyy - cxy * cxy
    nx = -(adj00 * mx + adj01 * my + adj02 * mz)
    ny = -(adj01 * mx + adj11 * my + adj12 * mz)
    nz = -(adj02 * mx + adj12 * my + adj22 * mz)
    norm = torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=eps)
    nx, ny, nz = nx / norm, ny / norm, nz / norm
    d = -(nx * mx + ny * my + nz * mz)
    valid = torch.ones_like(d, dtype=torch.bool)
    for x, y, z in zip(px, py, pz):
        valid = valid & (torch.abs(x * nx + y * ny + z * nz + d) <= max_dist)
    _, lam1, lam2 = _eig3(cxx, cxy, cxz, cyy, cyz, czz)
    return torch.stack([nx, ny, nz, d], dim=-1), valid & (lam1 > planar_ratio * lam2)


def _neighbour_planes(ref_xyz, idx):
    B, N, K = idx.shape
    nb = _take(ref_xyz, idx.reshape(B, N * K)).reshape(B, N, K, 3)
    return tuple([nb[..., j, ax] for j in range(K)] for ax in range(3))


def _map_residuals(x, corner, surf, ref_corner, ref_surf, cfg, tf32):
    pc, ps = warp(x, corner["xyz"]), warp(x, surf["xyz"])
    idx_c, d_c = search.knn(pc, ref_corner["xyz"], ref_corner["mask"], cfg["knn"], tf32)
    idx_s, d_s = search.knn(ps, ref_surf["xyz"], ref_surf["mask"], cfg["knn"], tf32)
    gate_c = (d_c[..., -1] < cfg["nn_sq_dist_max"]) & corner["mask"]
    gate_s = (d_s[..., -1] < cfg["nn_sq_dist_max"]) & surf["mask"]
    A, B, line_ok = fit_line(*_neighbour_planes(ref_corner["xyz"], idx_c), cfg["line_eig_ratio"])
    line_ok = line_ok & gate_c
    d, dir_c = line_distance(A, B, pc)
    w = 1.0 - cfg["weight_slope"] * torch.abs(d)
    ok_c = line_ok & (w > cfg["weight_min"]) & gate_c
    dir_c, res_c = dir_c * w[..., None], d * w
    plane, plane_ok = fit_plane(*_neighbour_planes(ref_surf["xyz"], idx_s), cfg["plane_max_dist"])
    plane_ok = plane_ok & gate_s
    signed = torch.sum(plane[..., :3] * ps, dim=-1) + plane[..., 3]
    xn = torch.sqrt(torch.clamp(_norm(ps), min=1e-12))
    w = 1.0 - cfg["weight_slope"] * torch.abs(signed) / xn
    ok_s = plane_ok & (w > cfg["weight_min"]) & gate_s
    dir_s, res_s = plane[..., :3] * w[..., None], signed * w
    J = torch.cat([jacobian_rows(x, corner["xyz"], dir_c),
                   jacobian_rows(x, surf["xyz"], dir_s)], dim=-2)
    b = torch.cat([-res_c, -res_s], dim=-1)
    return J, b, torch.cat([ok_c, ok_s], -1), torch.cat([line_ok & gate_c, plane_ok & gate_s], -1)


def scan_match(corner, surf, ref_corner, ref_surf, x0, cfg: dict, tf32: bool = False):
    """B problems: frame clouds ``corner``/``surf`` and their maps
    ``ref_corner``/``ref_surf`` (per problem), x0 [B, 6] world poses.
    Returns (x [B, 6], converged [B], success [B])."""
    enough = (ref_corner["mask"].sum(-1) >= 50) & (ref_surf["mask"].sum(-1) >= 100)
    gn = GN(x0, tf32)
    for it in range(cfg["max_iterations"]):
        J, b, ok, _ = _map_residuals(gn.x, corner, surf, ref_corner, ref_surf, cfg, tf32)
        JtJ, Jtb, n_valid = normal_eqs(J, b, ok, tf32)
        gn.step(JtJ, Jtb, torch.where(enough, n_valid, 0.0), it, cfg, it == 0)
    _, b, ok, found = _map_residuals(gn.x, corner, surf, ref_corner, ref_surf, cfg, tf32)
    score = torch.sum(torch.where(ok, torch.exp(-torch.abs(b)), 0.0), dim=-1)
    total = corner["mask"].sum(-1) + surf["mask"].sum(-1)
    fraction = found.sum(-1).float() / torch.clamp(total, min=1).float()
    gated = (score >= cfg["score_threshold"]) & (fraction >= cfg["match_percentage_threshold"])
    return gn.x, gn.converged, gn.converged & gated & enough
