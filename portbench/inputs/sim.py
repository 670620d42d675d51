"""The benchmark's own LiDAR simulator: a frozen, batched copy of the port's
``io/sim.py`` (``make_room_world``, ``ray_cast``, ``scan_sweep``) and of the
few SE(3) helpers it needs.  It imports nothing of the program, so the
inputs that the program and the plain reference are handed are the
benchmark's, not the program's.

Frame convention: y is up, the scanner spins about +y.  Every function
works on a batch of worlds and poses at once, on the device of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# SE(3) helpers (frozen copies of the port's utils/se3.py)
# ---------------------------------------------------------------------------


def _stack_rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack_rows([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack_rows([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack_rows([[c, -s, z], [s, c, z], [z, z, o]])


def make_mat(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def euler6_to_mat(x):
    """[..., 6] (rx, ry, rz, tx, ty, tz) -> [..., 4, 4], R = Rz Ry Rx."""
    R = rot_z(x[..., 2]) @ rot_y(x[..., 1]) @ rot_x(x[..., 0])
    return make_mat(R, x[..., 3:6])


def mat_to_euler6(T):
    """[..., 4, 4] -> [..., 6], the TZYX twist of a pose."""
    R = T[..., :3, :3]
    rx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ry = torch.asin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    rz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.cat([torch.stack([rx, ry, rz], -1), T[..., :3, 3]], dim=-1)


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_mat(Rt, -(Rt @ t[..., None])[..., 0])


def apply(T, p):
    """(..., 4, 4) applied to points (..., N, 3)."""
    return p @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _stack_rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    W = skew(w)
    small = theta < 1e-2
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = 0.5 * (R - R.transpose(-1, -2))
    vee = torch.stack([w_skew[..., 2, 1], w_skew[..., 0, 2], w_skew[..., 1, 0]], -1)
    small = cos_theta > 0.9999
    safe_cos = torch.where(small, torch.full_like(cos_theta, 0.5), cos_theta)
    theta = torch.arccos(safe_cos)
    sin_theta = torch.sqrt(torch.clamp(1.0 - safe_cos * safe_cos, min=1e-12))
    s2 = torch.sum(vee * vee, dim=-1)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / sin_theta)
    return vee * scale[..., None]


def se3_exp(xi):
    """(..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    W = skew(w)
    small = theta < 1e-2
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-30))
    V = _eye3(R) + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return make_mat(R, (V @ v[..., None])[..., 0])


def se3_log(T):
    """(..., 4, 4) -> (..., 6) [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    W = skew(w)
    small = theta < 1e-2
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=1e-30))
    Vinv = _eye3(R) - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], dim=-1)


def yaw_pose(x, y, z, yaw):
    """[n] arrays -> [n, 4, 4] poses at (x, y, z) turned by ``yaw`` about +y."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.zeros((len(x), 4, 4), np.float32)
    T[:, 0, 0], T[:, 0, 2], T[:, 2, 0], T[:, 2, 2] = c, s, -s, c
    T[:, 1, 1] = T[:, 3, 3] = 1.0
    T[:, 0, 3], T[:, 1, 3], T[:, 2, 3] = x, y, z
    return T


# ---------------------------------------------------------------------------
# Worlds and sweeps
# ---------------------------------------------------------------------------


def room_worlds(rng: np.random.Generator, n: int, size, n_pillars: int,
                pillar_half: float, device):
    """``n`` rooms (floor, ceiling, four walls) of ``size`` (x, y, z metres),
    each with ``n_pillars`` box pillars at places drawn from ``rng``, as the
    port's ``make_room_world`` places them.  Returns rectangles (origin, u,
    v), each [n, 6 + 4 * n_pillars, 3] f32 on ``device``."""
    sx, sy, sz = size
    walls = [
        ([-sx / 2, 0, -sz / 2], [sx, 0, 0], [0, 0, sz]),
        ([-sx / 2, sy, -sz / 2], [sx, 0, 0], [0, 0, sz]),
        ([-sx / 2, 0, -sz / 2], [sx, 0, 0], [0, sy, 0]),
        ([-sx / 2, 0, sz / 2], [sx, 0, 0], [0, sy, 0]),
        ([-sx / 2, 0, -sz / 2], [0, 0, sz], [0, sy, 0]),
        ([sx / 2, 0, -sz / 2], [0, 0, sz], [0, sy, 0]),
    ]
    cx = rng.uniform(-sx / 2 + 3, sx / 2 - 3, size=(n, n_pillars))
    cz = rng.uniform(-sz / 2 + 3, sz / 2 - 3, size=(n, n_pillars))
    h = pillar_half
    o = np.zeros((n, 6 + 4 * n_pillars, 3), np.float32)
    u = np.zeros_like(o)
    v = np.zeros_like(o)
    for k, (wo, wu, wv) in enumerate(walls):
        o[:, k], u[:, k], v[:, k] = wo, wu, wv
    for p in range(n_pillars):
        k = 6 + 4 * p
        x0, z0 = cx[:, p] - h, cz[:, p] - h
        o[:, k, 0], o[:, k, 2] = x0, z0
        u[:, k] = [2 * h, 0, 0]
        o[:, k + 1, 0], o[:, k + 1, 2] = x0, cz[:, p] + h
        u[:, k + 1] = [2 * h, 0, 0]
        o[:, k + 2, 0], o[:, k + 2, 2] = x0, z0
        u[:, k + 2] = [0, 0, 2 * h]
        o[:, k + 3, 0], o[:, k + 3, 2] = cx[:, p] + h, z0
        u[:, k + 3] = [0, 0, 2 * h]
        for j in range(4):
            v[:, k + j] = [0, sy, 0]
    return tuple(torch.from_numpy(a).to(device) for a in (o, u, v))


def ray_cast(world, origins, directions, max_range=150.0):
    """First-hit distances of rays in a batch of worlds: world rectangles
    [n, K, 3], origins/directions [n, ..., 3] -> (t, hit) [n, ...]."""
    origin, u, v = world
    nrm = torch.linalg.cross(u, v)
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    lead = origins.shape[1:-1]
    view = lambda a: a.reshape((a.shape[0],) + (1,) * len(lead) + a.shape[1:])
    nrm, origin, u, v = view(nrm), view(origin), view(u), view(v)
    o = origins[..., None, :]
    d = directions[..., None, :]
    denom = torch.sum(d * nrm, dim=-1)
    denom = torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, torch.inf), denom)
    t = torch.sum((origin - o) * nrm, dim=-1) / denom
    p = o + t[..., None] * d
    rel = p - origin
    a = torch.sum(rel * u, dim=-1) / torch.sum(u * u, dim=-1)
    b = torch.sum(rel * v, dim=-1) / torch.sum(v * v, dim=-1)
    ok = (t > 0.05) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    t = torch.where(ok, t, torch.full_like(t, torch.inf))
    tmin = torch.amin(t, dim=-1)
    hit = torch.isfinite(tmin) & (tmin <= max_range)
    return torch.where(hit, tmin, torch.full_like(tmin, max_range)), hit


def _linspace(start: float, stop: float, num: int, endpoint: bool, device):
    div = num - 1 if endpoint else num
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    out = start_t * (1 - step) + stop_t * step
    if endpoint:
        out = torch.cat([out, stop_t[None]])
    return out


def scan_sweeps(world, pose_start, pose_end, n_rings: int, width: int, vfov=(-15.0, 15.0),
                max_range: float = 150.0, distortion: bool = True, noise: float = 0.0,
                generator: torch.Generator | None = None):
    """Simulate ``n`` organized sweeps at once, sweep i in world i.

    pose_start / pose_end: [n, 4, 4] on the world's device.  Each azimuth
    column is cast from the pose interpolated at its in-sweep time when
    ``distortion``; points come back in the capture sensor frame, with
    Gaussian noise of ``noise`` metres from ``generator``.  Returns (xyz
    [n, R, W, 3], mask [n, R, W], rel_time [n, R, W])."""
    dev = world[0].device
    n = pose_start.shape[0]
    deg2rad = np.float32(np.pi / 180)
    elev = _linspace(vfov[0], vfov[1], n_rings, True, dev) * deg2rad
    azim = _linspace(0.0, 2 * np.pi, width, False, dev)
    rel_t = (azim / np.float32(2 * np.pi))[None, :].expand(n_rings, width)
    ce, se_ = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    dirs = torch.stack([ce * ca, se_.expand(n_rings, width), ce * sa], dim=-1)  # [R, W, 3]

    if distortion:
        xi = se3_log(inverse(pose_start) @ pose_end)                          # [n, 6]
        frac = rel_t[0]
        T_col = pose_start[:, None] @ se3_exp(frac[None, :, None] * xi[:, None, :])
        R_col, t_col = T_col[..., :3, :3], T_col[..., :3, 3]                   # [n, W, ...]
    else:
        R_col = pose_start[:, None, :3, :3].expand(n, width, 3, 3)
        t_col = pose_start[:, None, :3, 3].expand(n, width, 3)
    dirs_w = torch.einsum("nwij,rwj->nrwi", R_col, dirs)
    orig_w = t_col[:, None].expand(dirs_w.shape)
    t, hit = ray_cast(world, orig_w, dirs_w, max_range)
    pts_world = orig_w + t[..., None] * dirs_w
    if noise > 0.0:
        pts_world = pts_world + noise * torch.randn(pts_world.shape, generator=generator,
                                                    device=dev)
    pts_sensor = torch.einsum("nwji,nrwj->nrwi", R_col, pts_world - t_col[:, None])
    return (pts_sensor.contiguous(), hit,
            rel_t[None].expand(n, n_rings, width).contiguous())
