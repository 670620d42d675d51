"""Synthetic LiDAR world and sweep simulator (port of ``cooper_mapper_tpu/io/sim.py``).

A ray-cast planar world (a room with box pillars) swept by a moving
multi-ring scanner with in-sweep motion distortion; the test and benchmark
workload generator.  Frame convention: y is up, the scanner spins about +y.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.features import Sweep
from ..utils import se3


@dataclasses.dataclass
class PlaneWorld:
    """Rectangles: origin [M,3], edge vectors u,v [M,3] (extent 0..1 each)."""

    origin: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor

    @property
    def normals(self):
        n = torch.linalg.cross(self.u, self.v)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def _rect(o, u, v):
    return np.asarray(o, np.float32), np.asarray(u, np.float32), np.asarray(v, np.float32)


def make_room_world(size=(30.0, 4.0, 40.0), n_pillars: int = 6,
                    pillar_half: float = 0.4, seed: int = 0,
                    device="cuda") -> PlaneWorld:
    """A rectangular room (floor, ceiling, 4 walls) with box pillars inside.

    numpy-seeded exactly like the JAX package, so a seed names one world in
    both packages.
    """
    sx, sy, sz = size
    rects = [
        _rect([-sx / 2, 0, -sz / 2], [sx, 0, 0], [0, 0, sz]),
        _rect([-sx / 2, sy, -sz / 2], [sx, 0, 0], [0, 0, sz]),
        _rect([-sx / 2, 0, -sz / 2], [sx, 0, 0], [0, sy, 0]),
        _rect([-sx / 2, 0, sz / 2], [sx, 0, 0], [0, sy, 0]),
        _rect([-sx / 2, 0, -sz / 2], [0, 0, sz], [0, sy, 0]),
        _rect([sx / 2, 0, -sz / 2], [0, 0, sz], [0, sy, 0]),
    ]
    rng = np.random.default_rng(seed)
    for _ in range(n_pillars):
        cx = rng.uniform(-sx / 2 + 3, sx / 2 - 3)
        cz = rng.uniform(-sz / 2 + 3, sz / 2 - 3)
        h = pillar_half
        rects.append(_rect([cx - h, 0, cz - h], [2 * h, 0, 0], [0, sy, 0]))
        rects.append(_rect([cx - h, 0, cz + h], [2 * h, 0, 0], [0, sy, 0]))
        rects.append(_rect([cx - h, 0, cz - h], [0, 0, 2 * h], [0, sy, 0]))
        rects.append(_rect([cx + h, 0, cz - h], [0, 0, 2 * h], [0, sy, 0]))
    o, u, v = (torch.from_numpy(np.stack(x)).to(device) for x in zip(*rects))
    return PlaneWorld(o, u, v)


def ray_cast(world: PlaneWorld, origins, directions, max_range=150.0):
    """First-hit distances for rays.  origins/directions: [..., 3].

    Returns (t, hit): [...] distances (max_range where no hit) and hit mask.
    """
    n = world.normals
    o = origins[..., None, :]
    d = directions[..., None, :]
    denom = torch.sum(d * n, dim=-1)
    denom = torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, torch.inf), denom)
    t = torch.sum((world.origin - o) * n, dim=-1) / denom
    p = o + t[..., None] * d
    rel = p - world.origin
    uu = torch.sum(world.u * world.u, dim=-1)
    vv = torch.sum(world.v * world.v, dim=-1)
    a = torch.sum(rel * world.u, dim=-1) / uu
    b = torch.sum(rel * world.v, dim=-1) / vv
    ok = (t > 0.05) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    t = torch.where(ok, t, torch.full_like(t, torch.inf))
    tmin = torch.amin(t, dim=-1)
    hit = torch.isfinite(tmin) & (tmin <= max_range)
    return torch.where(hit, tmin, torch.full_like(tmin, max_range)), hit


def _linspace(start: float, stop: float, num: int, endpoint: bool, device):
    """f32 ``start*(1-s) + stop*s`` with ``s = i/div``: the JAX package's
    linspace arithmetic, so both simulators aim the same rays."""
    div = num - 1 if endpoint else num
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    out = start_t * (1 - step) + stop_t * step
    if endpoint:
        out = torch.cat([out, stop_t[None]])
    return out


def scan_sweep(world: PlaneWorld, pose_start, pose_end, n_rings: int = 16,
               width: int = 1024, vfov=(-15.0, 15.0), max_range: float = 150.0,
               distortion: bool = True, noise: float = 0.0,
               generator: torch.Generator | None = None) -> Sweep:
    """Simulate one organized sweep on the device of ``world``.

    Each azimuth column is cast from the pose interpolated at its rel_time
    when ``distortion`` (the rolling-shutter effect LOAM's motion
    compensation undoes); points come back in the capture sensor frame.
    ``noise`` > 0 adds isotropic Gaussian noise of that standard deviation
    (metres) to every world point, drawn from ``generator`` (a
    ``torch.Generator`` on the world's device) where the JAX simulator draws
    from its ``key``: the two draws cannot be equal, only alike in
    distribution.  As in the JAX simulator, no generator means no noise.
    """
    dev = world.origin.device
    pose_start = pose_start.to(dev, torch.float32)
    pose_end = pose_end.to(dev, torch.float32)
    deg2rad = np.float32(np.pi / 180)
    elev = _linspace(vfov[0], vfov[1], n_rings, True, dev) * deg2rad
    azim = _linspace(0.0, 2 * np.pi, width, False, dev)
    rel_t = (azim / np.float32(2 * np.pi))[None, :].expand(n_rings, width)

    ce, se_ = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    dirs = torch.stack([ce * ca, se_.expand(n_rings, width), ce * sa], dim=-1)

    if distortion:
        xi = se3.se3_log(se3.inverse(pose_start) @ pose_end)
        frac = rel_t[0]
        T_col = pose_start @ se3.se3_exp(frac[:, None] * xi[None, :])
        R_col = T_col[:, :3, :3]
        t_col = T_col[:, :3, 3]
        dirs_w = torch.einsum("wij,rwj->rwi", R_col, dirs)
        orig_w = t_col[None, :, :].expand(dirs.shape)
    else:
        R0 = pose_start[:3, :3]
        dirs_w = dirs @ R0.T
        orig_w = pose_start[:3, 3].expand(dirs.shape)

    t, hit = ray_cast(world, orig_w, dirs_w, max_range)
    pts_world = orig_w + t[..., None] * dirs_w
    if noise > 0.0 and generator is not None:
        pts_world = pts_world + noise * torch.randn(pts_world.shape, generator=generator,
                                                    device=dev)

    if distortion:
        pts_sensor = torch.einsum("wji,rwj->rwi", R_col, pts_world - t_col[None, :, :])
    else:
        pts_sensor = (pts_world - pose_start[:3, 3]) @ pose_start[:3, :3]

    return Sweep(xyz=pts_sensor.contiguous(), mask=hit, rel_time=rel_t.contiguous())


def figure_eight_trajectory(n_poses: int, scale=8.0, height=1.5, period=60.0):
    """Ground-truth trajectory: a smooth figure-eight inside the room.
    Returns [n_poses, 4, 4] float32 sensor -> world poses (numpy, host side),
    as the JAX package's simulator does."""
    s = np.linspace(0, 2 * np.pi * 0.8, n_poses)
    x = scale * np.sin(s)
    z = scale * np.sin(s) * np.cos(s)
    y = np.full_like(x, height)
    yaw = np.arctan2(np.gradient(z), np.gradient(x))
    poses = np.zeros((n_poses, 4, 4), np.float32)
    for i in range(n_poses):
        c, si = np.cos(yaw[i]), np.sin(yaw[i])
        # rotation about y (up)
        poses[i] = np.array([[c, 0, si, x[i]], [0, 1, 0, y[i]], [-si, 0, c, z[i]], [0, 0, 0, 1]],
                            np.float32)
    return poses


def loop_drive(n_sweeps: int = 52, width: int = 1024, noise: float = 0.03, seed: int = 7,
               n_rings: int = 16, device="cuda"):
    """The loop-closure drive of the JAX package's ``examples/demo_graph_slam.py``
    and ``tests/test_graph_pipeline.py``: ``n_sweeps`` sweeps of ``n_rings``
    x ``width`` around a 5 m circle that closes after 48 sweeps, in
    ``make_room_world(size=(30, 4, 40), n_pillars=8, seed=3)``, with
    ``noise`` m of sensor noise from a ``torch.Generator`` seeded ``seed``.
    Returns (sweeps, start poses [n_sweeps, 4, 4] float32, numpy)."""
    world = make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=3, device=device)
    yaw = 2 * np.pi / 48
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.array([[c, 0, s, 0.0], [0, 1, 0, 0], [-s, 0, c, 5.0 * 2 * np.sin(yaw / 2)],
                     [0, 0, 0, 1]], np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    for _ in range(n_sweeps):
        poses.append(poses[-1] @ step)
    gen = torch.Generator(device=device).manual_seed(seed)
    sweeps = [scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                         n_rings, width, noise=noise, generator=gen) for i in range(n_sweeps)]
    return sweeps, np.stack(poses[:n_sweeps])


def drifted_ring_graph(n: int, seed: int = 0, loop_every: int = 100):
    """The JAX package's pose-graph benchmark problem
    (``benchmarks/bench_pose_graph.build_graph``) in numpy: a ring of ``n``
    poses 1 m apart, odometry edges with 0.02 m of noise per step (the
    estimates drift), and an exact loop edge every ``loop_every`` nodes.
    Returns (poses, edge_i, edge_j, edge_T, edge_info) for
    ``ops.pose_graph.from_arrays``."""
    rng = np.random.RandomState(seed)
    gt = [np.eye(4, dtype=np.float32)]
    step = np.eye(4, dtype=np.float32)
    step[0, 3] = 1.0
    th = 2 * np.pi / n
    rot = np.array([[np.cos(th), 0, np.sin(th), 0], [0, 1, 0, 0],
                    [-np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]], np.float32)
    for _ in range(1, n):
        gt.append(gt[-1] @ step @ rot)
    est = [gt[0]]
    ei, ej, eT, einfo = [], [], [], []
    for k in range(1, n):
        noise = np.eye(4, dtype=np.float32)
        noise[:3, 3] = 0.02 * rng.randn(3)
        rel_noisy = (np.linalg.inv(gt[k - 1]) @ gt[k] @ noise).astype(np.float32)
        est.append((est[-1] @ rel_noisy).astype(np.float32))
        ei.append(k - 1)
        ej.append(k)
        eT.append(rel_noisy)
        einfo.append(np.ones(6, np.float32))
    for k in range(loop_every, n, loop_every):
        ei.append(k - loop_every)
        ej.append(k)
        eT.append((np.linalg.inv(gt[k - loop_every]) @ gt[k]).astype(np.float32))
        einfo.append(2.0 * np.ones(6, np.float32))
    return np.stack(est), np.array(ei), np.array(ej), np.stack(eT), np.stack(einfo)
