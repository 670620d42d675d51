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
               distortion: bool = True) -> Sweep:
    """Simulate one organized sweep on the device of ``world``.

    Each azimuth column is cast from the pose interpolated at its rel_time
    when ``distortion`` (the rolling-shutter effect LOAM's motion
    compensation undoes); points come back in the capture sensor frame.
    The JAX simulator's optional noise is not ported (the headline path uses
    none).
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
