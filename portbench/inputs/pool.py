"""The general generator of the cells' inputs: pools of distinct problems
made on the device from ``--seed``, and the per-call draws from them.

A traffic mix is data (``portbench/workloads/<cell>.json``, its
``"traffic"`` object); the deployment's sizes come from the configuration
file.  Two kinds of pool, named by the traffic's ``"pool"`` key:

* ``odometry_pairs``: sweep pairs of the scan-to-scan solve.  Each pair
  lives in a room of its own; the reference is the features of a sweep
  taken at rest at pose 1 (a perfectly de-warped last sweep), the query the
  features of a sweep taken while the sensor moves from pose 1 to pose 2
  with the motion drawn from the traffic's ``motion`` spreads.  The answer
  is that motion's TZYX twist.
* ``mapping_frames``: frames of the scan-to-map solve, each with a map of
  its own, made from ``map_sweeps`` sweeps at poses laid out ``around``
  the frame's pose (as the JAX package's ``bench_scan_match`` lays them
  out) or ``behind`` it along the path (the map at the start of a mapping
  session), voxel-filtered at the map leaves to the map capacities; the
  frame goes through ``prepare_frame``'s voxel filter.  The answer is the
  frame's world pose.

Every draw comes from numpy and torch generators seeded from ``--seed``
and a stream number, so the same seed gives the same pool and calls.
"""

from __future__ import annotations

import numpy as np
import torch

from . import features, sim

# sweeps simulated and extracted at once (a bound on the simulator's memory)
SIM_CHUNK = 64


def generators(seed: int, stream: int, device):
    """(numpy Generator, torch Generator on ``device``) for one stream of
    draws of the run seeded ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    return np.random.default_rng(ss), gen


def _free_positions(rng, n, room: dict, margin: float, pillars_xz):
    """``n`` sensor positions (x, z) inside the room, ``margin`` metres from
    the walls and a metre from every pillar's centre, by rejection."""
    sx, _, sz = room["size"]
    out = np.zeros((n, 2))
    todo = np.arange(n)
    while todo.size:
        x = rng.uniform(-sx / 2 + margin, sx / 2 - margin, todo.size)
        z = rng.uniform(-sz / 2 + margin, sz / 2 - margin, todo.size)
        d2 = ((x[:, None] - pillars_xz[todo, :, 0]) ** 2
              + (z[:, None] - pillars_xz[todo, :, 1]) ** 2)
        ok = d2.min(axis=1) > 1.0
        out[todo[ok], 0], out[todo[ok], 1] = x[ok], z[ok]
        todo = todo[~ok]
    return out


def _worlds(rng, n, room: dict, device):
    world = sim.room_worlds(rng, n, room["size"], room["n_pillars"], room["pillar_half"],
                            device)
    # pillar centres, from each pillar's first face (origin at centre - half)
    o = world[0][:, 6::4].cpu().numpy()
    centres = np.stack([o[..., 0], o[..., 2]], -1) + room["pillar_half"]
    return world, centres


def _start_poses(rng, n, room: dict, centres):
    xz = _free_positions(rng, n, room, room["margin"], centres)
    y = room["sensor_height"] + rng.normal(0.0, 0.05, n)
    yaw = rng.uniform(-np.pi, np.pi, n)
    return sim.yaw_pose(xz[:, 0], y, xz[:, 1], yaw)


def _sweeps(world, P0, P1, sensor: dict, reg: dict, traffic: dict, gen, distortion):
    """Feature clouds of len(P0) sweeps, sweep i in world i, in chunks."""
    parts = []
    for s in range(0, P0.shape[0], SIM_CHUNK):
        e = min(P0.shape[0], s + SIM_CHUNK)
        w = tuple(t[s:e] for t in world)
        xyz, mask, rel = sim.scan_sweeps(
            w, P0[s:e], P1[s:e], sensor["n_rings"], sensor["width"], tuple(sensor["vfov_deg"]),
            sensor["max_range"], distortion=distortion, noise=traffic["noise_m"],
            generator=gen)
        parts.append(features.extract_features(xyz, mask, rel, reg))
    return {k: {f: torch.cat([p[k][f] for p in parts]) for f in parts[0][k]}
            for k in parts[0]}


def _twists(rng, n, spread: dict):
    """[n, 6] TZYX twists: rotations N(0, rot_rad) about x and z, yaw
    N(0, yaw_rate * dt) about y; translation speed U(speed) * dt forward
    along x, N(0, lateral_m) along y and z."""
    dt = spread["dt_s"]
    x = np.zeros((n, 6))
    x[:, 0] = rng.normal(0.0, spread["rot_rad"], n)
    x[:, 1] = rng.normal(0.0, spread["yaw_rate_rad_s"] * dt, n)
    x[:, 2] = rng.normal(0.0, spread["rot_rad"], n)
    x[:, 3] = rng.uniform(*spread["speed_m_s"], n) * dt
    x[:, 4] = rng.normal(0.0, spread["lateral_m"], n)
    x[:, 5] = rng.normal(0.0, spread["lateral_m"], n)
    return x


def odometry_pairs(config: dict, traffic: dict, seed: int, device) -> dict:
    """The pool of sweep pairs: {"sharp", "flat", "less_sharp", "less_flat"}
    clouds [P, C, ...] and "truth" twists [P, 6]."""
    rng, gen = generators(seed, 0, device)
    n = traffic["pool_size"]
    world, centres = _worlds(rng, n, traffic["room"], device)
    P1 = _start_poses(rng, n, traffic["room"], centres)
    motion = torch.from_numpy(_twists(rng, n, traffic["motion"])).float().to(device)
    P1 = torch.from_numpy(P1).to(device)
    P2 = P1 @ sim.euler6_to_mat(motion)
    reg, sensor = config["registration"], config["sensor"]
    ref = _sweeps(world, P1, P1, sensor, reg, traffic, gen, False)
    cur = _sweeps(world, P1, P2, sensor, reg, traffic, gen, True)
    return {"sharp": cur["sharp"], "flat": cur["flat"], "less_sharp": ref["less_sharp"],
            "less_flat": ref["less_flat"],
            "truth": sim.mat_to_euler6(sim.inverse(P1) @ P2)}


def _to_world(cloud: dict, T) -> dict:
    xyz = sim.apply(T, cloud["xyz"])
    return dict(cloud, xyz=torch.where(cloud["mask"][..., None], xyz, features.FAR))


def _map_poses(rng, P0, layout: dict):
    """[n, k, 4, 4] poses of the k map sweeps of each frame pose P0 [n, 4, 4]."""
    n, k = P0.shape[0], layout["n"]
    if layout["layout"] == "around":
        off = np.stack([rng.uniform(-layout["xz_m"], layout["xz_m"], (n, k)),
                        rng.uniform(-layout["y_m"], layout["y_m"], (n, k)),
                        rng.uniform(-layout["xz_m"], layout["xz_m"], (n, k))], -1)
        yaw = rng.uniform(-layout["yaw_rad"], layout["yaw_rad"], (n, k))
        T = sim.yaw_pose(np.zeros(n * k), np.zeros(n * k), np.zeros(n * k), yaw.ravel())
        T = P0.repeat(k, 0).reshape(n, k, 4, 4) @ T.reshape(n, k, 4, 4)
        T[..., :3, 3] = P0[:, None, :3, 3] + off
        return T
    # "behind": the frames before this one along a path of fixed steps
    step = sim.yaw_pose(np.array([layout["step_m"]]), np.zeros(1), np.zeros(1),
                        np.array([layout["yaw_rad"]]))[0]
    back = np.linalg.inv(step).astype(np.float32)
    out, T = [], P0
    for _ in range(k):
        T = T @ back
        out.append(T)
    return np.stack(out, 1)


def mapping_frames(config: dict, traffic: dict, seed: int, device) -> dict:
    """The pool of map solves: frame clouds {"corner", "surf"} [P, C, ...]
    after prepare_frame, maps {"ref_corner", "ref_surf"} [P, M, ...] in the
    world frame, and "truth" world poses [P, 6]."""
    rng, gen = generators(seed, 0, device)
    n = traffic["pool_size"]
    layout = traffic["map_sweeps"]
    k = layout["n"]
    world, centres = _worlds(rng, n, traffic["room"], device)
    P0 = _start_poses(rng, n, traffic["room"], centres)
    Pm = _map_poses(rng, P0, layout).astype(np.float32)
    reg, sensor = config["registration"], config["sensor"]
    P0_t = torch.from_numpy(P0).to(device)
    frame = _sweeps(world, P0_t, P0_t, sensor, reg, traffic, gen, False)
    Pm_t = torch.from_numpy(Pm.reshape(n * k, 4, 4)).to(device)
    wk = tuple(t.repeat_interleave(k, 0) for t in world)
    ms = _sweeps(wk, Pm_t, Pm_t, sensor, reg, traffic, gen, False)
    stack = lambda c: {f: v.reshape(n, -1, *v.shape[2:]) for f, v in
                       _to_world(c, Pm_t).items()}
    ref_corner = features.voxel_downsample(stack(ms["less_sharp"]), config["corner_leaf"],
                                           config["surround_corner_capacity"])
    ref_surf = features.voxel_downsample(stack(ms["less_flat"]), config["surf_leaf"],
                                         config["surround_surf_capacity"])
    return {"corner": features.voxel_downsample(frame["less_sharp"], config["corner_leaf"],
                                                config["max_frame_corner"]),
            "surf": features.voxel_downsample(frame["less_flat"], config["surf_leaf"],
                                              config["max_frame_surf"]),
            "ref_corner": ref_corner, "ref_surf": ref_surf,
            "truth": sim.mat_to_euler6(P0_t)}


POOLS = {"odometry_pairs": odometry_pairs, "mapping_frames": mapping_frames}


def make_pool(config: dict, traffic: dict, seed: int, device) -> dict:
    return POOLS[traffic["pool"]](config, traffic, seed, device)


def draw_problems(pool: dict, n_batch: int, prior: dict, gen: torch.Generator):
    """One call's problems: pool entries drawn uniformly and priors drawn
    around each entry's answer, N(0, rot_rad) on the rotations and
    N(0, trans_m) on the translations.  Returns (idx [B] int64, x0 [B, 6])."""
    truth = pool["truth"]
    dev = truth.device
    idx = torch.randint(truth.shape[0], (n_batch,), generator=gen, device=dev)
    sd = torch.tensor([prior["rot_rad"]] * 3 + [prior["trans_m"]] * 3, device=dev)
    return idx, truth[idx] + sd * torch.randn((n_batch, 6), generator=gen, device=dev)


def gather(cloud: dict, idx) -> dict:
    """The pool entries ``idx`` of a cloud, as contiguous [B, C, ...] tensors."""
    return {f: v.index_select(0, idx) for f, v in cloud.items()}
