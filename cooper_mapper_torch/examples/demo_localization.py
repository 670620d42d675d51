"""Relocalization demo: build a map, then localize a fresh run against it
(port of ``examples/demo_localization.py``).

The functional equivalent of lidar_localization.launch: a map built by the
mapping pipeline is reloaded as a fixed localization map; a second drive
through the world relocalizes against it (no map updates), seeded by an
initial pose (the initialpose/GNSS initLoc flow).

Run:  python -m cooper_mapper_torch.examples.demo_localization [map_dir]
          [--device cuda|cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from ..config import (
    MapConfig, MatcherConfig, PipelineConfig, RegistrationConfig, ScanMatchConfig,
)
from ..io import map_io, sim
from ..models.pipeline import SlamPipeline

DEFAULT_MAP = os.path.join(tempfile.gettempdir(), "cooper_demo_loc_map")


def _cfg():
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=16, max_points_per_ring=1024),
        scan_match=ScanMatchConfig(score_threshold=50.0),
        feature_map=MapConfig(
            n_cubes=(7, 3, 7), cube_size=20.0,
            corner_cube_capacity=2048, surf_cube_capacity=4096,
            surround_corner_capacity=8192, surround_surf_capacity=16384,
            valid_distance=60.0,
        ),
        matcher=MatcherConfig(max_frame_corner=2048, max_frame_surf=4096),
        mapping_stride=1,
    )


def drive(n, start, step_fn):
    poses = [start]
    for _ in range(n):
        poses.append(poses[-1] @ step_fn())
    return poses


def main(map_dir: str = DEFAULT_MAP, device="cuda"):
    cfg = _cfg()
    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=23, device=device)

    # ---- mapping run ------------------------------------------------------
    start = np.eye(4, dtype=np.float32)
    start[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.4
    poses = drive(12, start, lambda: step)
    mapper = SlamPipeline(cfg, mode="mapping", device=device)
    for i in range(12):
        mapper.process(sim.scan_sweep(world, torch.from_numpy(poses[i]),
                                      torch.from_numpy(poses[i + 1]),
                                      n_rings=16, width=1024))
    n_cubes = map_io.save_feature_map(mapper.map_state, cfg.feature_map, map_dir)
    print(f"mapping done: {n_cubes} cubes saved to {map_dir}")

    # ---- localization run (offset start, map frozen) ----------------------
    loc_map = map_io.load_feature_map(map_dir, cfg.feature_map, device=device)
    start2 = start.copy()
    start2[0, 3] += 0.8           # start offset from the mapping trajectory
    poses2 = drive(8, start2, lambda: step)
    loc = SlamPipeline(cfg, mode="localization", map_state=loc_map,
                       initial_pose=start2 @ np.linalg.inv(start), device=device)
    errs = []
    for i in range(8):
        r = loc.process(sim.scan_sweep(world, torch.from_numpy(poses2[i]),
                                       torch.from_numpy(poses2[i + 1]),
                                       n_rings=16, width=1024))
        gt_rel = np.linalg.inv(poses[0]) @ poses2[i]
        err = np.linalg.norm(r.merged_pose[:3, 3] - gt_rel[:3, 3])
        errs.append(err)
        print(f"sweep {i}: localization error {err:.3f} m"
              + ("" if r.mapping_success is None else f"  gate={r.mapping_success}"))
    print(f"\nmean localization error: {np.mean(errs[1:]):.3f} m")
    return loc, errs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("map_dir", nargs="?", default=DEFAULT_MAP)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.map_dir, a.device)
