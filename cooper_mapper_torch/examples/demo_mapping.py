"""End-to-end mapping demo: simulate a drive, run full SLAM, save artifacts
(port of ``examples/demo_mapping.py``).

The functional equivalent of launching lidar_mapping.launch over a rosbag
(reference launch/node/lidar_mapping.launch): registration -> odometry ->
mapping -> map + trajectory saved to disk, with ATE against the simulator's
ground truth standing in for the GPS Evaluation node.

Run:  python -m cooper_mapper_torch.examples.demo_mapping [n_sweeps] [out_dir]
          [--device cuda|cpu]

``COOPER_TORCH_TRACE=<dir>`` records a ``torch.profiler`` trace of the drive
(``utils/profiling.trace``, a Chrome trace).
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from ..config import (
    MapConfig, MatcherConfig, PipelineConfig, RegistrationConfig, ScanMatchConfig,
)
from ..io import evaluation, map_io, sim
from ..models.pipeline import SlamPipeline

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "cooper_demo_map")


def main(n_sweeps: int = 20, out_dir: str = DEFAULT_OUT, device="cuda"):
    cfg = PipelineConfig(
        registration=RegistrationConfig(n_rings=16, max_points_per_ring=1024),
        scan_match=ScanMatchConfig(score_threshold=50.0),
        feature_map=MapConfig(
            n_cubes=(7, 3, 7), cube_size=20.0,
            corner_cube_capacity=2048, surf_cube_capacity=4096,
            surround_corner_capacity=8192, surround_surf_capacity=16384,
            valid_distance=60.0,
        ),
        matcher=MatcherConfig(max_frame_corner=2048, max_frame_surf=4096),
        mapping_stride=2,
    )
    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=11, device=device)

    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    for i in range(n_sweeps):
        yaw = 0.03
        c, s = np.cos(yaw), np.sin(yaw)
        step = np.array(
            [[c, 0, s, 0.05], [0, 1, 0, 0], [-s, 0, c, 0.4], [0, 0, 0, 1]], np.float32
        )
        poses.append(poses[-1] @ step)

    pipe = SlamPipeline(cfg, mode="mapping", device=device)

    def drive():
        for i in range(n_sweeps):
            sweep = sim.scan_sweep(
                world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                n_rings=16, width=1024,
            )
            r = pipe.process(sweep)
            tag = "" if r.mapping_success is None else f"  map_ok={r.mapping_success}"
            print(f"sweep {i:3d}: pos={np.round(r.merged_pose[:3, 3], 3)}{tag}")

    trace_dir = os.environ.get("COOPER_TORCH_TRACE", "")
    if trace_dir:
        from ..utils.profiling import trace
        with trace(trace_dir):
            drive()
    else:
        drive()

    est = np.stack(pipe.trajectory)
    # end-of-sweep pose convention + map-frame gauge alignment (the
    # evaluation convention, io/evaluation.pipeline_ate)
    stats = evaluation.pipeline_ate(est, np.stack(poses))
    print(f"\nATE rmse: {stats.rmse:.3f} m  mean: {stats.mean:.3f} m  max: {stats.maximum:.3f} m")
    # per-stage wall-clock attribution (the reference's destructor counters,
    # SURVEY.md §5)
    print("\nStage timing:")
    print(pipe.timer.report())

    os.makedirs(out_dir, exist_ok=True)
    n = map_io.save_feature_map(pipe.map_state, cfg.feature_map, out_dir)
    map_io.save_trajectory_pcd(os.path.join(out_dir, "trajectory.pcd"), est)
    print(f"saved {n} map cubes + trajectory to {out_dir}")
    return pipe, stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_sweeps", nargs="?", type=int, default=20)
    ap.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.n_sweeps, a.out_dir, a.device)
