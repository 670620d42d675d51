"""Full-stack graph SLAM demo: registration -> odometry -> mapping -> pose
graph -> corrected trajectory (port of ``examples/demo_graph_slam.py``).

Drives a noisy closed-loop trajectory through the REAL pipeline with the
pose-graph backend enabled (PipelineConfig.enable_graph), the equivalent of
launching the Graph node next to lidar_mapping
(L_SLAM/launch/node/lidar_mapping.launch + src/pose_graph/graph.cpp:301-378):
mapping outputs are gated into keyframes, loop closures are detected when
the trajectory revisits itself, the global LM runs, and T_odom2graph
corrects the reported trajectory.

Prints ATE for the merged (graph-off view) vs graph-corrected trajectories
and saves the /saveGraph artifacts (.g2o pre/post, trajectory PCDs).

Run:  python -m cooper_mapper_torch.examples.demo_graph_slam [out_dir]
          [--device cuda|cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..config import (
    LoopConfig, MapConfig, MatcherConfig, PipelineConfig, PoseGraphConfig,
    RegistrationConfig, ScanMatchConfig,
)
from ..io import evaluation, sim
from ..models.pipeline import SlamPipeline

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "cooper_graph_demo")


def make_cfg():
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=ScanMatchConfig(score_threshold=50.0),
        feature_map=MapConfig(
            n_cubes=(7, 3, 7), cube_size=20.0,
            corner_cube_capacity=1024, surf_cube_capacity=2048,
            surround_corner_capacity=8192, surround_surf_capacity=16384,
            valid_distance=60.0,
        ),
        matcher=MatcherConfig(max_frame_corner=2048, max_frame_surf=4096),
        loop=LoopConfig(
            distance_thresh=3.0,
            estimated_distance_thresh=9.0,   # squared plan-view gate
            accum_distance_thresh=12.0,
            min_loop_interval=2.0,
        ),
        pose_graph=PoseGraphConfig(max_nodes=128, max_edges=256),
        mapping_stride=2,
        enable_graph=True,
    )


def simulate_loop(n_sweeps=52, radius=5.0, noise=0.03, width=512, seed=7, device="cuda"):
    """A noisy circular trajectory that closes on itself.  The noise comes
    from a ``torch.Generator`` seeded with ``seed``, where the JAX demo
    draws from ``jax.random``: the two draws cannot be equal, only alike in
    distribution (with ``noise=0`` the sweeps are the same)."""
    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=3, device=device)
    yaw = 2 * np.pi / 48.0
    step_fwd = radius * 2 * np.sin(yaw / 2)
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.array(
        [[c, 0, s, 0.0], [0, 1, 0, 0], [-s, 0, c, step_fwd], [0, 0, 0, 1]],
        np.float32,
    )
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    for _ in range(n_sweeps):
        poses.append(poses[-1] @ step)
    gen = torch.Generator(device=device).manual_seed(seed)
    sweeps = []
    for i in range(n_sweeps):
        sweeps.append(
            sim.scan_sweep(
                world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                n_rings=16, width=width, noise=noise, generator=gen,
            )
        )
    return sweeps, np.stack(poses[:n_sweeps]), world


def main(out_dir: str = DEFAULT_OUT, device="cuda"):
    cfg = make_cfg()
    sweeps, gt, _ = simulate_loop(device=device)
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])

    pipe = SlamPipeline(cfg, mode="mapping", device=device)
    t0 = time.time()
    results = [pipe.process(s) for s in sweeps]
    wall = time.time() - t0

    merged = np.stack([r.merged_pose for r in results])
    corrected = pipe.corrected_trajectory()
    n_loops = len(pipe.graph.loops)
    n_kf = len(pipe.graph.keyframes)

    # end-of-sweep convention + gauge alignment (evaluation.pipeline_ate)
    ate_merged = evaluation.pipeline_ate(merged, gt)
    ate_graph = evaluation.pipeline_ate(corrected, gt)
    gt_end_last = gt_rel[min(len(merged), len(gt_rel) - 1)]
    end_merged = np.linalg.norm(merged[-1][:3, 3] - gt_end_last[:3, 3])
    end_graph = np.linalg.norm(corrected[-1][:3, 3] - gt_end_last[:3, 3])

    # keyframe-level comparison: the graph redistributes the loop-closure
    # error across nodes, so the optimized keyframe estimates must beat the
    # raw keyframe (mapping) poses against ground truth.  This is the
    # trajectory /saveGraph dumps (graph.cpp:137-142).
    scan_period = cfg.registration.scan_period
    kf_sweeps = [
        int(round(kf.stamp / scan_period)) for kf in pipe.graph.keyframes
    ]
    # keyframe poses are end-of-sweep mapping poses -> gt index i+1
    kf_idx = np.minimum(np.asarray(kf_sweeps) + 1, len(gt_rel) - 1)
    kf_gt = gt_rel[kf_idx][:, :3, 3]
    kf_odom = np.stack([kf.odom for kf in pipe.graph.keyframes])[:, :3, 3]
    kf_graph = pipe.graph.estimates()[:, :3, 3]
    ate_kf_odom = evaluation.ate(kf_odom, kf_gt, align=True)
    ate_kf_graph = evaluation.ate(kf_graph, kf_gt, align=True)

    print(f"sweeps: {len(sweeps)}  wall: {wall:.1f}s  keyframes: {n_kf}  loops: {n_loops}")
    print(f"ATE rmse  merged (graph off view): {ate_merged.rmse:.4f} m")
    print(f"ATE rmse  graph-corrected:         {ate_graph.rmse:.4f} m")
    print(f"keyframe ATE rmse  mapping poses:  {ate_kf_odom.rmse:.4f} m")
    print(f"keyframe ATE rmse  graph optimized:{ate_kf_graph.rmse:.4f} m")
    print(f"end-pose error  merged: {end_merged:.4f} m   graph: {end_graph:.4f} m")
    print(pipe.timer.report())

    pipe.graph.save(out_dir)
    print(f"saved .g2o pre/post + trajectory PCDs to {out_dir}")
    return pipe, dict(merged=ate_merged.rmse, graph=ate_graph.rmse,
                      kf_mapping=ate_kf_odom.rmse, kf_graph=ate_kf_graph.rmse)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out_dir, a.device)
