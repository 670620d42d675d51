"""Reactive wander / keyboard-teleop drives in the simulated world (port of
``examples/demo_wander.py``).

Functional equivalents of the reference's demo bring-up packages:
``control`` (control/src/wander.cpp:24-72 — roam forward, turn away when an
obstacle is near; teleop_key_node.cpp — raw-terminal WASD teleop) and the
sensor package (range_reporter.cpp — the ray-fan range read;
messege_to_tf.cpp — the pose published as a named frame tree, here
utils/frames.frame_tree).
Demonstrates closed-loop use: controller -> motion -> sweeps -> SLAM ->
frame tree.

Run:  python -m cooper_mapper_torch.examples.demo_wander [n_steps] [--device cuda|cpu]
      python -m cooper_mapper_torch.examples.demo_wander --teleop   (WASD + q, raw terminal)
"""

import argparse
import sys

import numpy as np
import torch

from ..config import (
    MapConfig, MatcherConfig, PipelineConfig, RegistrationConfig, ScanMatchConfig,
)
from ..io import evaluation, sim
from ..models.pipeline import SlamPipeline


def _f32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def wander_step(world, pose, speed=0.4, clearance=2.5):
    """One controller tick: move forward; turn away from near obstacles.

    The 'range_reporter' equivalent: cast a fan of horizontal rays and steer
    by the freest direction (wander.cpp's obstacle check).
    """
    headings = np.deg2rad(np.linspace(-60, 60, 9))
    R = pose[:3, :3]
    dirs = np.stack(
        [np.cos(headings), np.zeros_like(headings), np.sin(headings)], -1
    ) @ R.T
    origins = np.broadcast_to(pose[:3, 3], dirs.shape)
    dev = world.origin.device
    t = sim.ray_cast(world, _f32(origins, dev), _f32(dirs, dev))[0].cpu().numpy()
    front = t[len(t) // 2]
    if front < clearance:
        # turn toward the freest ray
        yaw = headings[int(np.argmax(t))]
    else:
        yaw = 0.05 * headings[int(np.argmax(t))]
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.array(
        [[c, 0, s, 0.0], [0, 1, 0, 0], [-s, 0, c, min(speed, max(front - 1.5, 0.1))],
         [0, 0, 0, 1]], np.float32,
    )
    return pose @ step


def teleop_step(pose, key, speed=0.4, turn=np.deg2rad(15)):
    """teleop_key_node.cpp's key map on the simulated base: w/s drive
    forward/back, a/d turn left/right."""
    yaw = {"a": turn, "d": -turn}.get(key, 0.0)
    fwd = {"w": speed, "s": -speed}.get(key, 0.0)
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.array(
        [[c, 0, s, 0.0], [0, 1, 0, 0], [-s, 0, c, fwd], [0, 0, 0, 1]],
        np.float32,
    )
    return pose @ step


def _read_keys():
    """Raw-terminal single-key reader (teleop_key_node.cpp's termios
    setup); yields keys until 'q'.  Falls back to line input when stdin is
    not a tty (piped smoke runs)."""
    import sys as _sys

    if not _sys.stdin.isatty():
        for line in _sys.stdin:
            for ch in line.strip():
                if ch == "q":
                    return
                yield ch
        return
    import termios
    import tty

    fd = _sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            ch = _sys.stdin.read(1)
            if ch == "q":
                return
            yield ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def teleop(cfg, world):
    """Keyboard-in-the-loop drive: each keypress moves the base one step;
    the pipeline tracks it and the frame tree is printed (the
    messege_to_tf output).  The pipeline runs on the world's device."""
    from ..utils import frames

    print("teleop: w/a/s/d to drive, q to quit")
    pose = np.eye(4, dtype=np.float32)
    pose[1, 3] = 1.5
    pipe = SlamPipeline(cfg, mode="mapping", device=world.origin.device)
    prev = pose
    for key in _read_keys():
        if key not in "wasd":
            continue
        nxt = teleop_step(prev, key)
        r = pipe.process(
            sim.scan_sweep(world, torch.from_numpy(prev), torch.from_numpy(nxt),
                           n_rings=16, width=768))
        tree = frames.frame_tree(r.merged_pose)
        fp = tree["base_footprint"][:3, 3]
        roll, pitch = frames.roll_pitch_of(r.merged_pose)
        print(f"key={key} base_footprint=[{fp[0]:+.2f} {fp[2]:+.2f}] "
              f"yaw={np.rad2deg(frames.yaw_of(r.merged_pose)):+.1f} deg "
              f"rp=({np.rad2deg(roll):+.1f},{np.rad2deg(pitch):+.1f}) "
              f"matched={r.odom_matched}")
        prev = nxt
    return pipe


def _cfg():
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=16, max_points_per_ring=768),
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


def main(n_steps: int = 15, device="cuda"):
    cfg = _cfg()
    world = sim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=4, device=device)
    pose = np.eye(4, dtype=np.float32)
    pose[1, 3] = 1.5
    poses = [pose]
    for _ in range(n_steps):
        poses.append(wander_step(world, poses[-1]))

    pipe = SlamPipeline(cfg, mode="mapping", device=device)
    for i in range(n_steps):
        r = pipe.process(
            sim.scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                           n_rings=16, width=768)
        )
        print(f"step {i:2d}: pos={np.round(r.merged_pose[:3, 3], 2)}")

    est = np.stack(pipe.trajectory)
    gt = np.stack([np.linalg.inv(poses[0]) @ p for p in poses[:n_steps]])
    stats = evaluation.ate(est[:, :3, 3], gt[:, :3, 3])
    print(f"\nwander ATE rmse: {stats.rmse:.3f} m over {n_steps} steps")
    return pipe, stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_steps", nargs="?", type=int, default=15)
    ap.add_argument("--teleop", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(sys.argv[1:])
    if a.teleop:
        teleop(_cfg(), sim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=4,
                                           device=a.device))
    else:
        main(a.n_steps, a.device)
