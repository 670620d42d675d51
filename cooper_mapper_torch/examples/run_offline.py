"""Offline runner: run the full SLAM pipeline over a directory of sweeps
(port of ``examples/run_offline.py``).

The file-replay equivalent of the reference's rosbag workflow ("Running in
the Cooper Union 6th floor", L_SLAM/README.md): each sweep is one file
(`.pcd` or `.npz` with an ``xyz`` array), sorted by name = time order, fed
through the unordered-cloud organizer (MultiScanRegistration ring mapping)
into SlamPipeline; the map, trajectory, and stats are written at the end.

Run:
  python -m cooper_mapper_torch.examples.run_offline SWEEP_DIR OUT_DIR
         [--sensor vlp16|hdl32|hdl64|pandar40] [--mode mapping|local]
         [--stride N] [--device cuda|cpu]
  python -m cooper_mapper_torch.examples.run_offline --bag RECORDING.bag OUT_DIR [...]
         (rosbag V2.0: converted via cooper_mapper_torch.io.rosbag, then
          replayed through the same file path; the reference's own
          /multi_scan_points + /imu/data topics are picked by default)

With no real data at hand, --selftest generates a simulated drive into a
temp directory first and then replays it through the exact same file path,
proving the loop end-to-end:
  python -m cooper_mapper_torch.examples.run_offline --selftest

The pipeline runs on ``--device`` (the card by default); there is no
fallback to the CPU.
"""

import argparse
import dataclasses
import glob
import os
import time

import numpy as np

from .. import config as cfg_mod
from ..io import map_io, pcd
from ..models import scan_registration
from ..models.pipeline import SlamPipeline

SENSORS = {
    "vlp16": (cfg_mod.vlp16, scan_registration.VLP16),
    "hdl32": (cfg_mod.hdl32, scan_registration.HDL32),
    "hdl64": (cfg_mod.hdl64, scan_registration.HDL64E),
    "pandar40": (cfg_mod.pandar40, scan_registration.PANDAR40),
}


def load_sweep_file(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["xyz"]
    xyz, _ = pcd.read_pcd(path)
    return xyz


def run(sweep_dir: str, out_dir: str, sensor: str = "vlp16",
        mode: str = "mapping", stride: int = 2,
        axis_remap: bool = True, device="cuda") -> SlamPipeline:
    preset, mapper = SENSORS[sensor]
    cfg = preset()
    cfg = dataclasses.replace(cfg, mapping_stride=stride)
    pipe = SlamPipeline(cfg, mode=mode, device=device)

    files = sorted(
        glob.glob(os.path.join(sweep_dir, "*.pcd"))
        + [f for f in glob.glob(os.path.join(sweep_dir, "*.npz"))
           # sidecar archives from the bag converter are not sweeps
           if os.path.basename(f) not in ("imu.npz", "gt.npz")]
    )
    if not files:
        raise SystemExit(f"no .pcd/.npz sweeps under {sweep_dir}")
    t0 = time.perf_counter()
    for i, path in enumerate(files):
        pts = load_sweep_file(path)
        sweep = scan_registration.organize_unordered(
            pts, cfg.registration, mapper, axis_remap=axis_remap, device=device)
        r = pipe.process(sweep, stamp=0.1 * (i + 1))
        pos = r.merged_pose[:3, 3]
        print(f"{os.path.basename(path)}: pos=[{pos[0]:.2f} {pos[1]:.2f} "
              f"{pos[2]:.2f}] matched={r.odom_matched}"
              + ("" if r.mapping_success is None
                 else f" gate={'ok' if r.mapping_success else 'FAIL'}"),
              flush=True)
    wall = time.perf_counter() - t0

    os.makedirs(out_dir, exist_ok=True)
    if mode == "mapping":
        n = map_io.save_feature_map(pipe.single_map_state(), cfg.feature_map,
                                    os.path.join(out_dir, "map"))
        print(f"saved {n} map cubes")
    traj = np.stack(pipe.trajectory)
    map_io.save_trajectory_pcd(os.path.join(out_dir, "trajectory.pcd"), traj)
    print(f"{len(files)} sweeps in {wall:.1f} s "
          f"({len(files)/wall:.2f} sweeps/s); stats: {pipe.stats()}")
    # Evaluation-node equivalent (map_evaluation/Evaluation.cpp:39-147):
    # when the recording carried GNSS/odometry ground truth (gt.npz from
    # the bag converter), report the online position error of the
    # trajectory against nearest-time GT poses, >10 m samples dropped
    gt_path = os.path.join(sweep_dir, "gt.npz")
    if os.path.exists(gt_path):
        from ..io import evaluation

        gt = np.load(gt_path)
        stamps = np.asarray([0.1 * (i + 1) for i in range(len(files))])
        rel = gt["stamp"] - gt["stamp"][0] + stamps[0]
        stats = evaluation.online_error(
            traj[:, :3, 3], gt["position"], est_stamp=stamps, gt_stamp=rel)
        print(f"online error vs ground truth: mean {stats.mean:.3f} m, "
              f"max {stats.maximum:.3f} m over {stats.n} matched samples")
    pipe.timer.report()
    return pipe


def write_drive(sweep_dir: str, n: int, n_rings: int = 16, width: int = 1024,
                vfov=(-15.0, 15.0), step_m: float = 0.35, device="cuda") -> list:
    """Simulate a straight, level drive through the selftest's room and write
    it to ``sweep_dir``: ``n`` sweeps ``step_m`` apart, each an .npz of the
    valid points as an unordered list in the sensor's axes.  Returns the
    points written per sweep."""
    import torch

    from ..io import sim

    os.makedirs(sweep_dir, exist_ok=True)
    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31, device=device)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = step_m
    written = []
    for i in range(n):
        p2 = p @ step
        sw = sim.scan_sweep(world, torch.from_numpy(p), torch.from_numpy(p2),
                            n_rings=n_rings, width=width, vfov=vfov)
        # export as an unordered point list IN SENSOR AXES (undo the
        # organizer's (y,z,x) remap so the file looks like the sensor's output)
        xyz = sw.xyz[sw.mask].cpu().numpy()
        xyz = xyz[:, [2, 0, 1]]
        np.savez(os.path.join(sweep_dir, f"sweep_{i:04d}.npz"), xyz=xyz)
        written.append(len(xyz))
        p = p2
    return written


def selftest(device="cuda"):
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cooper_selftest_") as tmp:
        sweep_dir, out_dir = os.path.join(tmp, "sweeps"), os.path.join(tmp, "out")
        write_drive(sweep_dir, 8, device=device)
        print(f"selftest: {sweep_dir} -> {out_dir}")
        pipe = run(sweep_dir, out_dir, sensor="vlp16", mode="mapping", stride=2,
                   device=device)
    # the replayed drive is a straight corridor run; the pipeline must track
    drift = np.linalg.norm(
        pipe.trajectory[-1][:3, 3] - np.array([0, 0, 0.35 * 7]))
    print(f"selftest drift vs dead-straight ground truth: {drift:.3f} m")
    assert drift < 0.25, drift
    print("SELFTEST OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sweep_dir", nargs="?")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--bag", help="rosbag V2.0 recording to convert + replay")
    ap.add_argument("--cloud-topic", help="PointCloud2 topic in the bag")
    ap.add_argument("--sensor", default="vlp16", choices=sorted(SENSORS))
    ap.add_argument("--mode", default="mapping", choices=["mapping", "local"])
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--no-axis-remap", action="store_true")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pipeline runs on (default: the card)")
    args = ap.parse_args(argv)
    if args.selftest:
        selftest(args.device)
        return
    if args.bag:
        # positional slot shifts: `run_offline --bag foo.bag OUT_DIR`
        out_dir = args.out_dir or args.sweep_dir
        if not out_dir:
            ap.error("OUT_DIR required with --bag")
        from ..io import rosbag

        sweep_dir = os.path.join(out_dir, "bag_npz")
        info = rosbag.bag_to_npz(args.bag, sweep_dir,
                                 cloud_topic=args.cloud_topic)
        print(f"bag: {info['n_sweeps']} sweeps from {info['cloud_topic']}, "
              f"{info['n_imu']} imu msgs, {info['n_gt']} gt poses "
              f"-> {sweep_dir}")
        run(sweep_dir, out_dir, args.sensor, args.mode, args.stride,
            axis_remap=not args.no_axis_remap, device=args.device)
        return
    if not args.sweep_dir or not args.out_dir:
        ap.error("SWEEP_DIR and OUT_DIR required (or --selftest / --bag)")
    run(args.sweep_dir, args.out_dir, args.sensor, args.mode, args.stride,
        axis_remap=not args.no_axis_remap, device=args.device)


if __name__ == "__main__":
    main()
