"""Port vs JAX package: the offline runner (``examples/run_offline.py`` and
``cooper_mapper_torch/examples/run_offline.py``) on the same sweep files.

The JAX script is loaded by path, unedited.  Both scripts get the same
reduced preset in their ``SENSORS`` (the sensor's rings, ring mapper and
feature capacities at a narrow width, a small map; tests/
torch_example_drives.py) and the same files: unordered sweeps in the
sensor's axis order, simulated by the JAX package at the sensor's vertical
fan.  The JAX pipeline extracts features op by op (tests/
torch_pipeline_drives.py says why).  Trajectories agree within 2e-3 m
(tests/test_odometry.py's tolerance between NN paths).  The HDL-32 and
HDL-64E runs are in tests/test_torch_examples_sensors.py.
"""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.io import pcd, rosbag  # noqa: E402
from tests import torch_example_drives as E  # noqa: E402

jrun, trun = E.jrun, E.trun


def check_run(tmp_path, monkeypatch, sensor):
    """run() of both scripts over the sensor's files: trajectories, stats,
    the organizer's cells, the trajectory and map files."""
    E.use_reduced_presets(monkeypatch, sensor)
    d = str(tmp_path / "sweeps")
    raw = E.simulate_files(d, sensor)
    pj, pt = E.run_both(d, str(tmp_path), sensor)
    E.assert_same_trajectory(pj.trajectory, pt.trajectory)
    assert pt.stats() == {**pj.stats(), "average_score": pt.stats()["average_score"]}
    assert pt.stats()["mapping_solves"] == 2        # sweeps 1 and 2 (stride 2)
    assert pt.device.type == "cpu"
    # the organizer kept every exported point, each in its own ring cell
    n_rings, width, _ = E.SENSORS[sensor]
    cfg = E.reduced_preset(tc, n_rings, width)
    cells = [int(trun.scan_registration.organize_unordered(
        r, cfg.registration, trun.SENSORS[sensor][1], device="cpu").mask.sum()) for r in raw]
    assert cells == [len(r) for r in raw]
    xj, _ = pcd.read_pcd(str(tmp_path / "out_jax" / "trajectory.pcd"))
    xt, _ = pcd.read_pcd(str(tmp_path / "out_torch" / "trajectory.pcd"))
    np.testing.assert_allclose(xt, xj, atol=E.POSE_TOL)
    assert sorted(os.listdir(tmp_path / "out_torch" / "map")) == \
        sorted(os.listdir(tmp_path / "out_jax" / "map"))


@pytest.mark.parametrize("sensor", ["vlp16"])
def test_run_matches_jax(tmp_path, monkeypatch, sensor):
    check_run(tmp_path, monkeypatch, sensor)


def _online_error(out):
    m = re.search(r"online error vs ground truth: mean ([\d.]+) m, max ([\d.]+) m over (\d+)",
                  out)
    assert m, out
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


def test_gt_online_error_matches_jax(tmp_path, monkeypatch, capsys):
    # gt.npz (the bag converter's ground-truth sidecar) beside the sweeps:
    # both scripts report the online error against nearest-time GT poses,
    # and neither takes the sidecars for sweeps
    E.use_reduced_presets(monkeypatch, "vlp16")
    d = str(tmp_path / "sweeps")
    E.simulate_files(d, "vlp16", n=3)
    stamp = 100.0 + 0.05 * np.arange(8)
    position = np.stack([np.zeros(8), np.zeros(8), 0.35 * 20 * (stamp - stamp[0])], -1)
    np.savez(os.path.join(d, "gt.npz"), stamp=stamp, position=position.astype(np.float32))
    np.savez(os.path.join(d, "imu.npz"), stamp=stamp)
    capsys.readouterr()
    pj, pt = E.run_both(d, str(tmp_path), "vlp16")
    out = capsys.readouterr().out.split("sweep_0000.npz")
    E.assert_same_trajectory(pj.trajectory, pt.trajectory)
    ej, et = _online_error(out[1]), _online_error(out[2])
    assert et[2] == ej[2] == 3
    np.testing.assert_allclose(et[:2], ej[:2], atol=E.POSE_TOL + 1e-3)   # printed to 1 mm


def test_bag_cli_matches_jax(tmp_path, monkeypatch):
    # run_offline --bag: a bag of PointCloud2 sweeps (the sensor's axis
    # order) through bag_to_npz and the same file replay, from each
    # script's command line
    E.use_reduced_presets(monkeypatch, "vlp16")
    raw = E.simulate_files(str(tmp_path / "sim"), "vlp16", n=3)
    bag = str(tmp_path / "drive.bag")
    rosbag.write_bag(bag, [("/multi_scan_points", "sensor_msgs/PointCloud2", 10.0 + 0.1 * i,
                            rosbag.encode_pointcloud2(xyz, 10.0 + 0.1 * i))
                           for i, xyz in enumerate(raw)])
    with E.D.op_by_op_extraction():
        monkeypatch.setattr(sys, "argv", ["run_offline.py", "--bag", bag, str(tmp_path / "jax")])
        jrun.main()
    trun.main(["--bag", bag, str(tmp_path / "torch"), "--device", "cpu"])
    xj, _ = pcd.read_pcd(str(tmp_path / "jax" / "trajectory.pcd"))
    xt, _ = pcd.read_pcd(str(tmp_path / "torch" / "trajectory.pcd"))
    assert len(xt) == len(raw) and np.isfinite(xt).all()
    np.testing.assert_allclose(xt, xj, atol=E.POSE_TOL)
    assert sorted(os.listdir(tmp_path / "torch" / "bag_npz")) == \
        sorted(os.listdir(tmp_path / "jax" / "bag_npz"))


def test_cli_arguments(tmp_path, monkeypatch):
    # the JAX script's CLI, and --device
    for argv in ([],                                      # SWEEP_DIR and OUT_DIR required
                 ["--bag", str(tmp_path / "x.bag")],       # OUT_DIR required
                 [str(tmp_path), str(tmp_path / "o"), "--device", "cpu"],      # no sweeps
                 [str(tmp_path), str(tmp_path / "o"), "--sensor", "velodyne"]):
        with pytest.raises(SystemExit):
            trun.main(argv)
    E.use_reduced_presets(monkeypatch, "vlp16")
    d = str(tmp_path / "sweeps")
    E.simulate_files(d, "vlp16", n=2)
    trun.main([d, str(tmp_path / "o"), "--mode", "local", "--stride", "1", "--device", "cpu"])
    assert os.path.exists(tmp_path / "o" / "trajectory.pcd")
    assert not os.path.exists(tmp_path / "o" / "map")        # no map file in "local" mode
    assert sorted(trun.SENSORS) == sorted(jrun.SENSORS)
    monkeypatch.undo()
    for name, (preset, mapper) in trun.SENSORS.items():
        jpreset, jmapper = jrun.SENSORS[name]
        assert dataclasses.asdict(preset().registration) == \
            dataclasses.asdict(jpreset().registration)
        assert mapper.n_rings == jmapper.n_rings == preset().registration.n_rings
