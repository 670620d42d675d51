"""The card-vs-CPU checks of chip_smoke.py's offline-runner phases (37, 38),
run here with the CPU on both sides, at a narrow width.

``compare_features`` must pass two runs of the same device and flag a
compaction that does not keep the first picked cells in ring-major order;
``PipelineProbe(capture=...)`` with ``lockstep_replay`` must reproduce the
recorded solves exactly on the device that ran them; and
``run_offline.write_drive`` must write the selftest's drive, the points the
JAX package's simulator casts in the sensor's axes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.utils import cloud as cloud_lib  # noqa: E402
from tests import torch_example_drives as E  # noqa: E402

trun = E.trun


def _first_sweep(tmp_path, sensor):
    n_rings, width, vfov = E.SENSORS[sensor]
    d = str(tmp_path / "sweeps")
    trun.write_drive(d, 1, n_rings, width, vfov, device="cpu")
    cfg = E.reduced_preset(tc, n_rings, width)
    return trun.load_sweep_file(os.path.join(d, "sweep_0000.npz")), cfg, trun.SENSORS[sensor][1]


def test_compare_features_passes_one_device(tmp_path):
    pts, cfg, mapper = _first_sweep(tmp_path, "hdl64")
    feats, feats_cpu, moved, problems = chip_smoke.compare_features(pts, cfg, mapper, "cpu")
    assert (moved, problems) == (0, [])
    assert feats == feats_cpu
    # sharp and flat overflow at 64 rings: the compaction's cut is exercised
    assert feats["sharp"][:2] == (256, 256) and feats["flat"][:2] == (1024, 1024)


def test_compare_features_flags_a_compaction_out_of_order(tmp_path, monkeypatch):
    pts, cfg, mapper = _first_sweep(tmp_path, "hdl64")
    compact = cloud_lib.compact

    def last_first(c, capacity=None):
        # the valid points to the front in reverse order, then the cut
        valid = torch.nonzero(c.mask).reshape(-1).flip(0)
        order = torch.cat([valid, torch.nonzero(~c.mask).reshape(-1)])
        return compact(cloud_lib.Cloud(c.xyz[order], c.mask[order], c.ring[order],
                                       c.rel_time[order]), capacity)

    monkeypatch.setattr(cloud_lib, "compact", last_first)
    problems = chip_smoke.compare_features(pts, cfg, mapper, "cpu")[3]
    assert "the card's sharp is not the first 256 picked cells" in problems
    assert "the card's flat is not the first 1024 picked cells" in problems


def test_lockstep_replay_reproduces_the_solves(tmp_path, monkeypatch):
    E.use_reduced_presets(monkeypatch, "vlp16")
    n_rings, width, vfov = E.SENSORS["vlp16"]
    d = str(tmp_path / "sweeps")
    trun.write_drive(d, 4, n_rings, width, vfov, device="cpu")
    with chip_smoke.PipelineProbe(trun, capture=4) as probe:
        pipe = trun.run(d, str(tmp_path / "out"), "vlp16", device="cpu")
    assert len(probe.sweeps) == 4 and len(probe.solves) == 2
    assert [e["sweep"] for e in probe.lockstep] == [1, 2, 3]
    assert ["map" in e for e in probe.lockstep] == [True, True, False]   # stride 2
    assert [r["odo_ulp"] for r in chip_smoke.lockstep_replay(probe.lockstep)] == [None] * 3
    monkeypatch.setattr(chip_smoke, "CPU_TOL", -1.0)          # every solve gets its witness
    replay = chip_smoke.lockstep_replay(probe.lockstep)
    for row in replay:
        assert row["odo"] == row["projected"] == 0.0
        assert row["matched"][0] == row["matched"][1] > 0
        assert 0.0 <= row["odo_ulp"] < 2e-3      # the witness: a rounding-size move
    assert [(r["map"], r["frame"]) for r in replay[:2]] == [(0.0, 0), (0.0, 0)]
    assert replay[1]["score"][0] == replay[1]["score"][1]
    # the probe patched nothing for good
    assert trun.SlamPipeline is type(pipe).__mro__[1]
    assert np.isfinite(np.stack(pipe.trajectory)).all()


@pytest.mark.parametrize("sensor", ["vlp16", "hdl64"])
def test_write_drive_is_the_selftests_drive(tmp_path, sensor):
    # the JAX simulator's drive (tests/torch_example_drives.py) in the same
    # axis order; the two simulators part by ~1e-5 (tests/test_torch_sim.py)
    n_rings, width, vfov = E.SENSORS[sensor]
    written = trun.write_drive(str(tmp_path / "t"), 3, n_rings, width, vfov, device="cpu")
    raw = E.simulate_files(str(tmp_path / "j"), sensor, n=3)
    assert written == [len(r) for r in raw]
    for i, r in enumerate(raw):
        xyz = np.load(tmp_path / "t" / f"sweep_{i:04d}.npz")["xyz"]
        np.testing.assert_allclose(xyz, r, atol=1e-3)
