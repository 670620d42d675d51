"""Port vs JAX package and the C++ transcription: ``extract_features_debug``
and the extractor and IMU de-warp held to ``tests/ref_oracle.py``.

* ``extract_features_debug`` against the JAX package's op-by-op
  ``features._extract_impl`` (the jitted extractor re-associates the
  curvature sums, ROADMAP Queue 3), every field, and its clouds bit for bit
  against the port's own ``extract_features``.  Curvature, status and
  region ids are bit-identical.  The labels come from eig3's closed-form
  eigenvalues, whose ``arccos`` and ``cos`` differ from XLA's by an ulp on
  ~1 in 5 inputs, so about one point per sweep sits on a classification
  threshold that an ulp decides: labels may differ on at most 0.1% of the
  points, and the picked masks only in the rings of such a point (the picks
  are per ring);
* tests/test_features.py::TestFeatureDebug, TestFeaturesGolden and
  TestImuDewarpGolden with the port in place of the JAX package, at their
  tolerances: exact picked sets on the engineered scene, the same Jaccard
  floors on the occlusion scene, 1e-4 on the IMU history, 2e-3 m on the
  de-warped points.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests import ref_oracle as ro  # noqa: E402
from cooper_mapper_tpu.config import RegistrationConfig as JReg  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import RegistrationConfig as TReg  # noqa: E402
from cooper_mapper_torch.models import scan_registration as tsr  # noqa: E402
from cooper_mapper_torch.ops import features as tfeat  # noqa: E402

CLOUDS = ("sharp", "less_sharp", "flat", "less_flat")


def _room_sweep(width=512, distorted=False):
    world = jsim.make_room_world(size=(20.0, 4.0, 24.0), n_pillars=5, seed=4)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    c, s = np.cos(0.02), np.sin(0.02)
    motion = np.array([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]], np.float32)
    p1 = p0 @ motion if distorted else p0
    return jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p1), n_rings=16, width=width,
                           distortion=distorted)


@pytest.mark.parametrize("distorted", [False, True], ids=["static", "distorted"])
def test_debug_matches_jax_op_by_op(distorted):
    sj = _room_sweep(distorted=distorted)
    st = bridge.sweep(sj, "cpu")
    fcj, dbj = jfeat._extract_impl(sj, JReg(n_rings=16, max_points_per_ring=512))
    fct, dbt = tfeat.extract_features_debug(st, TReg(n_rings=16, max_points_per_ring=512))
    for f in ("curvature", "status", "region_id"):
        np.testing.assert_array_equal(getattr(dbt, f).numpy(), np.asarray(getattr(dbj, f)),
                                      err_msg=f)
    flips = dbt.label.numpy() != np.asarray(dbj.label)
    assert flips.mean() <= 1e-3, int(flips.sum())
    for f in ("sharp_picked", "flat_picked"):
        differ = getattr(dbt, f).numpy() != np.asarray(getattr(dbj, f))
        assert not (differ.any(-1) & ~flips.any(-1)).any(), f
    plain = tfeat.extract_features(st, TReg(n_rings=16, max_points_per_ring=512))
    for name in CLOUDS:
        for f in ("xyz", "mask", "ring", "rel_time"):
            assert torch.equal(getattr(getattr(fct, name), f), getattr(getattr(plain, name), f))


def test_debug_outputs_consistent():
    """tests/test_features.py::TestFeatureDebug, on the port."""
    st = bridge.sweep(_room_sweep(), "cpu")
    cfg = TReg(n_rings=16, max_points_per_ring=512)
    fc, dbg = tfeat.extract_features_debug(st, cfg)
    assert dbg.curvature.shape == (16, 512) and dbg.status.shape == (16, 512)
    assert int(dbg.sharp_picked.sum()) == int(fc.sharp.mask.sum())
    assert int(dbg.flat_picked.sum()) == int(fc.flat.mask.sum())
    assert set(dbg.status.unique().tolist()) <= {tfeat.BLIND_BLOCK, tfeat.NEAR_BLOCK,
                                                  tfeat.EDGE_BROKEN, tfeat.STATUS_NONE}
    assert set(dbg.label.unique().tolist()) <= {tfeat.MESSY, tfeat.CLS_SURFACE_FLAT,
                                                 tfeat.CLS_CORNER_SHARP, tfeat.CLS_ONESIDE_FLAT}
    assert int(dbg.region_id.min()) >= -1 and int(dbg.region_id.max()) < cfg.n_feature_regions


class TestFeaturesGolden:
    """Set-level pick parity against the literal extractFeatures oracle.
    Scene A is engineered so the documented order-dependence deviations
    cannot bite: parity must be exact.  Scene B (occlusion chains, equal-
    curvature floor plateaus) bounds the divergence by Jaccard floors."""

    W, R = 1024, 4

    def _square_ring(self, y, wave_seed=0):
        """tests/test_features.py::TestFeaturesGolden._square_ring."""
        W = self.W
        az = np.arange(W) * 2 * np.pi / W
        r = 5.0 / np.maximum(np.abs(np.cos(az)), np.abs(np.sin(az)))
        quad_pos = (az % (np.pi / 2)) / (np.pi / 2)
        amp = 0.002 + 0.018 * quad_pos
        rng = np.random.RandomState(wave_seed)
        wave = amp * np.sin(24 * 2 * np.pi * quad_pos + rng.uniform(0, 2 * np.pi))
        corner_k = np.array([128, 384, 640, 896])
        dist = np.min(np.abs(az[:, None] - az[corner_k][None, :]), axis=1)
        r = r + np.where(dist < 8 * 2 * np.pi / W, 0.0, wave)
        return (np.stack([r * np.cos(az), np.full(W, y), r * np.sin(az)], -1).astype(np.float32),
                az / (2 * np.pi))

    def _compare(self, sweep, cfg):
        _, dbg = tfeat.extract_features_debug(sweep, cfg)
        sharp_fw, flat_fw = dbg.sharp_picked.numpy(), dbg.flat_picked.numpy()
        xyz, mask = sweep.xyz.numpy(), sweep.mask.numpy()
        inter, union, exact = {"sharp": 0, "flat": 0}, {"sharp": 0, "flat": 0}, True
        for ri in range(mask.shape[0]):
            n = int(mask[ri].sum())
            orc = ro.extract_features_ring(
                xyz[ri, :n].astype(np.float64), cr=cfg.curvature_region,
                nreg=cfg.n_feature_regions, max_corner_sharp=cfg.max_corner_sharp,
                max_surface_flat=cfg.max_surface_flat, surf_thresh=cfg.surface_curvature_threshold,
                blind_threshold=cfg.blind_threshold)
            for key, o_set, f_mask in (("sharp", set(orc.sharp), sharp_fw[ri][:n]),
                                       ("flat", set(orc.flat), flat_fw[ri][:n])):
                f_set = set(np.nonzero(f_mask)[0].tolist())
                inter[key] += len(o_set & f_set)
                union[key] += len(o_set | f_set)
                exact = exact and o_set == f_set
        return exact, {k: inter[k] / max(union[k], 1) for k in inter}

    def test_exact_parity_clean_scene(self):
        xyzs, rels = zip(*[self._square_ring(0.2 * ri, wave_seed=ri) for ri in range(self.R)])
        sweep = tfeat.Sweep(xyz=torch.from_numpy(np.stack(xyzs)),
                            mask=torch.ones((self.R, self.W), dtype=torch.bool),
                            rel_time=torch.from_numpy(np.stack(rels).astype(np.float32)))
        exact, jac = self._compare(sweep, TReg(n_rings=self.R, max_points_per_ring=self.W))
        assert exact, f"picked sets differ on the no-bite scene: {jac}"
        assert jac["sharp"] == 1.0 and jac["flat"] == 1.0

    def test_quantified_divergence_occlusion_scene(self):
        """The pillar world: the JAX test's floors (measured there: sharp
        0.93, flat 0.73)."""
        world = jsim.make_room_world(seed=11, n_pillars=10)
        p0 = jnp.eye(4, dtype=jnp.float32).at[1, 3].set(1.5)
        sweep = bridge.sweep(jsim.scan_sweep(world, p0, p0, n_rings=16, width=1024), "cpu")
        _, jac = self._compare(sweep, TReg(n_rings=16, max_points_per_ring=1024))
        assert jac["sharp"] >= 0.85, jac
        assert jac["flat"] >= 0.60, jac


class TestImuDewarpGolden:
    """``integrate_imu_history`` and ``imu_dewarp`` against the literal IMU
    transcription (ScanRegistration.cpp:89-188), in azimuth-major order."""

    def _imu_stream(self, n=40, hz=100.0, seed=3):
        """tests/test_features.py::TestImuDewarpGolden._imu_stream."""
        rng = np.random.RandomState(seed)
        t = 10.0 + np.arange(n) / hz
        roll = 0.05 * np.sin(2 * np.pi * 1.3 * (t - t[0]))
        pitch = 0.04 * np.sin(2 * np.pi * 0.9 * (t - t[0]) + 1.0)
        yaw = np.mod(np.pi - 0.02 + 0.8 * (t - t[0]) + np.pi, 2 * np.pi) - np.pi
        rpy = np.stack([roll, pitch, yaw], -1)
        acc = 0.3 * rng.randn(n, 3)
        acc[:, 2] += 9.81 * np.cos(roll) * np.cos(pitch)
        return t, acc, rpy

    def test_history_integration_matches(self):
        t, acc, rpy = self._imu_stream()
        hist = tsr.integrate_imu_history(t, acc, rpy, device="cpu")
        golden = ro.imu_history_oracle(t, acc, rpy)
        np.testing.assert_allclose(hist.pos.numpy(), np.stack([s.position for s in golden]),
                                   atol=1e-4)
        np.testing.assert_allclose(hist.vel.numpy(), np.stack([s.velocity for s in golden]),
                                   atol=1e-4)

    def test_dewarp_matches_oracle(self):
        t, acc, rpy = self._imu_stream()
        hist = tsr.integrate_imu_history(t, acc, rpy, device="cpu")
        golden = ro.imu_history_oracle(t, acc, rpy)
        rng = np.random.RandomState(0)
        R, W = 4, 64
        scan_time = float(t[3]) + 0.004
        xyz = rng.uniform(-8, 8, (R, W, 3)).astype(np.float32)
        rel = np.broadcast_to((np.arange(W, dtype=np.float32) / W)[None, :], (R, W)).copy()
        sweep = tfeat.Sweep(xyz=torch.from_numpy(xyz), mask=torch.ones((R, W), dtype=torch.bool),
                            rel_time=torch.from_numpy(rel))
        out = tsr.imu_dewarp(sweep, hist, scan_time, scan_period=0.1)
        gold = ro.imu_dewarp_oracle(xyz.transpose(1, 0, 2).reshape(-1, 3).astype(np.float64),
                                    np.repeat(rel[0] * 0.1, R), golden, scan_time)
        got = out.xyz.numpy().transpose(1, 0, 2).reshape(-1, 3)
        np.testing.assert_allclose(got, gold, atol=2e-3)

    def test_dewarp_before_history_start_is_raw_state(self):
        t, acc, rpy = self._imu_stream()
        hist = tsr.integrate_imu_history(t, acc, rpy, device="cpu")
        golden = ro.imu_history_oracle(t, acc, rpy)
        scan_time = float(t[0]) - 0.05
        xyz = np.random.RandomState(1).uniform(-5, 5, (1, 16, 3)).astype(np.float32)
        rel = np.linspace(0, 0.3, 16, dtype=np.float32)[None, :]
        sweep = tfeat.Sweep(xyz=torch.from_numpy(xyz), mask=torch.ones((1, 16), dtype=torch.bool),
                            rel_time=torch.from_numpy(rel))
        out = tsr.imu_dewarp(sweep, hist, scan_time, scan_period=0.1)
        gold = ro.imu_dewarp_oracle(xyz[0].astype(np.float64), rel[0] * 0.1, golden, scan_time)
        np.testing.assert_allclose(out.xyz.numpy()[0], gold, atol=2e-3)
