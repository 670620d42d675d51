"""Port vs JAX package: the scan-registration front ends
(``models/scan_registration``): the organizers, the IMU history integration,
its interpolation and the IMU de-warp.

The organizers are numpy in both packages and must agree bit for bit.  The
IMU history is a sequential ``lax.scan`` in the JAX package and two
cumulative sums in the port: within 1e-5 relative.  ``_interp_state`` and
``imu_dewarp`` get the same history (the JAX package's, bridged) and must
agree within 1e-5 (radians, metres).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import RegistrationConfig as JReg  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.models import scan_registration as jsr  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import RegistrationConfig  # noqa: E402
from cooper_mapper_torch.models import scan_registration as tsr  # noqa: E402

TOL = 1e-5


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _same_sweep(t, j):
    for f in ("xyz", "mask", "rel_time"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


@pytest.fixture(scope="module")
def raw_points():
    """A simulated VLP-16 sweep as an unorganized cloud in the sensor's axis
    order, with NaNs and points out of range mixed in."""
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=21)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    sw = jsim.scan_sweep(world, jnp.asarray(p), jnp.asarray(p), n_rings=16, width=512)
    pts = np.asarray(sw.xyz)[np.asarray(sw.mask)]
    pts = pts[:, [2, 0, 1]]                 # LOAM (y, z, x) back to the sensor's (x, y, z)
    rng = np.random.RandomState(0)
    pts = pts[rng.permutation(len(pts))]
    pts[::97] = np.nan
    pts[5::89] *= 1e-3                      # inside min_range
    return pts.astype(np.float32), sw


@pytest.mark.parametrize("mapper,n_rings", [("VLP16", 16), ("HDL32", 32), ("PANDAR40", 40),
                                            ("HDL64E", 64)])
def test_organize_unordered_equals_jax(raw_points, mapper, n_rings):
    pts, _ = raw_points
    jcfg, tcfg = JReg(n_rings=n_rings, max_points_per_ring=600), \
        RegistrationConfig(n_rings=n_rings, max_points_per_ring=600)
    got = tsr.organize_unordered(pts, tcfg, getattr(tsr, mapper), device="cpu")
    want = jsr.organize_unordered(pts, jcfg, getattr(jsr, mapper))
    _same_sweep(got, want)
    assert int(got.mask.sum()) > 1000


def test_organize_grid_equals_jax(raw_points):
    _, sw = raw_points
    xyz = np.asarray(sw.xyz).copy()
    xyz[3, 10] = np.nan
    xyz[4, :5] *= 1e-3
    valid = np.asarray(sw.mask)
    for v in (None, valid):
        _same_sweep(tsr.organize_grid(xyz, RegistrationConfig(), v, device="cpu"),
                    jsr.organize_grid(xyz, JReg(), v))


def _imu(seed=1, n=40, yaw0=3.0):
    """IMU samples at 100 Hz whose yaw crosses +pi and wraps to -pi."""
    rng = np.random.RandomState(seed)
    stamp = (0.95 + 0.01 * np.arange(n)).astype(np.float32)
    acc = (rng.randn(n, 3) * 0.5 + np.array([0.0, 0.0, 9.81])).astype(np.float32)
    yaw = yaw0 + 0.5 * np.arange(n) * 0.01
    rpy = np.stack([0.02 * np.sin(np.arange(n) * 0.3), 0.03 * np.cos(np.arange(n) * 0.2),
                    (yaw + np.pi) % (2 * np.pi) - np.pi], -1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-4:] = False                      # the unused tail of the ring
    return stamp, acc, rpy, mask


def _bridge_history(h):
    return tsr.ImuHistory(*(T(getattr(h, f), torch.bool if f == "mask" else torch.float32)
                            for f in ("stamp", "rpy", "pos", "vel", "mask")))


def test_integrate_imu_history_matches_jax():
    stamp, acc, rpy, mask = _imu()
    hj = jsr.integrate_imu_history(stamp, acc, rpy, mask)
    ht = tsr.integrate_imu_history(stamp, acc, rpy, mask, device="cpu")
    for f in ("stamp", "rpy", "mask"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(), np.asarray(getattr(hj, f)))
    for f in ("pos", "vel"):
        want = np.asarray(getattr(hj, f))
        np.testing.assert_allclose(getattr(ht, f).numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    assert np.abs(np.asarray(hj.pos)).max() > 1e-3
    # no mask: every sample counts
    hj = jsr.integrate_imu_history(stamp, acc, rpy)
    ht = tsr.integrate_imu_history(stamp, acc, rpy, device="cpu")
    np.testing.assert_allclose(ht.pos.numpy(), np.asarray(hj.pos), rtol=0,
                               atol=TOL * np.abs(np.asarray(hj.pos)).max())


def test_interp_state_matches_jax_at_between_and_outside_stamps():
    stamp, acc, rpy, mask = _imu()
    hj = jsr.integrate_imu_history(stamp, acc, rpy, mask)
    ht = _bridge_history(hj)
    valid = stamp[mask]
    t = np.concatenate([valid[[0, 7, 20]],                    # at stamps
                        valid[:-1] + 0.004,                    # between (across the wrap too)
                        [valid[0] - 0.5, valid[-1] + 0.003, 99.0]]).astype(np.float32)
    t = t.reshape(2, -1) if t.size % 2 == 0 else t
    got = tsr._interp_state(ht, T(t))
    want = jsr._interp_state(hj, jnp.asarray(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    # the yaw wrap is crossed between two valid samples
    yaw = rpy[mask][:, 2]
    assert (np.abs(np.diff(yaw)) > np.pi).any()


@pytest.mark.parametrize("has_imu", [True, False])
def test_imu_dewarp_matches_jax(raw_points, has_imu):
    _, sw = raw_points
    stamp, acc, rpy, mask = _imu()
    if not has_imu:
        mask[:] = False
    hj = jsr.integrate_imu_history(stamp, acc, rpy, mask)
    scan_time = float(stamp[5])
    want = jsr.imu_dewarp(sw, hj, scan_time, 0.1)
    got = tsr.imu_dewarp(bridge.sweep(sw, "cpu"), _bridge_history(hj), scan_time, 0.1)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=TOL)
    moved = np.abs(np.asarray(want.xyz) - np.asarray(sw.xyz))[np.asarray(sw.mask)].max()
    assert (moved > 1e-3) == has_imu
    # sweep_start before scan_time
    want = jsr.imu_dewarp(sw, hj, scan_time, 0.1, sweep_start=scan_time - 0.02)
    got = tsr.imu_dewarp(bridge.sweep(sw, "cpu"), _bridge_history(hj), scan_time, 0.1,
                         sweep_start=scan_time - 0.02)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=TOL)
