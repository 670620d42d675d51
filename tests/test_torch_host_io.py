"""Port vs JAX package: the host I/O and GNSS modules.

``fusion/utm``, ``fusion/fpd_receiver`` (with ``utils/se3.quat_slerp``),
``utils/frames``, ``io/rosbag``, the native sweep binner and cube pager
(``io/native_binner``, ``io/native_pager``: the port builds its own
libraries from ``native/*.cpp``, without ``-march=native``) and
``utils/profiling.trace``.  The counterparts of tests/test_io.py's
TestUtm, TestFpdQueue, TestNativePager, TestNativeBinner,
TestNativeTableBinner and TestRosbag, each also held to the JAX package's
function on the same numpy-seeded inputs.

Tolerances: UTM within 1e-6 m; GNSS poses, the interpolated queue poses,
the slerp and the frame tree within 1e-6; bags byte-identical; converted
arrays equal; the two binner builds' masks and points equal and ``rel``
within 1e-6.  The binner's two builds differ only in ``-march=native``
(the JAX package's prebuilt library uses AVX-512 and FMA contraction where
the compiler chooses, the port's build the baseline x86-64 set), which
may move a point that sits on a ring or column boundary; the test counts
such cells, holds each to lie on a boundary, and on these inputs finds
none.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.fusion import fpd_receiver as jfpd  # noqa: E402
from cooper_mapper_tpu.fusion import utm as jutm  # noqa: E402
from cooper_mapper_tpu.io import native_binner as jbin  # noqa: E402
from cooper_mapper_tpu.io import pcd as jpcd  # noqa: E402
from cooper_mapper_tpu.io import rosbag as jbag  # noqa: E402
from cooper_mapper_tpu.models import scan_registration as jsr  # noqa: E402
from cooper_mapper_tpu.utils import frames as jframes  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.fusion import fpd_receiver as tfpd  # noqa: E402
from cooper_mapper_torch.fusion import utm as tutm  # noqa: E402
from cooper_mapper_torch.io import native_binner as tbin  # noqa: E402
from cooper_mapper_torch.io import native_pager as tpager  # noqa: E402
from cooper_mapper_torch.io import pcd as tpcd  # noqa: E402
from cooper_mapper_torch.io import rosbag as tbag  # noqa: E402
from cooper_mapper_torch.io import sim as tsim  # noqa: E402
from cooper_mapper_torch.models import scan_registration as tsr  # noqa: E402
from cooper_mapper_torch.models.pipeline import SlamPipeline  # noqa: E402
from cooper_mapper_torch.utils import frames as tframes  # noqa: E402
from cooper_mapper_torch.utils import profiling  # noqa: E402
from cooper_mapper_torch.utils import se3 as tse3  # noqa: E402

TOL = 1e-6


def _random_pose(rng):
    R = tse3.euler_zyx_to_rot(*torch.from_numpy(rng.uniform(-np.pi, np.pi, 3)
                                                .astype(np.float32))).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.uniform(-50, 50, 3)
    return T


def _pose_close(got, want):
    """Rotations within 1e-6; translations within 1e-6 relative (they are
    tens to thousands of metres, composed in float32)."""
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=TOL, rtol=0)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[3], want[3])


# ---- GNSS --------------------------------------------------------------------

def test_utm_known_points():
    # tests/test_io.py::TestUtm: NYC in zone 18N, and the central meridian
    e, n, zone = tutm.wgs84_to_utm(40.7128, -74.0060)
    assert zone == 18 and abs(e - 583960) < 10 and abs(n - 4507351) < 10
    e, n, _ = tutm.wgs84_to_utm(45.0, -75.0)
    assert abs(e - 500000.0) < 1e-6 and abs(n - 4982950.4) < 1.0
    np.testing.assert_allclose(
        tutm.gnss_to_map(40.7128, -74.0060, 10.0, 40.7128, -74.0060, 10.0), np.zeros(3),
        atol=1e-6)


@pytest.mark.parametrize("zone", [None, 33])
def test_utm_matches_jax(zone):
    rng = np.random.RandomState(0)
    lat, lon = rng.uniform(-80, 84, 64), rng.uniform(10, 20, 64)
    got, want = tutm.wgs84_to_utm(lat, lon, zone), jutm.wgs84_to_utm(lat, lon, zone)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=0)
    alt = rng.uniform(0, 900, 64)
    np.testing.assert_allclose(
        tutm.gnss_to_map(lat, lon, alt, 48.1, 11.5, 500.0),
        jutm.gnss_to_map(lat, lon, alt, 48.1, 11.5, 500.0), atol=TOL, rtol=0)


@pytest.mark.parametrize("with_extrinsic", [False, True])
def test_fpd_to_pose_matches_jax(with_extrinsic):
    rng = np.random.RandomState(1)
    origin = (48.137, 11.575, 519.0)
    T_il = _random_pose(rng) if with_extrinsic else None
    for _ in range(8):
        lat, lon = origin[0] + rng.uniform(-0.01, 0.01), origin[1] + rng.uniform(-0.01, 0.01)
        alt, roll, pitch, heading = rng.uniform(500, 540), *rng.uniform(-30, 30, 2), \
            rng.uniform(0, 360)
        got = tfpd.fpd_to_pose(lat, lon, alt, roll, pitch, heading, tfpd.MapOrigin(*origin),
                               T_il)
        want = jfpd.fpd_to_pose(lat, lon, alt, roll, pitch, heading, jfpd.MapOrigin(*origin),
                                T_il)
        assert got.dtype == np.float32
        _pose_close(got, want)


def test_fpd_queue_interpolation():
    # tests/test_io.py::TestFpdQueue
    q = tfpd.FpdQueue()
    T1 = np.eye(4, dtype=np.float32)
    T1[:3, 3] = [2.0, 0, 0]
    q.push(0.0, np.eye(4, dtype=np.float32))
    q.push(1.0, T1)
    np.testing.assert_allclose(q.find_nearest(0.5)[:3, 3], [1.0, 0, 0], atol=1e-6)


def test_fpd_queue_matches_jax():
    """find_nearest between random poses (the slerp) and between equal
    rotations (its lerp fallback), before, inside and past the stamps, and
    the queue's capacity."""
    rng = np.random.RandomState(2)
    tq, jq = tfpd.FpdQueue(capacity=6), jfpd.FpdQueue(capacity=6)
    poses = [_random_pose(rng) for _ in range(8)]
    poses[5][:3, :3] = poses[4][:3, :3]                   # nearly parallel: the lerp
    for i, P in enumerate(poses):
        tq.push(0.1 * i, P)
        jq.push(0.1 * i, P)
    assert tq.stamps == jq.stamps and len(tq.poses) == 6
    for stamp in np.concatenate([[-1.0, 0.2, 5.0], rng.uniform(0.2, 0.7, 12), [0.45]]):
        np.testing.assert_allclose(tq.find_nearest(stamp), jq.find_nearest(stamp), atol=TOL)
    assert tfpd.FpdQueue().find_nearest(0.0) is None


def test_quat_slerp_matches_jax():
    rng = np.random.RandomState(3)
    q0 = rng.randn(16, 4).astype(np.float32)
    q1 = rng.randn(16, 4).astype(np.float32)
    q1[:4] = -q0[:4]                                      # the shorter arc, nearly parallel
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    for u in (0.0, 0.3, 1.0):
        got = tse3.quat_slerp(torch.from_numpy(q0), torch.from_numpy(q1), u).numpy()
        want = np.asarray(jse3.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), u))
        np.testing.assert_allclose(got, want, atol=TOL)


def test_imu_raw_convert_matches_jax():
    g, a = np.array([10.0, -20.0, 90.0]), np.array([0.0, 1.0, -0.5])
    for x, y in zip(tfpd.imu_raw_convert(g, a), jfpd.imu_raw_convert(g, a)):
        np.testing.assert_array_equal(x, y)


# ---- frame tree ----------------------------------------------------------------

def test_frame_tree_matches_jax():
    rng = np.random.RandomState(4)
    for _ in range(6):
        T, T_bl = _random_pose(rng), _random_pose(rng)
        for extr in (None, T_bl):
            got, want = tframes.frame_tree(T, extr), jframes.frame_tree(T, extr)
            assert got.keys() == want.keys()
            for k in want:
                _pose_close(got[k], want[k])
        np.testing.assert_allclose(tframes.roll_pitch_of(T), jframes.roll_pitch_of(T),
                                   atol=TOL)
        assert abs(tframes.yaw_of(T) - jframes.yaw_of(T)) <= TOL


# ---- rosbag ----------------------------------------------------------------------

def _messages(bag):
    """tests/test_io.py::TestRosbag's messages, encoded by ``bag``'s module."""
    rng = np.random.RandomState(0)
    msgs, clouds = [], []
    for i in range(3):
        xyz = rng.randn(50, 3).astype(np.float32)
        ring = (np.arange(50) % 16).astype(np.uint16)
        inten = rng.rand(50).astype(np.float32)
        clouds.append(xyz)
        t = 10.0 + 0.1 * i
        msgs.append(("/multi_scan_points", "sensor_msgs/PointCloud2", t,
                     bag.encode_pointcloud2(xyz, t, intensity=inten, ring=ring)))
        for k in range(4):
            tk = t + 0.025 * k
            msgs.append(("/imu/data", "sensor_msgs/Imu", tk,
                         bag.encode_imu(tk, [0, 0, 0, 1], [0.01, 0.02, 0.03], [0.0, 9.81, 0.0])))
        msgs.append(("/fpd", "nav_msgs/Odometry", t,
                     bag.encode_odometry(t, [float(i), 0.0, 0.0], [0, 0, 0, 1])))
    return msgs, clouds


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_write_bag_is_byte_identical_to_jax(tmp_path, compression):
    tmsgs, _ = _messages(tbag)
    jmsgs, _ = _messages(jbag)
    for (a, b) in zip(tmsgs, jmsgs):
        assert a[:3] == b[:3] and a[3] == b[3]
    tbag.write_bag(str(tmp_path / "t.bag"), tmsgs, compression=compression)
    jbag.write_bag(str(tmp_path / "j.bag"), jmsgs, compression=compression)
    assert (tmp_path / "t.bag").read_bytes() == (tmp_path / "j.bag").read_bytes()


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_roundtrip(tmp_path, compression):
    # tests/test_io.py::TestRosbag's round trips, read by both packages
    msgs, clouds = _messages(tbag)
    p = str(tmp_path / "a.bag")
    tbag.write_bag(p, msgs, compression=compression)
    reader = tbag.BagReader(p)
    got = list(reader.messages())
    assert len(got) == 18 and reader.connections
    assert got == list(jbag.BagReader(p).messages())
    assert {t for t, _, _, _ in got} == {"/multi_scan_points", "/imu/data", "/fpd"}
    raw = [r for t, _, _, r in got if t == "/multi_scan_points"]
    msg = tbag.decode_pointcloud2(raw[0])
    np.testing.assert_array_equal(msg["xyz"], clouds[0])
    assert msg["ring"].dtype == np.uint16 and "intensity" in msg
    want = jbag.decode_pointcloud2(raw[0])
    assert msg.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(msg[k], want[k])
    imu = tbag.decode_imu(next(r for t, _, _, r in got if t == "/imu/data"))
    np.testing.assert_allclose(imu["angular_velocity"], [0.01, 0.02, 0.03])
    np.testing.assert_allclose(imu["linear_acceleration"], [0.0, 9.81, 0.0])
    odo = tbag.decode_odometry(next(r for t, _, _, r in got if t == "/fpd"))
    np.testing.assert_allclose(odo["position"], [0.0, 0.0, 0.0])


def test_bag_to_npz_matches_jax(tmp_path):
    msgs, clouds = _messages(tbag)
    p = str(tmp_path / "b.bag")
    tbag.write_bag(p, msgs)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    info = tbag.bag_to_npz(p, out_t)
    assert info == jbag.bag_to_npz(p, out_j)
    assert info["n_sweeps"] == 3 and info["n_imu"] == 12 and info["n_gt"] == 3
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in os.listdir(out_t):
        a, b = np.load(os.path.join(out_t, name)), np.load(os.path.join(out_j, name))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(np.load(os.path.join(out_t, "sweep_000001.npz"))["xyz"],
                                  clouds[1])


def test_bag_feeds_pipeline(tmp_path):
    """tests/test_io.py::TestRosbag::test_bag_feeds_pipeline on the port: a
    bag of three simulated 16 x 256 sweeps, converted, organized (the port's
    organizer equal to the JAX package's on every sweep) and replayed
    through the port's SlamPipeline on the CPU; its bound."""
    world = tsim.make_room_world(size=(20.0, 4.0, 24.0), n_pillars=4, seed=13, device="cpu")
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.35
    msgs = []
    for i in range(3):
        p2 = p @ step
        sw = tsim.scan_sweep(world, torch.from_numpy(p), torch.from_numpy(p2), n_rings=16,
                             width=256)
        xyz = sw.xyz.numpy()[sw.mask.numpy()][:, [2, 0, 1]]
        msgs.append(("/multi_scan_points", "sensor_msgs/PointCloud2", 10.0 + 0.1 * i,
                     tbag.encode_pointcloud2(xyz, 10.0 + 0.1 * i)))
        p = p2
    bag = str(tmp_path / "drive.bag")
    tbag.write_bag(bag, msgs)
    out = str(tmp_path / "npz")
    assert tbag.bag_to_npz(bag, out)["n_sweeps"] == 3

    cfg = tc.vlp16()
    cfg = tc.dataclasses.replace(
        cfg, registration=tc.dataclasses.replace(cfg.registration, max_points_per_ring=256),
        mapping_stride=2)
    pipe = SlamPipeline(cfg, mode="mapping", device="cpu")
    for i in range(3):
        z = np.load(os.path.join(out, f"sweep_{i:06d}.npz"))
        sweep = tsr.organize_unordered(z["xyz"], cfg.registration, tsr.VLP16, device="cpu")
        want = jsr.organize_unordered(z["xyz"], cfg.registration, jsr.VLP16)
        for f in ("xyz", "mask", "rel_time"):
            np.testing.assert_array_equal(getattr(sweep, f).numpy(), np.asarray(getattr(want, f)))
        r = pipe.process(sweep, stamp=0.1 * (i + 1))
    assert np.all(np.isfinite(r.merged_pose))
    assert abs(r.merged_pose[2, 3] - 0.70) < 0.3  # tracked ~2 steps forward


# ---- native binner ------------------------------------------------------------

def _ring_cloud(seed, n=20000):
    """TestNativeBinner's smooth surface, in the sensor's raw axis order."""
    rng = np.random.RandomState(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    elev = np.deg2rad(rng.uniform(-15, 15, n))
    r = 10.0 + 0.5 * np.sin(3 * az)
    pts = np.stack([r * np.cos(elev) * np.cos(az), r * np.sin(elev),
                    r * np.cos(elev) * np.sin(az)], -1).astype(np.float32)
    return pts[:, [2, 0, 1]].copy()


def _boundary_cells(pts, n_rings, width, lower=-15.0, upper=15.0, eps=1e-4):
    """[R, W] mask of the cells a point may enter or leave between the two
    builds: those next to a point whose ring coordinate (rounded by the
    binner) lies within ``eps`` of a half-integer, or whose column
    coordinate (truncated) lies within ``eps`` of an integer, in float64."""
    x, y, z = (pts[:, [1, 2, 0]].astype(np.float64)).T          # the LOAM axis remap
    ring_f = (np.rad2deg(np.arctan2(y, np.hypot(x, z))) - lower) * (n_rings - 1) / (upper - lower)
    col_f = np.mod(np.arctan2(z, x), 2 * np.pi) / (2 * np.pi) * width
    edge = ((np.abs(ring_f - np.floor(ring_f) - 0.5) < eps)
            | (np.abs(col_f - np.round(col_f)) < eps))
    out = np.zeros((n_rings, width), bool)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r = np.clip(np.round(ring_f[edge]).astype(int) + dr, 0, n_rings - 1)
            out[r, (np.floor(col_f[edge]).astype(int) + dc) % width] = True
    return out


def _range_ties(got_xyz, want_xyz, mask):
    """[R, W] mask of the occupied cells whose two points differ and lie at
    the same range to 1e-6 (the binner keeps a cell's nearest point, and
    its threads settle an exact tie in their own order)."""
    differ = mask & np.any(got_xyz != want_xyz, -1)
    r_got = np.linalg.norm(got_xyz.astype(np.float64), axis=-1)
    r_want = np.linalg.norm(want_xyz.astype(np.float64), axis=-1)
    return differ & (np.abs(r_got - r_want) <= 1e-6 * r_want)


def test_binner_builds_from_source():
    assert tbin.available() and tbin.table_supported()
    from cooper_mapper_torch import build

    assert os.path.dirname(build.host_library("sweep_binner")._name) == build.BUILD_DIR


def test_binner_builds_serially_without_openmp(tmp_path, monkeypatch):
    """Where the compiler has no OpenMP runtime (it rejects -fopenmp), the
    binner is built without it and bins as the OpenMP build does."""
    from cooper_mapper_torch import build

    cxx = tmp_path / "g++"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = "-fopenmp" ] && '
                   '{ echo "cannot read spec file libgomp.spec" >&2; exit 1; }; done\n'
                   f'exec {build.find_cxx()} "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_host_libs", {})
    lib = build.host_library("sweep_binner")
    with open(tmp_path / "_build" / "libsweep_binner.log") as f:
        last = f.read().strip().splitlines()[-1]
    assert last.startswith("built with:") and "-fopenmp" not in last
    pts = _ring_cloud(0)
    monkeypatch.setattr(tbin, "_load", lambda: lib)
    serial = tbin.bin_sweep_native(pts, 16, 512)
    monkeypatch.undo()
    for a, b in zip(serial, tbin.bin_sweep_native(pts, 16, 512)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_binner_matches_jax_prebuilt(seed):
    if not jbin.available():
        pytest.skip("the JAX package's libsweep_binner.so is not built")
    pts = _ring_cloud(seed)
    got = tbin.bin_sweep_native(pts, 16, 512)
    want = jbin.bin_sweep_native(pts, 16, 512)
    moved = (got[1] != want[1]) | (got[1] & want[1] & np.any(got[0] != want[0], -1))
    # a cell that differs must be next to a point on a ring or column
    # boundary, or hold a range tie; on these inputs no cell differs
    explained = _boundary_cells(pts, 16, 512) | _range_ties(got[0], want[0], got[1] & want[1])
    assert not (moved & ~explained).any()
    assert int(moved.sum()) == 0, f"{int(moved.sum())} cells differ, each explained"
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][got[1]], want[0][want[1]])
    np.testing.assert_allclose(got[2][got[1]], want[2][want[1]], atol=TOL)
    # the batch entry point equals the single one
    batch = tbin.bin_sweep_batch_native(np.stack([pts, _ring_cloud(seed + 1)]), 16, 512)
    for a, b in zip(batch, got):
        np.testing.assert_array_equal(a[0], b)


def test_binner_semantics():
    """tests/test_io.py::TestNativeBinner on the port's build: rings within
    1.01 deg of their angle, rel_time monotone in each ring, and the grid
    feeds the port's feature extractor."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.ops import features
    from cooper_mapper_torch.ops.features import Sweep

    xyz, mask, rel = tbin.bin_sweep_native(_ring_cloud(0), 16, 512)
    assert mask.sum() > 5000
    got = xyz[mask]
    va = np.rad2deg(np.arctan2(got[:, 1], np.hypot(got[:, 0], got[:, 2])))
    rings = np.repeat(np.arange(16), mask.sum(1))
    np.testing.assert_array_less(np.abs(va - (-15 + 2 * rings)), 1.01)
    for rr in range(16):
        assert np.all(np.diff(rel[rr][mask[rr]]) >= 0)
    sweep = Sweep(torch.from_numpy(np.where(mask[..., None], xyz, 1e6)),
                  torch.from_numpy(mask), torch.from_numpy(rel))
    fc = features.extract_features(sweep, RegistrationConfig(n_rings=16, max_points_per_ring=512))
    assert int(fc.less_flat.mask.sum()) > 50


def test_table_binner_matches_python_mapper_and_jax():
    """tests/test_io.py::TestNativeTableBinner: the Pandar40 table's rings
    equal the port's numpy mapper's; the grid equals the JAX package's
    prebuilt library's."""
    rng = np.random.RandomState(3)
    n = 8000
    table = np.asarray(tsr._PANDAR40_ANGLES, np.float32)
    az = rng.uniform(0, 2 * np.pi, n)
    elev = np.deg2rad(table[rng.randint(0, 40, n)] + rng.uniform(-0.12, 0.12, n))
    r = 12.0
    pts = np.stack([r * np.cos(elev) * np.cos(az), r * np.sin(elev),
                    r * np.cos(elev) * np.sin(az)], -1).astype(np.float32)[:, [2, 0, 1]].copy()
    xyz, mask, rel = tbin.bin_sweep_table_native(pts, table, 512)
    assert mask.sum() > 3000
    got = xyz[mask]
    va = np.rad2deg(np.arctan2(got[:, 1], np.hypot(got[:, 0], got[:, 2])))
    np.testing.assert_array_equal(np.repeat(np.arange(40), mask.sum(1)), tsr.PANDAR40.ring(va))
    if jbin.table_supported():
        want = jbin.bin_sweep_table_native(pts, table, 512)
        np.testing.assert_array_equal(mask, want[1])
        # every point lies at range 12 m, so a cell's nearest point is often
        # a tie, which the binner's OpenMP threads settle in their own order
        # (in either build, run to run): those cells may hold either point
        tied = _range_ties(xyz, want[0], mask)
        np.testing.assert_array_equal(xyz[mask & ~tied], want[0][want[1] & ~tied])
        np.testing.assert_allclose(rel[mask & ~tied], want[2][want[1] & ~tied], atol=TOL)
        assert tied.sum() < 0.01 * mask.sum(), int(tied.sum())


# ---- native pager ---------------------------------------------------------------

def test_pager_flush_fetch_roundtrip(tmp_path):
    # tests/test_io.py::TestNativePager::test_flush_fetch_roundtrip on the port's build
    assert tpager.CubePager.available()
    pager = tpager.CubePager(str(tmp_path), n_threads=3)
    rng = np.random.RandomState(1)
    clouds = {k: rng.randn(10 + 7 * k, 3).astype(np.float32) for k in range(6)}
    for k, pts in clouds.items():
        pager.flush(0, (k, 0, 0), pts)
    pager.sync()
    for read in (tpcd.read_pcd, jpcd.read_pcd):     # both packages read its files
        np.testing.assert_allclose(read(str(tmp_path / "cube_0_2_0_0.pcd"))[0], clouds[2])
    tickets = {k: pager.prefetch(0, (k, 0, 0)) for k in clouds}
    for k, t in tickets.items():
        np.testing.assert_allclose(pager.fetch(t, 1024), clouds[k])
    assert pager.fetch(pager.prefetch(0, (99, 9, 9)), 16).shape == (0, 3)
    pager.flush(1, (0, 0, 0), rng.randn(50, 3).astype(np.float32))
    pager.sync()
    assert pager.fetch(pager.prefetch(1, (0, 0, 0)), 20).shape == (20, 3)
    with pytest.raises(KeyError):
        pager.fetch(12345, 4)
    pager.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pager_reads_both_packages_pcd(tmp_path, writer):
    # TestNativePager::test_python_pcd_reads_native_and_vice_versa, both writers
    pager = tpager.CubePager(str(tmp_path))
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    write = tpcd.write_pcd if writer == "port" else jpcd.write_pcd
    write(str(tmp_path / "cube_0_5_5_5.pcd"), pts, intensity=np.ones(10, np.float32))
    np.testing.assert_allclose(pager.fetch(pager.prefetch(0, (5, 5, 5)), 64), pts)
    pager.close()


# ---- tracing ---------------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        torch.cdist(torch.randn(64, 3), torch.randn(128, 3)).topk(5, largest=False)
    with profiling.trace(d):
        torch.zeros(4).sum()
    files = sorted(os.listdir(d))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    with open(os.path.join(d, files[0])) as f:
        text = f.read()
    assert "traceEvents" in text and "cdist" in text
