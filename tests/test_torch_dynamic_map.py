"""Port vs JAX package: the out-of-core cube map (``maps/dynamic_map``) and
``SlamPipeline`` with ``matcher.dynamic_mode``.

tests/test_io.py's TestDynamicMap (page out and back, native vs numpy
pager, no paging without a crossing), each held to the JAX package on the
same points with both pagers: the counts, the ``on_disk`` keys and the
surround points equal (as sorted sets, within 1e-6), the ``index2.txt``
manifest byte-identical and every cube file holding the same points.

Then a dynamic-mode pipeline drive at tests/test_long_run.py's ``_cfg``
map (5 x 3 x 5 cubes of 8 m, margin 1) and 16 x 512 sweeps against the JAX
pipeline (its features extracted op by op, tests/torch_pipeline_drives.py
says why): poses within 2e-3 (the tolerance between NN paths), the same
flush and load counts and the same files.  To page out and back within
nine sweeps (~50 s per package on one thread), the drive starts mid-room
(world z = 0) with a start pose that turns the map frame so the corridor
runs along the map's y axis: there the window holds 3 cubes and the 1-cube
margin leaves the sensor one cube, so the window shifts at every y cube
crossing.  The sensor moves 0.5 m per sweep, crosses map y = 4 at sweep 2
(flushing the layer 8-16 m behind it), turns on a cosine ramp and crosses
back at sweep 6 (reloading it).  Last, dynamic equals static on the port up
to the reload (the JAX package's TestDynamicEqualsStatic: within 1e-5).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import native_pager as jpager  # noqa: E402
from cooper_mapper_tpu.io import pcd as jpcd  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.maps import dynamic_map as jdyn  # noqa: E402
from cooper_mapper_tpu.models import pipeline as jpipe  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.io import native_pager as tpager  # noqa: E402
from cooper_mapper_torch.io import pcd as tpcd  # noqa: E402
from cooper_mapper_torch.maps import dynamic_map as tdyn  # noqa: E402
from cooper_mapper_torch.models import pipeline as tpipe  # noqa: E402
from cooper_mapper_torch.utils import cloud as tcloud  # noqa: E402
from tests import torch_pipeline_drives as D  # noqa: E402

TOL = 1e-6

# tests/test_io.py's map
def _map_cfg(m):
    return m.MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=256,
                       surf_cube_capacity=512, surround_corner_capacity=2048,
                       surround_surf_capacity=4096, valid_distance=25.0)


def _maps(tmp_path, use_native):
    if use_native and not jpager.CubePager.available():
        pytest.skip("the JAX package's libcube_pager.so is not built")
    t = tdyn.DynamicFeatureMap.create(_map_cfg(tc), str(tmp_path / "port"),
                                      use_native_pager=use_native, device="cpu")
    j = jdyn.DynamicFeatureMap.create(_map_cfg(jc), str(tmp_path / "jax"),
                                      use_native_pager=use_native)
    assert (t.pager is not None) == use_native
    return t, j


def _add(t, j, pts):
    pts = np.asarray(pts, np.float32)
    t.add_feature_cloud(tcloud.from_points(pts, device="cpu"), tcloud.from_points(pts,
                                                                                 device="cpu"))
    j.add_feature_cloud(jcloud.from_points(jnp.asarray(pts)), jcloud.from_points(jnp.asarray(pts)))


def _sorted(xyz):
    return xyz[np.lexsort(xyz.T)]


def _check_same(t, j, pos):
    """Counts, ledger and counters equal; the surround at ``pos`` the same
    points."""
    for ct, cj in ((t.state.corner, j.state.corner), (t.state.surf, j.state.surf)):
        np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
    np.testing.assert_array_equal(t.state.origin.numpy(), np.asarray(j.state.origin))
    assert t.on_disk == j.on_disk
    assert (t.n_flushed, t.n_loaded) == (j.n_flushed, j.n_loaded)
    for st, sj in zip(t.get_surround(np.asarray(pos, np.float32)),
                      j.get_surround(np.asarray(pos, np.float32))):
        a = _sorted(st.xyz.numpy()[st.mask.numpy()])
        b = _sorted(np.asarray(sj.xyz)[np.asarray(sj.mask)])
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def _check_files(t_dir, j_dir):
    """The manifest byte-identical, the same cube files, each holding the
    same points (both packages' readers)."""
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    with open(os.path.join(t_dir, "index2.txt"), "rb") as a, \
            open(os.path.join(j_dir, "index2.txt"), "rb") as b:
        assert a.read() == b.read()
    for name in os.listdir(t_dir):
        if name.endswith(".pcd"):
            a = tpcd.read_pcd(os.path.join(t_dir, name))[0]
            b = jpcd.read_pcd(os.path.join(j_dir, name))[0]
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [False, True])
def test_page_out_and_back_matches_jax(tmp_path, use_native):
    # TestDynamicMap::test_page_out_and_back
    t, j = _maps(tmp_path, use_native)
    _add(t, j, [[0.0, 0, 0], [3.0, 1.0, 2.0]])
    for pos in ([200.0, 0.0, 0.0], [0.0, 0.0, 0.0]):
        t.page(np.array(pos))
        j.page(np.array(pos))
        _check_same(t, j, pos)
    assert len(t.on_disk) > 0 and t.n_loaded > 0
    corner, _ = t.get_surround(np.zeros(3))
    assert int(corner.mask.sum()) == 2
    t.save()
    j.save()
    _check_files(t.directory, j.directory)


@pytest.mark.parametrize("use_native", [False, True])
def test_wander_matches_jax(tmp_path, use_native):
    # TestDynamicMap::test_native_matches_python_paging: out, further, back
    rng = np.random.RandomState(3)
    pts = rng.uniform(-12, 12, (40, 3)).astype(np.float32)
    t, j = _maps(tmp_path, use_native)
    _add(t, j, pts)
    for pos in ([60.0, 0, 0], [120.0, 0, 0], [0.0, 0, 0]):
        t.page(np.array(pos, np.float64))
        j.page(np.array(pos, np.float64))
        _check_same(t, j, pos)
    t.save()
    j.save()
    _check_files(t.directory, j.directory)
    corner, _ = t.get_surround(np.zeros(3))
    # every original point survived the round trip
    np.testing.assert_allclose(_sorted(corner.xyz.numpy()[corner.mask.numpy()]), _sorted(pts),
                               atol=1e-5)


def test_native_pager_equals_numpy_pager(tmp_path):
    """The port's two pagers: the same surround after the wander, and the
    same files."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-12, 12, (40, 3)).astype(np.float32)
    maps = []
    for use_native in (False, True):
        d = tdyn.DynamicFeatureMap.create(_map_cfg(tc), str(tmp_path / str(use_native)),
                                          use_native_pager=use_native, device="cpu")
        d.add_feature_cloud(tcloud.from_points(pts, device="cpu"),
                            tcloud.from_points(pts, device="cpu"))
        for pos in ([60.0, 0, 0], [120.0, 0, 0], [0.0, 0, 0]):
            d.page(np.array(pos))
        d.save()
        maps.append(d)
    a, b = (m.get_surround(np.zeros(3))[0] for m in maps)
    np.testing.assert_allclose(_sorted(a.xyz.numpy()[a.mask.numpy()]),
                               _sorted(b.xyz.numpy()[b.mask.numpy()]), atol=TOL)
    _check_files(maps[0].directory, maps[1].directory)


def test_page_without_crossing_is_noop(tmp_path):
    # TestDynamicMap::test_page_without_crossing_is_noop
    t, j = _maps(tmp_path, False)
    _add(t, j, [[1.0, 1.0, 1.0]])
    for pos in ([0.0, 0, 0], [1.0, 0, 0]):
        t.page(np.array(pos))
        j.page(np.array(pos))
        _check_same(t, j, pos)
    assert len(t.on_disk) == 0 and int(t.state.corner.count.sum()) == 1


def test_default_pager_is_native(tmp_path, monkeypatch):
    assert tpager.CubePager.available()
    d = tdyn.DynamicFeatureMap.create(_map_cfg(tc), str(tmp_path / "a"), device="cpu")
    assert isinstance(d.pager, tpager.CubePager)
    monkeypatch.setenv("COOPER_NATIVE_PAGER", "0")
    assert tdyn.DynamicFeatureMap.create(_map_cfg(tc), str(tmp_path / "b"),
                                         device="cpu").pager is None


def test_manifest_is_read_back(tmp_path):
    """A map directory with an ``index2.txt`` resumes its ledger, and the
    cubes on disk load when the window reaches them."""
    t, j = _maps(tmp_path, False)
    _add(t, j, [[0.0, 0, 0], [3.0, 1.0, 2.0]])
    t.page(np.array([200.0, 0.0, 0.0]))
    t2 = tdyn.DynamicFeatureMap.create(_map_cfg(tc), t.directory, device="cpu",
                                       use_native_pager=False)
    assert t2.on_disk == t.on_disk
    t2.page(np.array([200.0, 0.0, 0.0]))
    t2.page(np.array([0.0, 0.0, 0.0]))
    assert int(t2.get_surround(np.zeros(3))[0].mask.sum()) == 2


# ---- the dynamic-mode pipeline -------------------------------------------------

N_SWEEPS, SPEED, RAMP, N_OUT = 9, 0.5, 2, 4


def _drive_cfg(m, d, dynamic=True):
    """tests/test_long_run.py::_cfg."""
    return m.PipelineConfig(
        registration=m.RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=m.ScanMatchConfig(score_threshold=50.0),
        feature_map=m.MapConfig(n_cubes=(5, 3, 5), cube_size=8.0, corner_cube_capacity=768,
                                surf_cube_capacity=1536, surround_corner_capacity=6144,
                                surround_surf_capacity=12288, valid_distance=24.0,
                                margin_cubes=1),
        matcher=m.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096,
                                dynamic_mode=dynamic, map_directory=d, dedup_stride=1),
        mapping_stride=2)


def _simulate():
    """_corridor_run's room and motion, started mid-room and shortened:
    N_OUT sweeps out at SPEED, a cosine turn over 2 RAMP sweeps, then back.
    Returns (sweeps, the start pose in the map frame).  The map frame is the
    world turned -90 deg about x (world z -> map y) and shifted 2.9 m along
    map y, so the first map solve pages at map y = 3.9 and the second at 4.4."""
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=11)
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    for i in range(N_SWEEPS):
        if N_OUT - RAMP <= i < N_OUT + RAMP:
            v = SPEED * float(np.cos(np.pi * (i - (N_OUT - RAMP)) / (2.0 * RAMP)))
        else:
            v = SPEED if i < N_OUT else -SPEED
        step = np.eye(4, dtype=np.float32)
        step[2, 3] = v
        poses.append(poses[-1] @ step)
    sweeps = [jsim.scan_sweep(world, jnp.asarray(poses[i]), jnp.asarray(poses[i + 1]),
                              n_rings=16, width=512) for i in range(N_SWEEPS)]
    to_map = np.array([[1, 0, 0, 0], [0, 0, 1, 2.9], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    return sweeps, (to_map @ poses[1]).astype(np.float32)


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    sweeps, start = _simulate()
    out = {}
    for name in ("port", "jax"):
        d = str(tmp_path_factory.mktemp(name))
        if name == "port":
            pipe = tpipe.SlamPipeline(_drive_cfg(tc, d), "mapping", initial_pose=start,
                                      device="cpu")
            results = [pipe.process(bridge.sweep(s, "cpu")) for s in sweeps]
        else:
            pipe = jpipe.SlamPipeline(_drive_cfg(jc, d), "mapping", initial_pose=start)
            with D.op_by_op_extraction():
                results = [pipe.process(s) for s in sweeps]
        pipe.save_map()
        out[name] = (pipe, results, d)
    return sweeps, start, out


def test_dynamic_drive_matches_jax(drives):
    _, _, out = drives
    (tp, tr, _), (jp, jr, _) = out["port"], out["jax"]
    D.check_results(tr, jr)
    assert tp.timer.calls["paging"] == jp.timer.calls["paging"] == 5
    # paged out at the first crossing and back in at the return
    assert tp.dmap.n_flushed >= 2 and tp.dmap.n_loaded >= 1
    assert (tp.dmap.n_flushed, tp.dmap.n_loaded) == (jp.dmap.n_flushed, jp.dmap.n_loaded)
    assert tp.dmap.on_disk == jp.dmap.on_disk
    np.testing.assert_array_equal(tp.map_state.origin.numpy(), np.asarray(jp.map_state.origin))


def test_dynamic_drive_files_match_jax(drives):
    """save_map() wrote the same manifest and cube files; each file holds
    the same number of points to 0.5%, and 99% of its points have a
    counterpart within 1e-4 m in the JAX package's file (the maps are built
    at poses ~1e-6 apart, so a voxel's centroid may take another member)."""
    _, _, out = drives
    t_dir, j_dir = out["port"][2], out["jax"][2]
    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir)) and "index2.txt" in names
    with open(os.path.join(t_dir, "index2.txt"), "rb") as a, \
            open(os.path.join(j_dir, "index2.txt"), "rb") as b:
        assert a.read() == b.read()
    for name in names:
        if name.endswith(".pcd"):
            a = tpcd.read_pcd(os.path.join(t_dir, name))[0]
            b = jpcd.read_pcd(os.path.join(j_dir, name))[0]
            assert abs(len(a) - len(b)) <= 0.005 * len(b) + 1, name
            if len(b):
                gap = np.abs(a[:, None, :] - b[None, :, :]).max(-1).min(-1)
                assert np.mean(gap <= 1e-4) >= 0.99, (name, np.mean(gap <= 1e-4))


def test_dynamic_equals_static_until_the_reload(drives):
    """TestDynamicEqualsStatic on the port: up to the sweep before the
    first reload, paging only saves the leaving cubes, so the poses equal a
    static map's (within the JAX test's 1e-5)."""
    sweeps, start, out = drives
    n = 6                                   # sweep 6's page reloads
    static = tpipe.SlamPipeline(_drive_cfg(tc, "", dynamic=False), "mapping",
                                initial_pose=start, device="cpu")
    got = [static.process(bridge.sweep(s, "cpu")).merged_pose for s in sweeps[:n]]
    want = [r.merged_pose for r in out["port"][1][:n]]
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5)
