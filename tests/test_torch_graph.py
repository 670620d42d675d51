"""Port vs JAX package: the pose-graph backend's host logic and persistence
(``models/graph``, ``io/pcd``, ``io/map_io``, ``maps/feature_map.
slot_world_index``, ``utils/cloud.concat``) and the simulator's ``noise``.

The scripted drive: five JAX-simulated 16 x 512 sweeps at poses that leave
the start and come back to it, odometry with a drift per step (as
tests/test_pose_graph.py::TestGraphSlamLoop), the JAX package's
less-sharp / less-flat clouds as keyframe clouds (bridged for the port),
so both ``GraphSlam``s see the same keyframes.  Tolerances: the gates and
candidate lists equal; the loop's relative pose within 2e-3 (a
scan-to-map solve, tests/test_odometry.py's tolerance between NN paths);
graph estimates, ``T_odom2graph`` and the saved .g2o numbers within 1e-3
(the LM, tests/test_torch_pose_graph.py's tolerance); rebuilt maps' counts
equal and points within 1e-4 m when both rebuild from the same estimates;
the saved maps, which each package rebuilds from its own estimates, hold
the same cubes and as many points; files that hold the same numbers are
byte-equal.  The noise is compared in distribution only: the port draws
from a ``torch.Generator``, the JAX package from ``jax.random``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import map_io as jmap_io  # noqa: E402
from cooper_mapper_tpu.io import pcd as jpcd  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.maps import feature_map as jfm  # noqa: E402
from cooper_mapper_tpu.models import graph as jgraph  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.io import map_io as tmap_io  # noqa: E402
from cooper_mapper_torch.io import pcd as tpcd  # noqa: E402
from cooper_mapper_torch.io import sim as tsim  # noqa: E402
from cooper_mapper_torch.maps import feature_map as tfm  # noqa: E402
from cooper_mapper_torch.models import graph as tgraph  # noqa: E402
from cooper_mapper_torch.utils import cloud as tcloud  # noqa: E402

LOOP_TOL = 2e-3
GRAPH_TOL = 1e-3
MAP_TOL = 1e-4


def _map_cfg(m):
    """tests/test_pose_graph.py::TestGraphSave's map."""
    return m.MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=512,
                       surf_cube_capacity=512, surround_corner_capacity=1024,
                       surround_surf_capacity=1024, valid_distance=20.0)


def _slam(m, package):
    return package.GraphSlam(
        kf_cfg=m.KeyframeConfig(),
        loop_cfg=m.LoopConfig(distance_thresh=3.0, estimated_distance_thresh=9.0,
                              accum_distance_thresh=1.0, min_loop_interval=0.5),
        pg_cfg=m.PoseGraphConfig(max_nodes=64, max_edges=128),
        sm_cfg=m.ScanMatchConfig(score_threshold=30.0, match_percentage_threshold=0.2),
        **({} if package is jgraph else {"device": "cpu"}))


def _pose(x, z, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s, x], [0, 1, 0, 1.5], [-s, 0, c, z], [0, 0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=3)
    reg = jc.RegistrationConfig(n_rings=16, max_points_per_ring=512, max_less_flat=2048)
    gt = [_pose(0.0, 0.0, 0.0), _pose(1.2, 0.0, 0.1), _pose(2.4, 0.5, 0.3),
          _pose(1.2, 1.0, 0.2), _pose(0.2, 0.3, 0.05)]
    drift = np.asarray(jse3.se3_exp(jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.004, 0.0],
                                                jnp.float32)))
    frames, odom = [], gt[0].copy()
    for i, T in enumerate(gt):
        sweep = jsim.scan_sweep(world, jnp.asarray(T), jnp.asarray(T), n_rings=16, width=512,
                                distortion=False)
        fc = jfeat.extract_features(sweep, reg)
        if i:
            odom = (odom @ np.linalg.inv(gt[i - 1]) @ T @ drift).astype(np.float32)
        frames.append((float(i), odom.copy(), fc.less_sharp, fc.less_flat))
    js, ts = _slam(jc, jgraph), _slam(tc, tgraph)
    out = {"jax": js, "port": ts, "gates": []}
    for stamp, pose, corner, surf in frames:
        jk = js.add_frame(stamp, pose, corner, surf)
        tk = ts.add_frame(stamp, pose, bridge.cloud(corner, "cpu"), bridge.cloud(surf, "cpu"))
        jl = js.detect_and_optimize() if jk else None
        tl = ts.detect_and_optimize() if tk else None
        out["gates"].append(((jk, jl is not None), (tk, tl is not None)))
    jmap, tmap = _map_cfg(jc), _map_cfg(tc)
    # rebuild_map from the same estimates (the JAX package's), so that the
    # maps differ only by what rebuild_map does
    own = ts._node_poses
    ts._node_poses = [p.copy() for p in js.estimates()]
    out["rebuilt"] = {
        "plain": (js.rebuild_map(jmap), ts.rebuild_map(tmap)),
        "registered": (js.rebuild_map(jmap, jc.ScanMatchConfig()),
                       ts.rebuild_map(tmap, tc.ScanMatchConfig())),
    }
    ts._node_poses = own
    out["dirs"] = {}
    for name, slam, cfg in (("jax", js, jmap), ("port", ts, tmap)):
        d = str(tmp_path_factory.mktemp(f"graph_{name}"))
        slam.save(d, map_cfg=cfg)
        out["dirs"][name] = d
    return out


def test_scripted_drive_closes_the_same_loop(scripted):
    js, ts = scripted["jax"], scripted["port"]
    for jg, tg in scripted["gates"]:
        assert jg == tg
    assert len(js.loops) >= 1, "the scripted drive must close a loop in the JAX package"
    assert [(lp.key_new, lp.key_old) for lp in ts.loops] == \
        [(lp.key_new, lp.key_old) for lp in js.loops]
    for tl, jl in zip(ts.loops, js.loops):
        np.testing.assert_allclose(tl.relative, jl.relative, atol=LOOP_TOL)
    assert ts.n_edges == js.n_edges
    for (ti, tj, tT, tinfo), (ji, jj, jT, jinfo) in zip(ts.edges_list(), js.edges_list()):
        assert (ti, tj) == (ji, jj)
        np.testing.assert_allclose(tT, jT, atol=LOOP_TOL)
        np.testing.assert_array_equal(tinfo, jinfo)


def test_scripted_drive_graph_matches_jax(scripted):
    js, ts = scripted["jax"], scripted["port"]
    assert len(ts.keyframes) == len(js.keyframes)
    for tk, jk in zip(ts.keyframes, js.keyframes):
        assert tk.stamp == jk.stamp and tk.accum_distance == jk.accum_distance
        np.testing.assert_array_equal(tk.odom, jk.odom)
    np.testing.assert_allclose(ts.estimates(), js.estimates(), atol=GRAPH_TOL)
    np.testing.assert_allclose(ts.T_odom2graph, js.T_odom2graph, atol=GRAPH_TOL)
    assert np.linalg.norm(ts.T_odom2graph - np.eye(4)) > 1e-6
    for f in dataclasses.fields(tgraph.pg.PoseGraph):
        np.testing.assert_allclose(getattr(ts.graph, f.name).numpy().astype(np.float32),
                                   np.asarray(getattr(js.graph, f.name)).astype(np.float32),
                                   atol=GRAPH_TOL, err_msg=f.name)


@pytest.mark.parametrize("kind", ["plain", "registered"])
def test_rebuild_map_matches_jax(scripted, kind):
    jm, tm = scripted["rebuilt"][kind]
    for tcc, jcc in ((tm.corner, jm.corner), (tm.surf, jm.surf)):
        np.testing.assert_array_equal(tcc.count.numpy(), np.asarray(jcc.count))
        mask = np.asarray(jcc.mask)
        np.testing.assert_array_equal(tcc.mask.numpy(), mask)
        np.testing.assert_allclose(tcc.xyz.numpy()[mask], np.asarray(jcc.xyz)[mask], atol=MAP_TOL)
    assert int(np.asarray(jm.surf.count).sum()) > 0


def _g2o_numbers(path):
    with open(path) as f:
        rows = [ln.split() for ln in f]
    return [r[0] for r in rows], [r[1:] for r in rows]


def test_save_writes_the_jax_files(scripted):
    jd, td = scripted["dirs"]["jax"], scripted["dirs"]["port"]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for name in ("before.g2o", "after.g2o"):
        jk, jv = _g2o_numbers(os.path.join(jd, name))
        tk, tv = _g2o_numbers(os.path.join(td, name))
        assert tk == jk
        for a, b in zip(tv, jv):
            assert a[:2] == b[:2] if a[0].startswith("EDGE") else a[0] == b[0]
            np.testing.assert_allclose(np.array(a, float), np.array(b, float), atol=GRAPH_TOL)
    with open(os.path.join(td, "odom_traj.pcd"), "rb") as a, \
            open(os.path.join(jd, "odom_traj.pcd"), "rb") as b:
        assert a.read() == b.read()
    tg, ti = tpcd.read_pcd(os.path.join(td, "graph_traj.pcd"))
    jg, ji = jpcd.read_pcd(os.path.join(jd, "graph_traj.pcd"))
    np.testing.assert_allclose(tg, jg, atol=GRAPH_TOL)
    np.testing.assert_array_equal(ti, ji)
    # the saved map, rebuilt from each package's own estimates: the same
    # cubes and the same number of points; a point within ~1e-4 m of a cube
    # face may land in the cube next door, so each cube's count may differ
    # by a point or two
    listing = [sorted(os.listdir(os.path.join(d, "map"))) for d in (td, jd)]
    assert listing[0] == listing[1]
    rows = [np.loadtxt(os.path.join(d, "map", "index.txt"), ndmin=2) for d in (td, jd)]
    np.testing.assert_array_equal(rows[0][:, 1:], rows[1][:, 1:])
    assert rows[0][:, 0].sum() == rows[1][:, 0].sum()
    assert np.abs(rows[0][:, 0] - rows[1][:, 0]).max() <= 2


def test_g2o_round_trip_matches_jax(tmp_path):
    """tests/test_io.py::TestMapPersistence::test_g2o_roundtrip in both
    packages: byte-equal files, equal loads."""
    rng = np.random.RandomState(0)
    poses, T = [], np.eye(4, dtype=np.float32)
    for _ in range(5):
        T = T @ np.asarray(jse3.se3_exp(jnp.asarray(0.2 * rng.randn(6), jnp.float32)))
        poses.append(T)
    poses = np.stack(poses)
    edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1], np.full(6, 0.5 + i, np.float32))
             for i in range(4)]
    tmap_io.save_g2o(str(tmp_path / "t.g2o"), poses, edges)
    jmap_io.save_g2o(str(tmp_path / "j.g2o"), poses, edges)
    assert (tmp_path / "t.g2o").read_bytes() == (tmp_path / "j.g2o").read_bytes()
    tp, te = tmap_io.load_g2o(str(tmp_path / "j.g2o"))
    jp, je = jmap_io.load_g2o(str(tmp_path / "j.g2o"))
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_allclose(tp, poses, atol=1e-5)
    for (ti, tj, tT, tinfo), (ji, jj, jT, jinfo) in zip(te, je):
        assert (ti, tj) == (ji, jj)
        np.testing.assert_allclose(tT, jT, atol=1e-6)
        np.testing.assert_array_equal(tinfo, jinfo)
    tmap_io.save_trajectory_pcd(str(tmp_path / "t.pcd"), poses)
    jmap_io.save_trajectory_pcd(str(tmp_path / "j.pcd"), poses)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("intensity", [True, False])
def test_pcd_files_byte_equal(tmp_path, binary, intensity):
    rng = np.random.RandomState(0)
    xyz = rng.randn(100, 3).astype(np.float32)
    inten = np.arange(100, dtype=np.float32) if intensity else None
    tpcd.write_pcd(str(tmp_path / "t.pcd"), xyz, inten, binary=binary)
    jpcd.write_pcd(str(tmp_path / "j.pcd"), xyz, inten, binary=binary)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    txyz, tint = tpcd.read_pcd(str(tmp_path / "j.pcd"))
    jxyz, jint = jpcd.read_pcd(str(tmp_path / "j.pcd"))
    np.testing.assert_array_equal(txyz, jxyz)
    assert (tint is None) == (jint is None)
    if intensity:
        np.testing.assert_array_equal(tint, jint)


MAP_CFG_IO = dict(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=256,
                  surf_cube_capacity=512, surround_corner_capacity=2048,
                  surround_surf_capacity=4096, valid_distance=25.0)


def test_feature_map_save_load_matches_jax(tmp_path):
    """tests/test_io.py::TestMapPersistence::test_save_load_roundtrip in both
    packages, with more points: the same files, and each package loads the
    other's into the same map."""
    jcfg, tcfg = jc.MapConfig(**MAP_CFG_IO), tc.MapConfig(**MAP_CFG_IO)
    rng = np.random.RandomState(4)
    pts = np.concatenate([[[0.0, 0, 0], [1.0, 0.5, 0], [12.0, 0, 3.0]],
                          rng.uniform(-20, 20, (300, 3))]).astype(np.float32)
    jstate = jfm.add_feature_cloud(jfm.create(jcfg), jcloud.from_points(jnp.asarray(pts[:200])),
                                   jcloud.from_points(jnp.asarray(pts[100:])), jcfg)
    tstate = tfm.add_feature_cloud(tfm.create(tcfg, "cpu"),
                                   tcloud.from_points(pts[:200], device="cpu"),
                                   tcloud.from_points(pts[100:], device="cpu"), tcfg)
    jd, td = tmp_path / "j", tmp_path / "t"
    n_j = jmap_io.save_feature_map(jstate, jcfg, str(jd))
    n_t = tmap_io.save_feature_map(tstate, tcfg, str(td))
    assert n_t == n_j >= 2
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for name in os.listdir(jd):
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    tl = tmap_io.load_feature_map(str(jd), tcfg, device="cpu")
    jl = jmap_io.load_feature_map(str(jd), jcfg)
    np.testing.assert_array_equal(tl.origin.numpy(), np.asarray(jl.origin))
    for tcc, jcc in ((tl.corner, jl.corner), (tl.surf, jl.surf)):
        np.testing.assert_array_equal(tcc.count.numpy(), np.asarray(jcc.count))
        np.testing.assert_array_equal(tcc.xyz.numpy(), np.asarray(jcc.xyz))
    corner, _ = tfm.get_surround(tl, torch.zeros(3), tcfg)
    got = np.sort(corner.xyz[corner.mask].numpy()[:, 0])
    assert {0.0, 1.0, 12.0} <= set(np.round(got, 5).tolist())


def test_index_convert_matches_jax(tmp_path):
    src = tmp_path / "index.txt"
    src.write_text("10 0 1 2 3 50.0\n7 1 -4 0 2 10.0\nbad line\n")
    tmap_io.index_convert(str(src), str(tmp_path / "t.txt"), (5, -1, 0))
    jmap_io.index_convert(str(src), str(tmp_path / "j.txt"), (5, -1, 0))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


@pytest.mark.parametrize("origin", [(0, 0, 0), (-10, -5, -10), (7, -3, 22)])
def test_slot_world_index_matches_jax(origin):
    got = tfm.slot_world_index(np.array(origin, np.int32), (21, 11, 21))
    np.testing.assert_array_equal(got, jfm.slot_world_index(np.array(origin, np.int32),
                                                            (21, 11, 21)))


def _candidate_frames(package, loop_cfg, accums):
    det = package.LoopDetector(loop_cfg, tc.ScanMatchConfig())
    dummy = tcloud.empty(8, "cpu")
    return det, [package.Keyframe(0.0, np.eye(4, dtype=np.float32), dummy, dummy, a)
                 for a in accums]


@pytest.mark.parametrize("case", ["estimated_distance", "y_flattened", "random"])
def test_find_candidates_matches_jax(case):
    """TestLoopCandidateGates' cases, and a random trajectory with every gate
    active, in both packages."""
    if case == "estimated_distance":
        kw = dict(distance_thresh=50.0, estimated_distance_thresh=25.0,
                  accum_distance_thresh=10.0, min_loop_interval=0.0)
        accums = [0.0, 1.0, 100.0]
        pos = [[4.0, 0, 0], [6.0, 0, 0], [0, 0, 0]]
    elif case == "y_flattened":
        kw = dict(distance_thresh=5.0, estimated_distance_thresh=25.0,
                  accum_distance_thresh=10.0, min_loop_interval=0.0)
        accums = [0.0, 100.0]
        pos = [[1.0, 40.0, 0.0], [0, 0, 0]]
    else:
        kw = dict(distance_thresh=4.0, estimated_distance_thresh=12.0,
                  accum_distance_thresh=3.0, min_loop_interval=1.0, max_candidates=3,
                  candidate_cluster_dist=2.0)
        rng = np.random.RandomState(9)
        accums = np.cumsum(rng.uniform(0.2, 1.0, 40)).tolist()
        pos = rng.uniform(-4, 4, (40, 3)).tolist()
    est = np.stack([np.eye(4, dtype=np.float32)] * len(pos))
    est[:, :3, 3] = pos
    results = []
    for package, m in ((jgraph, jc), (tgraph, tc)):
        det, kfs = _candidate_frames(package, m.LoopConfig(**kw), accums)
        got = []
        for new in range(1, len(kfs)):
            got.append(det.find_candidates(kfs, est.copy(), new))
            if got[-1] and case == "random":
                det.last_loop_distance = kfs[new].accum_distance
        results.append(got)
    assert results[1] == results[0]
    assert any(results[0])
    if case == "estimated_distance":
        assert results[1][-1] == [0]


def test_keyframe_updater_matches_jax():
    rng = np.random.RandomState(2)
    ju = jgraph.KeyframeUpdater(jc.KeyframeConfig())
    tu = tgraph.KeyframeUpdater(tc.KeyframeConfig())
    pose = np.eye(4, dtype=np.float32)
    gates = []
    for _ in range(60):
        step = np.asarray(jse3.se3_exp(jnp.asarray(
            rng.uniform(-1, 1, 6) * [0.3, 0.05, 0.3, 0.02, 0.06, 0.02], jnp.float32)))
        pose = (pose @ step).astype(np.float32)
        gates.append((tu.update(pose), ju.update(pose)))
    assert all(a == b for a, b in gates)
    assert 5 < sum(a for a, _ in gates) < 60
    assert tu.accum == ju.accum


def test_concat_matches_jax():
    rng = np.random.RandomState(0)
    a = jcloud.make(jnp.asarray(rng.randn(5, 3).astype(np.float32)), jnp.asarray(rng.rand(5) > 0.5),
                    jnp.arange(5, dtype=jnp.int32), jnp.linspace(0, 1, 5))
    b = jcloud.from_points(jnp.asarray(rng.randn(3, 3).astype(np.float32)), capacity=4)
    want = jcloud.concat(a, b)
    got = tcloud.concat(bridge.cloud(a, "cpu"), bridge.cloud(b, "cpu"))
    for f in ("xyz", "mask", "ring", "rel_time"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def _sweep(noise, generator):
    world = tsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=3, device="cpu")
    pose = torch.eye(4)
    return tsim.scan_sweep(world, pose, pose, n_rings=16, width=512, distortion=False,
                           noise=noise, generator=generator)


def test_sim_noise_is_gaussian_of_the_given_sigma():
    """Over a 16 x 512 sweep: the offsets' mean within 3 sigma / sqrt(n) of 0
    on each axis and their standard deviation within 2% of ``noise``, for a
    fixed generator; the same generator seed gives the same sweep."""
    clean = _sweep(0.0, None)
    noisy = _sweep(0.03, torch.Generator().manual_seed(7))
    again = _sweep(0.03, torch.Generator().manual_seed(7))
    assert torch.equal(noisy.xyz, again.xyz)
    assert torch.equal(noisy.mask, clean.mask)
    off = (noisy.xyz - clean.xyz)[clean.mask].numpy().astype(np.float64)
    n = off.shape[0]
    assert n > 4000
    assert np.all(np.abs(off.mean(0)) < 3 * 0.03 / np.sqrt(n)), off.mean(0)
    np.testing.assert_allclose(off.std(0), 0.03, rtol=0.02)


def test_sim_without_noise_is_unchanged():
    clean = _sweep(0.0, None)
    for s in (_sweep(0.0, torch.Generator().manual_seed(1)), _sweep(0.03, None)):
        assert torch.equal(s.xyz, clean.xyz) and torch.equal(s.mask, clean.mask)
