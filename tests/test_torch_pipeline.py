"""Port vs JAX package: the pieces the pipeline adds to the earlier slices.

The voxel filter's ``keep_first``, the cube map's batched ``dedup_active``
(both policies), the sliding-window map (``maps/local_map``) and its mapping
step, ``io/evaluation``, ``utils/profiling``, ``utils/cloud.from_points``,
the simulator's figure-eight trajectory, and the ``map_mesh`` settings of
``SlamPipeline`` that raise.  The whole pipeline
drives are in tests/test_torch_pipeline_drive.py.

The JAX side of the voxel, cube-map and window tests runs op by op
(``jax.disable_jit()``): under ``jit`` XLA rewrites the voxel coordinate
``xyz / leaf`` as ``xyz * (1 / leaf)``, which rounds differently for points
that lie exactly on a voxel boundary, and the lattice clouds here put many
points there.  The port divides, as the code of both packages reads.

Tolerances: voxel and map points within 1e-4 m (the centroid sums are
ordered f32 sums in both packages and agree to ~1e-7 here), masks and
counts equal; the sliding-window state equal, its poses within 2e-3 (the
tolerance between NN paths in tests/test_odometry.py); ``io/evaluation``
bit for bit (it is numpy in both packages).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import evaluation as jev  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.maps import feature_map as jfm  # noqa: E402
from cooper_mapper_tpu.maps import local_map as jlmap  # noqa: E402
from cooper_mapper_tpu.models import laser_mapping as jlm  # noqa: E402
from cooper_mapper_tpu.models import pipeline as jpipe  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_tpu.ops import voxel as jvox  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.io import evaluation as tev  # noqa: E402
from cooper_mapper_torch.io import sim as tsim  # noqa: E402
from cooper_mapper_torch.maps import feature_map as tfm  # noqa: E402
from cooper_mapper_torch.maps import local_map as tlmap  # noqa: E402
from cooper_mapper_torch.models import laser_mapping as tlm  # noqa: E402
from cooper_mapper_torch.models.pipeline import SlamPipeline  # noqa: E402
from cooper_mapper_torch.ops import voxel as tvox  # noqa: E402
from cooper_mapper_torch.utils import cloud as tcloud  # noqa: E402
from cooper_mapper_torch.utils import profiling  # noqa: E402

POINT_TOL, POSE_TOL = 1e-4, 2e-3


def _clouds_equal(t, j, tol=POINT_TOL):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=0, atol=tol)


def _dup_cloud(rng, n, lo, hi, grid=0.1, valid=0.9):
    """Points on a 0.1 m lattice (many per voxel, exact duplicates too) with
    invalid points mixed in."""
    xyz = (np.round(rng.uniform(lo, hi, (n, 3)) / grid) * grid).astype(np.float32)
    mask = rng.rand(n) < valid
    xyz[~mask] = jcloud.FAR
    return xyz, mask


# ---- ops/voxel keep_first --------------------------------------------------

@pytest.mark.parametrize("keep_first", [False, True])
@pytest.mark.parametrize("leaf,capacity", [(0.2, None), (0.4, 300)])
def test_voxel_downsample_matches_jax(keep_first, leaf, capacity):
    rng = np.random.RandomState(0)
    xyz, mask = _dup_cloud(rng, 2000, -2.0, 2.0)
    ring = rng.randint(0, 16, 2000).astype(np.int32)
    rel = rng.rand(2000).astype(np.float32)
    want = jvox.voxel_downsample(jcloud.make(xyz, mask, ring, rel), leaf, capacity,
                                 keep_first=keep_first)
    got = tvox.voxel_downsample(tcloud.make(torch.from_numpy(xyz), torch.from_numpy(mask),
                                            torch.from_numpy(ring), torch.from_numpy(rel)),
                                leaf, capacity, keep_first=keep_first)
    _clouds_equal(got, want)
    np.testing.assert_array_equal(got.ring.numpy(), np.asarray(want.ring))
    np.testing.assert_array_equal(got.rel_time.numpy(), np.asarray(want.rel_time))
    if keep_first:
        # each output is an input point itself, bit for bit
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


# ---- maps/feature_map.dedup_active ------------------------------------------

def _map_cfg(m, policy, vfov=False):
    return m.MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, valid_distance=20.0,
                       corner_cube_capacity=256, surf_cube_capacity=512, margin_cubes=1,
                       dedup_policy=policy, surround_corner_capacity=4096,
                       surround_surf_capacity=8192,
                       vfov_up_deg=10.0 if vfov else 0.0, vfov_down_deg=10.0 if vfov else 0.0)


def _built_map(policy, vfov=False):
    """A JAX cube map after four inserts of overlapping lattice clouds that
    straddle cube boundaries, and its port."""
    cfg = _map_cfg(jc, policy, vfov)
    rng = np.random.RandomState(1)
    st = jfm.create(cfg)
    for _ in range(4):
        c = jcloud.make(*_dup_cloud(rng, 700, -12.0, 12.0, grid=0.15))
        s = jcloud.make(*_dup_cloud(rng, 1400, -12.0, 12.0, grid=0.15))
        st = jfm.add_feature_cloud(st, c, s, cfg)
    return st, cfg


def _maps_equal(t, j):
    np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))
    for ct, cj in ((t.corner, j.corner), (t.surf, j.surf)):
        np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        np.testing.assert_allclose(ct.xyz.numpy(), np.asarray(cj.xyz), rtol=0, atol=POINT_TOL)


@pytest.mark.parametrize("policy", ["centroid", "anchor"])
@pytest.mark.parametrize("sensor,vfov", [((0.0, 0.0, 0.0), False), ((13.0, 2.0, -9.0), False),
                                         ((0.0, 4.0, 0.0), True)])
def test_dedup_active_matches_jax(policy, sensor, vfov):
    # sensor (13, 2, -9): part of the neighbourhood lies outside the grid;
    # with the vertical-FOV cull some in-grid cubes are left out too
    st, cfg = _built_map(policy, vfov)
    tst = bridge.feature_map_state(st, "cpu")
    pos = np.array(sensor, np.float32)
    with jax.disable_jit():
        want = jfm.dedup_active(st, jnp.asarray(pos), cfg)
    got = tfm.dedup_active(tst, torch.from_numpy(pos), _map_cfg(tc, policy, vfov))
    assert got is tst                          # in place
    _maps_equal(got, want)
    # the pass removed points, and left the cubes outside the neighbourhood as they were
    assert int(want.surf.count.sum()) < int(st.surf.count.sum())
    if policy == "anchor":
        np.testing.assert_array_equal(got.surf.xyz.numpy(), np.asarray(want.surf.xyz))


def test_dedup_active_is_one_pass_per_feature_class(monkeypatch):
    st, cfg = _built_map("centroid")
    calls = []
    real = tfm.filter_sorted
    monkeypatch.setattr(tfm, "filter_sorted",
                        lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    tfm.dedup_active(bridge.feature_map_state(st, "cpu"), torch.zeros(3),
                     _map_cfg(tc, "centroid"))
    n_active = len(tfm._surround_offsets(_map_cfg(tc, "centroid")))
    assert calls == [n_active * 256, n_active * 512]


# ---- maps/local_map ---------------------------------------------------------

def _pose(yaw, t):
    return np.asarray(jse3.make_mat(jse3.rot_y(jnp.float32(yaw)), jnp.asarray(t, jnp.float32)))


def _local_states_equal(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_local_map_gating_eviction_and_surround_match_jax():
    rng = np.random.RandomState(2)
    js, ts = jlmap.create(4, 300, 600), tlmap.create(4, 300, 600, device="cpu")
    _local_states_equal(ts, js)
    # first frame, a small move (gated out), a 0.3 m move, a 0.06 rad turn,
    # then long moves: the ring wraps and frames older than 30 m are evicted
    poses = [_pose(0.0, [0, 0, 0]), _pose(0.0, [0.1, 0, 0]), _pose(0.0, [0.3, 0, 0]),
             _pose(0.06, [0.3, 0, 0]), _pose(0.06, [20.0, 0, 0]), _pose(0.06, [40.0, 0, 0]),
             _pose(0.06, [55.0, 0, 5.0])]
    accepted = []
    for P in poses:
        c = jcloud.make(*_dup_cloud(rng, 500, -5.0, 5.0))
        s = jcloud.make(*_dup_cloud(rng, 900, -5.0, 5.0))
        head = int(js.head)
        with jax.disable_jit():
            js = jlmap.add_frame(js, c, s, P)
        ts = tlmap.add_frame(ts, bridge.cloud(c, "cpu"), bridge.cloud(s, "cpu"),
                             torch.from_numpy(P.copy()))
        _local_states_equal(ts, js)
        accepted.append(int(js.head) != head)
    assert accepted == [True, False, True, True, True, True, True]
    assert not bool(js.frame_valid.all())         # eviction happened
    for cap_c, cap_s in ((1200, 2400), (512, 1024)):
        got = tlmap.get_surround(ts, cap_c, cap_s, 0.2, 0.4)
        with jax.disable_jit():
            want = jlmap.get_surround(js, cap_c, cap_s, 0.2, 0.4)
        for g, w in zip(got, want):
            _clouds_equal(g, w)


def test_mapping_local_step_matches_jax():
    """Two sliding-window mapping steps on a simulated drive (the first
    inserts into an empty window, the second solves against it)."""
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=21)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.35
    reg = jc.RegistrationConfig(n_rings=16, max_points_per_ring=512)
    mcfg = dict(max_frame_corner=1024, max_frame_surf=2048)
    sm = dict(score_threshold=50.0)
    js, ts = jlmap.create(8, 1024, 2048), tlmap.create(8, 1024, 2048, device="cpu")
    jm = jlm.create_matcher()
    tm = tlm.create_matcher("cpu")
    L = np.eye(4, dtype=np.float32)
    for i in range(2):
        sw = jsim.scan_sweep(world, jnp.asarray(p), jnp.asarray(p @ step), n_rings=16, width=512)
        p = p @ step
        fc, _ = jfeat._extract_impl(sw, reg)
        L = L @ step if i else L
        jm, js, jo = jlm.mapping_local_step(jm, js, fc.less_sharp, fc.less_flat, jnp.asarray(L),
                                            jc.ScanMatchConfig(**sm), jc.MatcherConfig(**mcfg),
                                            2048, 4096)
        tm, ts, to = tlm.mapping_local_step(tm, ts, bridge.cloud(fc.less_sharp, "cpu"),
                                            bridge.cloud(fc.less_flat, "cpu"),
                                            torch.from_numpy(L), tc.ScanMatchConfig(**sm),
                                            tc.MatcherConfig(**mcfg), 2048, 4096)
        assert bool(to.result.success) == bool(jo.result.success) == (i == 1)
        np.testing.assert_allclose(to.W.numpy(), np.asarray(jo.W), rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(tm.W_last.numpy(), np.asarray(jm.W_last), atol=POSE_TOL)
        np.testing.assert_array_equal(ts.frame_valid.numpy(), np.asarray(js.frame_valid))
        np.testing.assert_array_equal(ts.surf_mask.numpy(), np.asarray(js.surf_mask))
        np.testing.assert_allclose(ts.surf_xyz.numpy(), np.asarray(js.surf_xyz), rtol=0,
                                   atol=POINT_TOL + 5 * POSE_TOL)


def test_local_window_rejects_a_frame_of_another_capacity_as_jax():
    # At the default PipelineConfig the window holds max_frame_corner = 4096
    # corner slots per frame, but the corner frame has max_less_sharp = 2048
    # points: the JAX package's add_frame raises (it cannot set a [2048, 3]
    # frame into a [4096, 3] slot), and so does the port's.
    rng = np.random.RandomState(5)
    c = jcloud.make(*_dup_cloud(rng, 2048, -5.0, 5.0))
    s = jcloud.make(*_dup_cloud(rng, 8192, -5.0, 5.0))
    with pytest.raises(ValueError):
        jlmap.add_frame(jlmap.create(2, 4096, 8192), c, s, np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError):
        tlmap.add_frame(tlmap.create(2, 4096, 8192, device="cpu"), bridge.cloud(c, "cpu"),
                        bridge.cloud(s, "cpu"), torch.eye(4))


# ---- io/evaluation, utils/profiling, cloud.from_points, the simulator --------

def test_evaluation_equals_jax_bit_for_bit():
    rng = np.random.RandomState(3)
    est, gt = rng.randn(30, 3), rng.randn(30, 3)
    est[7] = [50.0, 0, 0]
    poses = np.stack([_pose(a, t) for a, t in zip(rng.uniform(-1, 1, 12), rng.randn(12, 3))])
    gt_poses = np.stack([_pose(a, t) for a, t in zip(rng.uniform(-1, 1, 13), rng.randn(13, 3))])
    stamps_e, stamps_g = np.sort(rng.uniform(0, 10, 30)), np.sort(rng.uniform(0, 10, 30))
    calls = [
        ("ate", (est, gt), {}), ("ate", (est, gt), {"align": True}),
        ("pipeline_ate", (poses, gt_poses), {}), ("pipeline_ate", (poses, gt_poses), {"align": False}),
        ("rpe", (poses, gt_poses[:12]), {}), ("rpe", (poses, gt_poses[:12]), {"delta": 3}),
        ("online_error", (est, gt), {}),
        ("online_error", (est, gt), {"est_stamp": stamps_e, "gt_stamp": stamps_g}),
        ("online_error", (est[:0], gt[:0]), {}),
    ]
    for name, args, kw in calls:
        a, b = getattr(tev, name)(*args, **kw), getattr(jev, name)(*args, **kw)
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=name)
    for scale in (False, True):
        for x, y in zip(tev.umeyama_alignment(est, gt, scale), jev.umeyama_alignment(est, gt, scale)):
            np.testing.assert_array_equal(x, y)


def test_stage_timer_accounts_stages():
    # tests/test_pipeline.py::test_stage_timer_accounts_stages, with a device as sync
    t = profiling.StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b", sync="cpu"):
        pass
    assert t.calls["a"] == 2 and t.calls["b"] == 1
    rep = t.report()
    assert "a" in rep and "ms/call" in rep and "steady" in rep
    t.reset()
    assert not t.calls
    with profiling.time_stage("c", t):
        pass
    assert t.calls["c"] == 1


def test_from_points_matches_jax():
    rng = np.random.RandomState(4)
    xyz = rng.randn(10, 3).astype(np.float32)
    ring, rel = rng.randint(0, 16, 10), rng.rand(10)
    for kw in ({}, {"capacity": 16}, {"capacity": 16, "ring": ring, "rel_time": rel}):
        want = jcloud.from_points(xyz, **kw)
        got = tcloud.from_points(xyz, device="cpu", **kw)
        for f in ("xyz", "mask", "ring", "rel_time"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    with pytest.raises(ValueError):
        tcloud.from_points(xyz, capacity=4, device="cpu")


def test_figure_eight_trajectory_equals_jax():
    for n in (2, 50):
        np.testing.assert_array_equal(tsim.figure_eight_trajectory(n),
                                      jsim.figure_eight_trajectory(n))


# ---- SlamPipeline options: map_mesh raises where the JAX package's does; dynamic_mode

@pytest.mark.parametrize("kwargs,item", [
    ({"mode": "local"}, "requires mode='mapping'"),
    ({"mode": "localization"}, "requires mode='mapping'"),
    ({"cfg": tc.PipelineConfig(matcher=tc.MatcherConfig(dynamic_mode=True))}, "dynamic_mode"),
])
def test_unported_options_raise(kwargs, item):
    # the striped map (maps/sharded_map) is mapping mode only and not out of
    # core, as in the JAX package; a mesh of one rank needs no process group
    from cooper_mapper_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match=item):
        SlamPipeline(map_mesh=Mesh(None, 1, 0, torch.device("cpu")), **kwargs)


def _small_sweeps(n=3, width=256):
    world = tsim.make_room_world(size=(20.0, 4.0, 24.0), n_pillars=4, seed=13, device="cpu")
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.35
    out = []
    for _ in range(n):
        out.append(tsim.scan_sweep(world, torch.from_numpy(p), torch.from_numpy(p @ step),
                                   n_rings=16, width=width))
        p = p @ step
    return out


def _small_pipeline_cfg(m, tmp_path, dynamic, **changes):
    return dataclasses.replace(m.PipelineConfig(
        registration=m.RegistrationConfig(n_rings=16, max_points_per_ring=256),
        scan_match=m.ScanMatchConfig(score_threshold=50.0),
        feature_map=m.MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=512,
                                surf_cube_capacity=1024, surround_corner_capacity=4096,
                                surround_surf_capacity=8192, valid_distance=25.0),
        matcher=m.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096,
                                dynamic_mode=dynamic, map_directory=str(tmp_path / "map"))),
        **changes)


@pytest.mark.parametrize("mode", ["local", "localization"])
def test_dynamic_mode_outside_mapping_runs_as_static(tmp_path, mode):
    """dynamic_mode only concerns the mapping mode: in "local" and
    "localization" no paging map is made (as in the JAX package) and the
    drive equals the same drive without the flag, bit for bit."""
    j = jpipe.SlamPipeline(_small_pipeline_cfg(jc, tmp_path, True), mode)
    assert not j.dynamic and j.dmap is None
    sweeps = _small_sweeps()
    poses = {}
    for dynamic in (True, False):
        pipe = SlamPipeline(_small_pipeline_cfg(tc, tmp_path, dynamic), mode, device="cpu")
        assert not pipe.dynamic and pipe.dmap is None
        poses[dynamic] = np.stack([pipe.process(s).merged_pose for s in sweeps])
        pipe.save_map()
    np.testing.assert_array_equal(poses[True], poses[False])
    assert not os.path.exists(tmp_path / "map")


def test_dynamic_mode_with_the_graph_runs(tmp_path):
    """dynamic_mode with enable_graph: the graph rides the paged map (the
    JAX package allows the pair); a few sweeps run, keyframes are taken and
    save_map() writes the manifest and the cube files."""
    cfg = _small_pipeline_cfg(tc, tmp_path, True, enable_graph=True,
                              pose_graph=tc.PoseGraphConfig(max_nodes=64, max_edges=128))
    pipe = SlamPipeline(cfg, "mapping", device="cpu")
    assert pipe.dynamic and pipe.graph is not None
    results = [pipe.process(s) for s in _small_sweeps(4)]
    assert all(np.isfinite(r.merged_pose).all() for r in results)
    assert all(r.graph_pose is not None for r in results[1:])
    assert pipe.timer.calls["paging"] == pipe.stats()["mapping_solves"] >= 2
    assert len(pipe.graph.keyframes) >= 1
    pipe.save_map()
    files = os.listdir(tmp_path / "map")
    assert "index2.txt" in files and sum(f.endswith(".pcd") for f in files) >= 2
    assert pipe.dmap.n_flushed == len(files) - 1


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        SlamPipeline(mode="graph", device="cpu")
