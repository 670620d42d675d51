"""Port vs JAX package: the stages of the single-stream sweep.

The cube map (``maps/feature_map.py``), ``models/laser_odometry`` and
``models/laser_mapping`` against their JAX functions, at CPU size, on the
same numpy-seeded inputs.  Where a stage starts from feature clouds, both
packages get the SAME clouds: the JAX package's extraction, bridged into the
port, so the jitted extractor's reordering of exact curvature ties (ROADMAP
Queue 3) cannot enter.  The whole sweep, the port's extraction included, is
held to the JAX package in tests/test_torch_fused_sweep.py.

Tolerances: the cube map's integer bookkeeping, insert order and gathers
are exact (the same stable sorts); poses within 2e-3, the tolerance
between the NN paths in tests/test_odometry.py (the solves agree to ~1e-6
here); end-projected and registered points within 1e-4 m.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.maps import feature_map as jfm  # noqa: E402
from cooper_mapper_tpu.models import fused as jfused  # noqa: E402
from cooper_mapper_tpu.models import laser_mapping as jlm  # noqa: E402
from cooper_mapper_tpu.models import laser_odometry as jlo  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_tpu.ops import scan_match as jsm  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.maps import feature_map as tfm  # noqa: E402
from cooper_mapper_torch.models import laser_mapping as tlm  # noqa: E402
from cooper_mapper_torch.models import laser_odometry as tlo  # noqa: E402
from cooper_mapper_torch.ops import scan_match as tsm  # noqa: E402
from cooper_mapper_torch.utils import se3 as tse3  # noqa: E402

POSE_TOL, POINT_TOL = 2e-3, 1e-4


def _map_cfg(m, **kw):
    """A 5 x 3 x 5 grid of 4 m cubes, 16 / 32 slots per cube, margin 1."""
    base = dict(n_cubes=(5, 3, 5), cube_size=4.0, margin_cubes=1, corner_cube_capacity=16,
                surf_cube_capacity=32, surround_corner_capacity=512,
                surround_surf_capacity=1024, valid_distance=8.0)
    base.update(kw)
    return m.MapConfig(**base)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _assert_cube_cloud(ct, cj):
    np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))


def _assert_map(mt, mj):
    np.testing.assert_array_equal(mt.origin.numpy(), np.asarray(mj.origin))
    _assert_cube_cloud(mt.corner, mj.corner)
    _assert_cube_cloud(mt.surf, mj.surf)


def _points(rng, n, lo, hi, n_invalid=0):
    """(xyz, mask) numpy: n points uniform in [lo, hi)^3, the first
    ``n_invalid`` masked out and at FAR."""
    xyz = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[:n_invalid] = False
    xyz[~mask] = jcloud.FAR
    return xyz, mask


def _both_clouds(xyz, mask):
    jcl = jcloud.make(jnp.asarray(xyz), jnp.asarray(mask))
    return jcl, bridge.cloud(jcl, "cpu")


def _filled_maps(cfg_j, cfg_t, seed=0, n=600, span=14.0):
    """The same map in both packages: two inserts of random points around
    the origin (many cubes over capacity)."""
    rng = np.random.RandomState(seed)
    mj = jfm.create(cfg_j)
    mt = tfm.create(cfg_t, device="cpu")
    for _ in range(2):
        cj, ct = _both_clouds(*_points(rng, n, -span, span, n_invalid=20))
        sj, st = _both_clouds(*_points(rng, 2 * n, -span, span, n_invalid=40))
        mj = jfm.add_feature_cloud(mj, cj, sj, cfg_j)
        mt = tfm.add_feature_cloud(mt, ct, st, cfg_t)
    return mj, mt


# ---------------------------------------------------------------------------
# The cube map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("origin", [(-2, -1, -2), (3, -4, 1), (-7, 2, 9)])
def test_cube_indexing_and_window_match_jax(origin):
    cfg_j, cfg_t = _map_cfg(jc), _map_cfg(tc)
    rng = np.random.RandomState(1)
    xyz, _ = _points(rng, 500, -40.0, 40.0)
    xyz[:5] = jcloud.FAR
    xyz[5:10] = np.array([2.0, -2.0, 6.0], np.float32)     # on cube boundaries
    o = np.asarray(origin, np.int32)
    cj = jfm.world_to_cube(jnp.asarray(xyz), cfg_j)
    ct = tfm.world_to_cube(_t(xyz), cfg_t)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    for got, want in zip(tfm._grid_index(ct, _t(o), cfg_t),
                         jfm._grid_index(cj, jnp.asarray(o), cfg_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for pos in xyz[10:40]:
        shift_j = jfm.window_shift(jnp.asarray(o), jnp.asarray(pos), cfg_j)
        shift_t = tfm.window_shift(_t(o), _t(pos), cfg_t)
        np.testing.assert_array_equal(shift_t.numpy(), np.asarray(shift_j))
        new_o = o + np.asarray(shift_j)
        np.testing.assert_array_equal(
            tfm.keep_mask_for_window(_t(o), _t(new_o), cfg_t).numpy(),
            np.asarray(jfm.keep_mask_for_window(jnp.asarray(o), jnp.asarray(new_o), cfg_j)))


def test_insert_over_capacity_with_ties_and_points_outside_the_window():
    # three cubes get far more points than their 16 / 32 slots (the stable
    # sort decides which enter), duplicated points tie on the sort key, and
    # points outside the 20 x 12 x 20 m window and masked-out points drop
    cfg_j, cfg_t = _map_cfg(jc), _map_cfg(tc)
    rng = np.random.RandomState(2)
    centres = np.array([[0.0, 0.0, 0.0], [4.0, 0.0, -4.0], [-8.0, 4.0, 8.0]], np.float32)
    xyz = (centres[rng.randint(0, 3, 300)] + rng.uniform(-1.9, 1.9, (300, 3))).astype(np.float32)
    xyz[100:140] = xyz[60:100]                                  # exact duplicates
    xyz[140:170] = rng.uniform(15.0, 40.0, (30, 3))              # outside the window
    mask = np.ones(300, bool)
    mask[170:180] = False
    mj, mt = jfm.create(cfg_j), tfm.create(cfg_t, device="cpu")
    for _ in range(2):                                           # the second lands behind counts
        cj, ct = _both_clouds(xyz[:150], mask[:150])
        sj, st = _both_clouds(xyz, mask)
        mj = jfm.add_feature_cloud(mj, cj, sj, cfg_j)
        mt = tfm.add_feature_cloud(mt, ct, st, cfg_t)
        _assert_map(mt, mj)
    assert int(mt.surf.count.max()) == cfg_t.surf_cube_capacity
    assert not bool(mt.surf.row_mask[-1])                        # the guard row stays empty


def test_recenter_across_the_boundary_then_insert():
    cfg_j, cfg_t = _map_cfg(jc), _map_cfg(tc)
    mj, mt = _filled_maps(cfg_j, cfg_t)
    rows = mt.surf.rows
    rng = np.random.RandomState(3)
    # the window moves by up to 3 cubes per axis, past the grid's wrap
    for pos in ([9.0, 0.0, -9.0], [21.0, 5.0, -13.0], [-3.0, -6.0, 2.0]):
        pos = np.asarray(pos, np.float32)
        mj = jfm.recenter(mj, jnp.asarray(pos), cfg_j)
        out = tfm.recenter(mt, _t(pos), cfg_t)
        assert out is mt and mt.surf.rows is rows                # in place
        _assert_map(mt, mj)
        cj, ct = _both_clouds(*_points(rng, 300, -20.0, 30.0))
        sj, st = _both_clouds(*_points(rng, 400, -20.0, 30.0))
        mj = jfm.add_feature_cloud(mj, cj, sj, cfg_j)
        tfm.add_feature_cloud(mt, ct, st, cfg_t)
        _assert_map(mt, mj)


@pytest.mark.parametrize("vfov", [(0.0, 0.0), (10.0, 15.0)])
def test_get_surround_matches_jax(vfov):
    # the static offset neighbourhood, the window check and the vertical
    # field-of-view cull, gathered and compacted in slot order
    cfg_j = _map_cfg(jc, vfov_up_deg=vfov[0], vfov_down_deg=vfov[1])
    cfg_t = _map_cfg(tc, vfov_up_deg=vfov[0], vfov_down_deg=vfov[1])
    mj, mt = _filled_maps(cfg_j, cfg_t, seed=4)
    for pos in ([0.5, 0.3, -1.2], [3.9, -2.1, 5.5]):
        pos = np.asarray(pos, np.float32)
        if vfov[0]:
            offs = jnp.asarray(jfm._surround_offsets(cfg_j))
            np.testing.assert_array_equal(
                tfm._vfov_mask(_t(np.asarray(offs)), _t(pos), cfg_t).numpy(),
                np.asarray(jfm._vfov_mask(offs, jnp.asarray(pos), cfg_j)))
        checksum = [t.clone() for t in (mt.surf.rows, mt.surf.row_mask, mt.surf.count)]
        for ct, cj in zip(tfm.get_surround(mt, _t(pos), cfg_t),
                          jfm.get_surround(mj, jnp.asarray(pos), cfg_j)):
            assert int(ct.mask.sum()) > 0
            np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
            np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))
        assert all(torch.equal(a, b) for a, b in
                   zip(checksum, (mt.surf.rows, mt.surf.row_mask, mt.surf.count)))




# ---------------------------------------------------------------------------
# Odometry and mapping stages, from the same feature clouds
# ---------------------------------------------------------------------------


REG = dict(n_rings=16, max_points_per_ring=256, max_sharp=128, max_less_sharp=512,
           max_flat=256, max_less_flat=2048)


def _stream_cfg(m, **sm):
    return m.PipelineConfig(
        registration=m.RegistrationConfig(**REG),
        scan_match=m.ScanMatchConfig(**{"score_threshold": 50.0, **sm}),
        feature_map=m.MapConfig(n_cubes=(5, 3, 5), cube_size=20.0, corner_cube_capacity=512,
                                surf_cube_capacity=1024, surround_corner_capacity=2048,
                                surround_surf_capacity=4096, valid_distance=40.0),
        matcher=m.MatcherConfig(max_frame_corner=512, max_frame_surf=1024))


@pytest.fixture(scope="module")
def stream():
    """Three sweeps of a straight drive (0.35 m per sweep, 16 x 256) in
    make_room_world(seed=31), their JAX features, and the JAX odometry stage
    run over them: the inputs every stage test shares."""
    cfg = _stream_cfg(jc)
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.35
    feats = []
    for _ in range(3):
        sw = jsim.scan_sweep(world, jnp.asarray(p), jnp.asarray(p @ step), n_rings=16,
                             width=REG["max_points_per_ring"])
        feats.append(jfeat.extract_features(sw, cfg.registration))
        p = p @ step
    states = [jlo.init_step(jlo.create(REG["max_less_sharp"], REG["max_less_flat"]),
                            feats[0], cfg.odometry)]
    outs = []
    for fc in feats[1:]:
        st, out = jlo.step(states[-1], fc, cfg.odometry)
        states.append(st)
        outs.append(out)
    return dict(feats=feats, states=states, outs=outs)


def _assert_cloud(ct, cj, tol=POINT_TOL):
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    np.testing.assert_array_equal(ct.ring.numpy(), np.asarray(cj.ring))
    m = np.asarray(cj.mask)
    np.testing.assert_allclose(ct.xyz.numpy()[m], np.asarray(cj.xyz)[m], atol=tol)


def test_odometry_init_step_and_steps_match_jax(stream):
    cfg = _stream_cfg(tc)
    fts = [bridge.feature_clouds(f, "cpu") for f in stream["feats"]]
    st = tlo.init_step(tlo.create(REG["max_less_sharp"], REG["max_less_flat"], "cpu"), fts[0],
                       cfg.odometry)
    _assert_cloud(st.last_corner, stream["states"][0].last_corner, 0.0)
    _assert_cloud(st.last_surf, stream["states"][0].last_surf, 0.0)
    for k, fc in enumerate(fts[1:]):
        st, out = tlo.step(st, fc, cfg.odometry)
        want_st, want = stream["states"][k + 1], stream["outs"][k]
        np.testing.assert_allclose(out.x.numpy(), np.asarray(want.x), atol=POSE_TOL)
        np.testing.assert_allclose(out.T_sum.numpy(), np.asarray(want.T_sum), atol=POSE_TOL)
        np.testing.assert_allclose(st.x_prev.numpy(), np.asarray(want_st.x_prev), atol=POSE_TOL)
        assert bool(out.converged) == bool(want.converged)
        assert abs(float(out.n_matched) - float(want.n_matched)) <= 2
        _assert_cloud(out.surf_for_map, want.surf_for_map)
        _assert_cloud(st.last_corner, want_st.last_corner)
        _assert_cloud(st.last_surf, want_st.last_surf)
    # 2 x 0.35 m forward (the sensor's +z), from the simulator
    assert abs(float(st.T_sum[2, 3]) - 0.7) < 0.05
    # parity mode, ported: a step from the JAX package's state equals its parity step
    _, out_p = tlo.step(bridge.odometry_state(stream["states"][1], "cpu"), fts[2], cfg.odometry,
                        parity_mode=True)
    _, want_p = jlo.step(stream["states"][1], stream["feats"][2], cfg.odometry, parity_mode=True)
    np.testing.assert_allclose(out_p.T_sum.numpy(), np.asarray(want_p.T_sum), atol=POSE_TOL)
    np.testing.assert_allclose(out_p.x.numpy(), np.asarray(want_p.x), atol=POSE_TOL)
    # a step from the JAX package's state, bridged, lands on its next state
    _, out = tlo.step(bridge.odometry_state(stream["states"][1], "cpu"), fts[2], cfg.odometry)
    np.testing.assert_allclose(out.T_sum.numpy(), np.asarray(stream["outs"][1].T_sum),
                               atol=POSE_TOL)


def test_bridged_fused_state_round_trips(stream):
    cfg_j = _map_cfg(jc)
    mj, _ = _filled_maps(cfg_j, _map_cfg(tc), seed=5)
    matcher = jlm.seed_localization(jlm.create_matcher(), jnp.eye(4) * 2.0, jnp.eye(4) * 3.0)
    sj = jfused.FusedState(odo=stream["states"][1], matcher=matcher, map=mj)
    st = bridge.fused_state(sj, "cpu")
    _assert_map(st.map, mj)
    np.testing.assert_array_equal(st.matcher.W_last.numpy(), np.asarray(matcher.W_last))
    np.testing.assert_array_equal(st.matcher.L_last.numpy(), np.asarray(matcher.L_last))
    for f in ("x_prev", "T_sum"):
        np.testing.assert_array_equal(getattr(st.odo, f).numpy(), np.asarray(getattr(sj.odo, f)))
    _assert_cloud(st.odo.last_surf, sj.odo.last_surf, 0.0)
    _assert_cloud(st.odo.last_corner, sj.odo.last_corner, 0.0)


def _seeded_map(stream, m_cfg_j):
    """A JAX map holding sweep 0's clouds at the identity pose."""
    f0 = stream["feats"][0]
    return jfm.add_feature_cloud(jfm.create(m_cfg_j), f0.less_sharp, f0.less_flat, m_cfg_j)


def test_mapping_steps_match_jax(stream):
    # two mapping steps from an empty map, as the sweep runs them: the first
    # has no reference (enough_ref fails, the frame enters at the guess), the
    # second solves against it and passes the gate
    cfg_j, cfg_t = _stream_cfg(jc), _stream_cfg(tc)
    mj, matcher_j = jfm.create(cfg_j.feature_map), jlm.create_matcher()
    mt, matcher_t = tfm.create(cfg_t.feature_map, "cpu"), tlm.create_matcher("cpu")
    rows = mt.surf.rows
    for k, out in enumerate(stream["outs"]):
        matcher_j, mj, moj = jlm.mapping_step(matcher_j, mj, out.corner_for_map, out.surf_for_map,
                                              out.T_sum, cfg_j.scan_match, cfg_j.matcher,
                                              cfg_j.feature_map)
        matcher_t, mapt, mot = tlm.mapping_step(
            matcher_t, mt, bridge.cloud(out.corner_for_map, "cpu"),
            bridge.cloud(out.surf_for_map, "cpu"), _t(out.T_sum), cfg_t.scan_match,
            cfg_t.matcher, cfg_t.feature_map)
        assert mapt is mt and mt.surf.rows is rows               # the map in place
        assert bool(mot.result.success) == bool(moj.result.success) == (k == 1)
        np.testing.assert_allclose(mot.W.numpy(), np.asarray(moj.W), atol=POSE_TOL)
        np.testing.assert_allclose(matcher_t.W_last.numpy(), np.asarray(matcher_j.W_last),
                                   atol=POSE_TOL)
        np.testing.assert_array_equal(matcher_t.L_last.numpy(), np.asarray(matcher_j.L_last))
        np.testing.assert_allclose(float(mot.result.score), float(moj.result.score), rtol=1e-3)
        _assert_cloud(mot.surf_ds, moj.surf_ds, 0.0)
        np.testing.assert_array_equal(mt.origin.numpy(), np.asarray(mj.origin))
        for ct, cj in ((mt.corner, mj.corner), (mt.surf, mj.surf)):
            np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
            np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
            np.testing.assert_allclose(ct.xyz.numpy(), np.asarray(cj.xyz), atol=POINT_TOL)


@pytest.mark.parametrize("commit_rejected", [False, True])
@pytest.mark.parametrize("success", [False, True])
def test_commit_policies_match_jax(stream, commit_rejected, success):
    # the rejection policy decides the committed pose and where the frame
    # enters the map: the solved pose, or the dead-reckoned guess
    cfg_j, cfg_t = _stream_cfg(jc), _stream_cfg(tc)
    mj = _seeded_map(stream, cfg_j.feature_map)
    mt = bridge.feature_map_state(mj, "cpu")
    out = stream["outs"][0]
    x = np.array([0.01, -0.02, 0.015, 0.1, -0.05, 0.4], np.float32)
    guess = np.asarray(out.T_sum)
    fields = dict(converged=success, score=900.0, match_fraction=0.6, n_matched=100.0,
                  is_degenerate=False, iter_used=5, enough_ref=True)
    res_j = jsm.ScanMatchResult(x=jnp.asarray(x), success=jnp.asarray(success),
                                **{k: jnp.asarray(v) for k, v in fields.items()})
    res_t = tsm.ScanMatchResult(x=_t(x), success=torch.tensor(success),
                                **{k: torch.tensor(v) for k, v in fields.items()})
    m_j = dataclasses.replace(cfg_j.matcher, commit_rejected_solves=commit_rejected)
    m_t = dataclasses.replace(cfg_t.matcher, commit_rejected_solves=commit_rejected)
    corner_j, surf_j = out.corner_for_map, out.surf_for_map
    Wj, mapj = jlm._commit(res_j, jnp.asarray(guess), mj, corner_j, surf_j, cfg_j.feature_map, m_j)
    Wt, mapt = tlm._commit(res_t, _t(guess), mt, bridge.cloud(corner_j, "cpu"),
                           bridge.cloud(surf_j, "cpu"), cfg_t.feature_map, m_t)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-6)
    if not (success or commit_rejected):
        np.testing.assert_array_equal(Wt.numpy(), guess)
    np.testing.assert_array_equal(mapt.surf.count.numpy(), np.asarray(mapj.surf.count))
    np.testing.assert_allclose(mapt.surf.xyz.numpy(), np.asarray(mapj.surf.xyz), atol=POINT_TOL)


def test_localization_rejected_solve_keeps_the_guess_and_the_map(stream):
    # tests/test_localization.py::TestGateFailureDeadReckon on the port: an
    # impossible score threshold fails the gate, the committed pose is the
    # transform_associate guess within 1e-6, and the map is not written
    cfg_j, cfg_t = _stream_cfg(jc, score_threshold=1e9), _stream_cfg(tc, score_threshold=1e9)
    mj = _seeded_map(stream, cfg_j.feature_map)
    mt = bridge.feature_map_state(mj, "cpu")
    checksum = [t.clone() for cc in (mt.corner, mt.surf) for t in (cc.rows, cc.row_mask, cc.count)]
    fc = stream["feats"][2]
    L_last = np.eye(4, dtype=np.float32)
    W_last = np.eye(4, dtype=np.float32)
    W_last[2, 3] = 0.4
    L_now = np.eye(4, dtype=np.float32)
    L_now[2, 3] = 0.42
    mj2, moj = jlm.localization_step(jlm.MatcherState(jnp.asarray(L_last), jnp.asarray(W_last)),
                                     mj, fc.less_sharp, fc.less_flat, jnp.asarray(L_now),
                                     cfg_j.scan_match, cfg_j.matcher, cfg_j.feature_map)
    mt2, mot = tlm.localization_step(tlm.MatcherState(_t(L_last), _t(W_last)), mt,
                                     bridge.cloud(fc.less_sharp, "cpu"),
                                     bridge.cloud(fc.less_flat, "cpu"), _t(L_now),
                                     cfg_t.scan_match, cfg_t.matcher, cfg_t.feature_map)
    assert not bool(mot.result.success) and not bool(moj.result.success)
    guess = tse3.transform_associate(_t(L_last), _t(L_now), _t(W_last))
    np.testing.assert_allclose(mot.W.numpy(), guess.numpy(), atol=1e-6)
    np.testing.assert_allclose(mt2.W_last.numpy(), guess.numpy(), atol=1e-6)
    np.testing.assert_allclose(mot.W.numpy(), np.asarray(moj.W), atol=1e-6)
    np.testing.assert_allclose(float(mot.result.score), float(moj.result.score), rtol=1e-3)
    after = [t for cc in (mt.corner, mt.surf) for t in (cc.rows, cc.row_mask, cc.count)]
    assert all(torch.equal(a, b) for a, b in zip(checksum, after))


def test_seed_localization_and_merged_pose_match_jax():
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 5.0
    L_now = np.eye(4, dtype=np.float32)
    L_now[2, 3] = 1.0
    mj = jlm.seed_localization(jlm.create_matcher(), jnp.asarray(pose), jnp.asarray(L_now))
    mt = tlm.seed_localization(tlm.create_matcher("cpu"), _t(pose), _t(L_now))
    np.testing.assert_array_equal(mt.W_last.numpy(), pose)
    np.testing.assert_array_equal(mt.L_last.numpy(), L_now)
    # the merged pose at the seeding instant is the seed; later, the odometry
    # delta chained onto it
    np.testing.assert_allclose(tlm.merged_pose(mt, _t(L_now)).numpy(), pose, atol=1e-6)
    rng = np.random.RandomState(8)
    L_later = (L_now @ np.asarray(jse3.euler6_to_mat(jnp.asarray(
        rng.uniform(-0.2, 0.2, 6).astype(np.float32))))).astype(np.float32)
    np.testing.assert_allclose(tlm.merged_pose(mt, _t(L_later)).numpy(),
                               np.asarray(jlm.merged_pose(mj, jnp.asarray(L_later))), atol=1e-6)
