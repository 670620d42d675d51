"""The whole ported slice against the JAX package: each package runs its own
simulator -> feature extraction -> batched odometry solve on the same scene
(numpy-seeded world, the same poses and initial guesses), B = 4 lanes.

Tolerance 2e-3 on the solved twists, the tolerance tests/test_odometry.py
uses between equivalent nearest-neighbour paths: the two pipelines differ by
f32 rounding (fused XLA sums, library transcendentals), which can move a
flat-floor feature pick or a near-tied neighbour.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import OdometryConfig as JOdo, RegistrationConfig as JReg  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat, odometry as jodo  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3, twist as jtwist  # noqa: E402
from cooper_mapper_torch.config import OdometryConfig as TOdo, RegistrationConfig as TReg  # noqa: E402
from cooper_mapper_torch.io import sim as tsim  # noqa: E402
from cooper_mapper_torch.ops import features as tfeat, odometry as todo  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud as TCloud  # noqa: E402

WIDTH, B = 512, 4


def _pose(x=0.0, y=1.5, z=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s, x], [0, 1, 0, y], [-s, 0, c, z], [0, 0, 0, 1]], np.float32)


def test_sim_features_solve_slice_matches():
    # tests/test_odometry.py::TestCvDewarp::test_warm_start_recovers_exactly's
    # scene, four lanes with their own motion priors, default OdometryConfig
    motion = _pose(x=-0.2, y=0.03, z=0.3, yaw=-0.04)
    p0 = _pose()
    p1 = p0 @ motion
    gt = np.asarray(jtwist.from_relative_motion(jnp.asarray(motion)))
    rng = np.random.RandomState(3)
    x0 = (gt[None] + np.concatenate([0.005 * rng.randn(B, 3), 0.02 * rng.randn(B, 3)], 1)
          ).astype(np.float32)

    world_j = jsim.make_room_world(seed=7)
    cfg_j = JReg(n_rings=16, max_points_per_ring=WIDTH)
    prev_j = jfeat.extract_features(jsim.scan_sweep(world_j, jnp.asarray(p0), jnp.asarray(p0),
                                                    n_rings=16, width=WIDTH), cfg_j)
    cur_j = jfeat.extract_features(jsim.scan_sweep(world_j, jnp.asarray(p0), jnp.asarray(p1),
                                                   n_rings=16, width=WIDTH), cfg_j)
    tile_j = lambda c: jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), c)
    xj, _ = jodo.batch_odometry_solve(tile_j(cur_j.sharp), tile_j(cur_j.flat),
                                      prev_j.less_sharp, prev_j.less_flat, jnp.asarray(x0), JOdo())

    world_t = tsim.make_room_world(seed=7, device="cpu")
    cfg_t = TReg(n_rings=16, max_points_per_ring=WIDTH)
    prev_t = tfeat.extract_features(tsim.scan_sweep(world_t, torch.from_numpy(p0),
                                                    torch.from_numpy(p0), 16, WIDTH), cfg_t)
    cur_t = tfeat.extract_features(tsim.scan_sweep(world_t, torch.from_numpy(p0),
                                                   torch.from_numpy(p1), 16, WIDTH), cfg_t)
    tile_t = lambda c: TCloud(*(t[None].expand((B,) + tuple(t.shape)).contiguous()
                                for t in (c.xyz, c.mask, c.ring, c.rel_time)))
    xt, st = todo.batch_odometry_solve(tile_t(cur_t.sharp), tile_t(cur_t.flat),
                                       prev_t.less_sharp, prev_t.less_flat,
                                       torch.from_numpy(x0), TOdo())

    assert torch.isfinite(xt).all() and bool(st.converged.all())
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-3)
    # and both recover the simulator's motion (test_odometry's bounds)
    err = np.asarray(jse3.se3_log(jse3.inverse(jnp.asarray(motion))[None]
                                  @ jtwist.to_mat(jnp.asarray(xt.numpy()))))
    assert np.linalg.norm(err[:, :3], axis=1).max() < 0.05
    assert np.linalg.norm(err[:, 3:], axis=1).max() < 0.01



# bench.build_problem's sensor pose and motion
_BENCH_P0 = _pose()
_BENCH_MOTION = np.array([[np.cos(0.02), 0, np.sin(0.02), 0.1], [0, 1, 0, 0],
                          [-np.sin(0.02), 0, np.cos(0.02), 0.35], [0, 0, 0, 1]], np.float32)


def _bench_sweeps_jax():
    world = jsim.make_room_world(seed=42)
    p0 = jnp.asarray(_BENCH_P0)
    return (jsim.scan_sweep(world, p0, p0, n_rings=16, width=1024),
            jsim.scan_sweep(world, p0, p0 @ jnp.asarray(_BENCH_MOTION), n_rings=16, width=1024))


@pytest.mark.parametrize("features", ["jitted", "op_by_op"])
def test_bench_scene_default_config_matches_jax(features):
    # chip_smoke.py's main path at B = 4: bench.py's scene (16 x 1024 sweep
    # pair in make_room_world(seed=42)), compacted clouds, the bench priors
    # 0.02 * randn(6) and the default OdometryConfig (cv_dewarp=True).  Both
    # solves start from the JAX simulator's sweeps.  "jitted": bench's own
    # clouds (the jitted extractor), bridged into the port's solve.
    # "op_by_op": the port extracts its clouds itself and JAX extracts op by
    # op; the jitted extractor re-associates curvature sums
    # (tests/test_torch_features.py) and so picks other flat-floor points.
    import bench
    import chip_smoke
    from cooper_mapper_torch import bridge

    x0 = (0.02 * np.random.RandomState(0).randn(B, 6)).astype(np.float32)
    sweeps = _bench_sweeps_jax()
    if features == "jitted":
        f_prev, f_cur = bench.build_problem()
        t_prev, t_cur = (bridge.feature_clouds(f, "cpu") for f in (f_prev, f_cur))
    else:
        f_prev, f_cur = (jfeat._extract_impl(s, JReg(n_rings=16, max_points_per_ring=1024))[0]
                         for s in sweeps)
        t_prev, t_cur = (tfeat.extract_features(bridge.sweep(s, "cpu"),
                                                TReg(n_rings=16, max_points_per_ring=1024))
                         for s in sweeps)
    jc = [bench.snug(c) for c in (f_cur.sharp, f_cur.flat, f_prev.less_sharp, f_prev.less_flat)]
    tile_j = lambda c: jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), c)
    xj, _ = jodo.batch_odometry_solve(tile_j(jc[0]), tile_j(jc[1]), jc[2], jc[3],
                                      jnp.asarray(x0), JOdo())
    tc = [chip_smoke.snug(c) for c in (t_cur.sharp, t_cur.flat, t_prev.less_sharp,
                                       t_prev.less_flat)]
    for ct, cj in zip(tc, jc):
        np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))
    xt, _ = todo.batch_odometry_solve(chip_smoke.tile(tc[0], B), chip_smoke.tile(tc[1], B),
                                      tc[2], tc[3], torch.from_numpy(x0), TOdo())

    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-3)
    # the reference itself misses test_recovers_motion's bounds on every lane
    # here: the de-warp takes the prior (about zero) as the in-sweep motion,
    # so the cloud keeps the sweep's distortion.  chip_smoke therefore holds
    # the ground truth on the cv_dewarp=False solve of the same lanes.
    te, re_ = chip_smoke.lane_errors(torch.tensor(np.asarray(xj)), torch.from_numpy(_BENCH_MOTION))
    assert ((te > 0.05) | (re_ > 0.01)).all()
