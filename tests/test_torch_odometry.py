"""Port vs JAX package: Jacobian rows and the batched odometry solve on
identical features (the JAX simulator's and extractor's, through the bridge).

Solve tolerance 2e-3 on the twist: the tolerance tests/test_odometry.py
uses between equivalent nearest-neighbour paths, since the two packages form
q.r differently and a near-tie in a race may pick the other neighbour.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import OdometryConfig as JOdo, RegistrationConfig as JReg  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat, odometry as jodo  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import OdometryConfig as TOdo  # noqa: E402
from cooper_mapper_torch.ops import odometry as todo  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud as TCloud  # noqa: E402

WIDTH = 512
SOLVE_ATOL = 2e-3
CLOUDS = ("sharp", "less_sharp", "flat", "less_flat")


def _pose(x=0.0, y=1.5, z=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s, x], [0, 1, 0, y], [-s, 0, c, z], [0, 0, 0, 1]], np.float32)


def _snug(c, granule=256):
    """Compact a cloud to its valid count rounded up to ``granule`` (bench.py)."""
    n = int(np.asarray(c.mask).sum())
    return jcloud.compact(c, -(-n // granule) * granule)


def _features(motion, world_seed=7):
    """(prev, cur) JAX feature clouds: static reference sweep, distorted query,
    compacted like bench.py does."""
    world = jsim.make_room_world(seed=world_seed)
    p0 = _pose()
    cfg = JReg(n_rings=16, max_points_per_ring=WIDTH)
    prev = jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p0),
                                                  n_rings=16, width=WIDTH), cfg)
    cur = jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p0 @ motion),
                                                 n_rings=16, width=WIDTH), cfg)
    return (jfeat.FeatureClouds(*(_snug(getattr(prev, f)) for f in CLOUDS)),
            jfeat.FeatureClouds(*(_snug(getattr(cur, f)) for f in CLOUDS)))


def _tile_t(c, B):
    return TCloud(*(t[None].expand((B,) + tuple(t.shape)).contiguous()
                    for t in (c.xyz, c.mask, c.ring, c.rel_time)))


def _tile_j(c, B):
    return jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), c)


def test_jacobian_rows_match():
    rng = np.random.RandomState(5)
    x = rng.uniform(-0.3, 0.3, (2, 6)).astype(np.float32)
    pts = rng.uniform(-10, 10, (2, 32, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (2, 32)).astype(np.float32)
    coeff = rng.randn(2, 32, 3).astype(np.float32)
    rows = todo._exact_jacobian_rows(*map(torch.from_numpy, (x, pts, s, coeff))).numpy()
    rigid = todo._reference_jacobian_rows(*map(torch.from_numpy, (x, pts, coeff))).numpy()
    for b in range(2):
        np.testing.assert_allclose(rows[b], np.asarray(jodo._exact_jacobian_rows(
            jnp.asarray(x[b]), jnp.asarray(pts[b]), jnp.asarray(s[b]), jnp.asarray(coeff[b]))),
            atol=1e-5)
        np.testing.assert_allclose(rigid[b], np.asarray(jodo._exact_jacobian_rows_rigid(
            jnp.asarray(x[b]), jnp.asarray(pts[b]), jnp.asarray(coeff[b]))), atol=1e-5)


@pytest.mark.parametrize("cv_dewarp", [True, False])
def test_batched_solve_matches_on_identical_features(cv_dewarp):
    B = 4
    prev, cur = _features(_pose(x=-0.2, y=0.03, z=0.3, yaw=-0.04))
    x0 = (0.02 * np.random.RandomState(0).randn(B, 6)).astype(np.float32)
    xj, stj = jodo.batch_odometry_solve(
        _tile_j(cur.sharp, B), _tile_j(cur.flat, B), prev.less_sharp, prev.less_flat,
        jnp.asarray(x0), dataclasses.replace(JOdo(), cv_dewarp=cv_dewarp))
    tc = lambda c: bridge.cloud(c, "cpu")
    xt, stt = todo.batch_odometry_solve(
        _tile_t(tc(cur.sharp), B), _tile_t(tc(cur.flat), B), tc(prev.less_sharp),
        tc(prev.less_flat), torch.from_numpy(x0), dataclasses.replace(TOdo(), cv_dewarp=cv_dewarp))
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=SOLVE_ATOL)
    np.testing.assert_array_equal(stt.converged.numpy(), np.asarray(stj.converged))


def test_per_problem_references_and_single_solve():
    motions = [_pose(x=0.25, y=0.0, z=0.35), _pose(x=0.0, y=0.0, z=0.4, yaw=0.03)]
    pairs = [_features(m) for m in motions]
    stack_j = lambda f: jax.tree.map(lambda *a: jnp.stack(a), *f)
    cfg_j = dataclasses.replace(JOdo(), cv_dewarp=False)
    cfg_t = dataclasses.replace(TOdo(), cv_dewarp=False)
    xj, _ = jodo.batch_odometry_solve(
        stack_j([p[1].sharp for p in pairs]), stack_j([p[1].flat for p in pairs]),
        stack_j([p[0].less_sharp for p in pairs]), stack_j([p[0].less_flat for p in pairs]),
        jnp.zeros((2, 6)), cfg_j)
    tc = lambda c: bridge.cloud(c, "cpu")
    stack_t = lambda cs: TCloud(*(torch.stack([getattr(tc(c), f) for c in cs])
                                  for f in ("xyz", "mask", "ring", "rel_time")))
    xt, _ = todo.batch_odometry_solve(
        stack_t([p[1].sharp for p in pairs]), stack_t([p[1].flat for p in pairs]),
        stack_t([p[0].less_sharp for p in pairs]), stack_t([p[0].less_flat for p in pairs]),
        torch.zeros(2, 6), cfg_t)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=SOLVE_ATOL)
    # the single-problem entry point is lane 0 of the batch
    prev, cur = pairs[0]
    x1, _ = todo.odometry_solve(tc(cur.sharp), tc(cur.flat), tc(prev.less_sharp),
                                tc(prev.less_flat), torch.zeros(6), cfg_t)
    np.testing.assert_allclose(x1.numpy(), xt[0].numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def knob_problem():
    """A yawing pair at B = 2 and the port's solve of it at the default config."""
    B = 2
    prev, cur = _features(_pose(x=-0.2, y=0.03, z=0.3, yaw=-0.04))
    x0 = (0.02 * np.random.RandomState(4).randn(B, 6)).astype(np.float32)
    tc = lambda c: bridge.cloud(c, "cpu")
    port = (_tile_t(tc(cur.sharp), B), _tile_t(tc(cur.flat), B), tc(prev.less_sharp),
            tc(prev.less_flat), torch.from_numpy(x0))
    jax_args = (_tile_j(cur.sharp, B), _tile_j(cur.flat, B), prev.less_sharp, prev.less_flat,
                jnp.asarray(x0))
    return port, jax_args, todo.batch_odometry_solve(*port, TOdo())


@pytest.mark.parametrize("field,value", [("nn_query_chunk", 256), ("kernel_backend", "dense"),
                                         ("nn_precision", "high"), ("unroll_iters", True)])
def test_jax_knobs_match_jax(knob_problem, field, value):
    # the JAX package's memory, dispatch, precision and loop knobs: none
    # changes the port's result (the query chunk only cuts the plain
    # version's distance tile; the products stay f32), so the port at the
    # non-default value equals its default run bit for bit, and the JAX
    # package at the same value (on the CPU every value gives its default's
    # distances) within SOLVE_ATOL
    port, jax_args, (x_default, st_default) = knob_problem
    xt, stt = todo.batch_odometry_solve(*port, TOdo(**{field: value}))
    xj, stj = jodo.batch_odometry_solve(*jax_args, JOdo(**{field: value}))
    assert torch.equal(xt, x_default) and torch.equal(stt.converged, st_default.converged)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=SOLVE_ATOL)
    np.testing.assert_array_equal(stt.converged.numpy(), np.asarray(stj.converged))


@pytest.mark.parametrize("field,value", [("nn_query_chunk", -1), ("kernel_backend", "cuda"),
                                         ("nn_precision", "garbage")])
def test_jax_knob_values_jax_rejects_raise(field, value):
    # values outside what the JAX package accepts (its kernel_backend names,
    # jax.lax.Precision's strings, a chunk >= 0) raise before any work
    clouds = [TCloud(torch.zeros(8, 3), torch.ones(8, dtype=torch.bool),
                     torch.zeros(8, dtype=torch.int32), torch.zeros(8))] * 4
    with pytest.raises(ValueError, match=field):
        todo.odometry_solve(*clouds, torch.zeros(6), TOdo(**{field: value}))


def test_dewarp_passes_matches_jax():
    """``dewarp_passes=2``: each lane equals the JAX package's two-pass
    solve (a yawing motion, where the second de-warp moves the answer)."""
    B = 2
    prev, cur = _features(_pose(x=-0.2, y=0.03, z=0.3, yaw=-0.06))
    x0 = (0.02 * np.random.RandomState(3).randn(B, 6)).astype(np.float32)
    tc = lambda c: bridge.cloud(c, "cpu")
    solve_t = lambda passes: todo.batch_odometry_solve(
        _tile_t(tc(cur.sharp), B), _tile_t(tc(cur.flat), B), tc(prev.less_sharp),
        tc(prev.less_flat), torch.from_numpy(x0), TOdo(dewarp_passes=passes))
    xt, stt = solve_t(2)
    xj, stj = jodo.batch_odometry_solve(
        _tile_j(cur.sharp, B), _tile_j(cur.flat, B), prev.less_sharp, prev.less_flat,
        jnp.asarray(x0), JOdo(dewarp_passes=2))
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=SOLVE_ATOL)
    np.testing.assert_array_equal(stt.converged.numpy(), np.asarray(stj.converged))
    assert float((xt - solve_t(1)[0]).abs().max()) > 1e-5
