"""Port vs JAX package: the pose-graph LM (``ops/pose_graph``).

The graphs are tests/test_pose_graph.py's noisy circles (12-16 nodes,
capacity 64 nodes / 128 edges), made by its ``_noisy_circle_graph`` and
bridged, so both packages solve the same graph.  Tolerances: residuals and
Jacobians 1e-4 (near zero, where the small-angle branches are
differentiated, and at ~0.5 rad); the assembled blocks, gradient, dense
Hessian, damping, the Hessian-vector product, the cost and the update 1e-4
relative to each array's largest entry; the CG step after 400 iterations
5e-4 from the dense solve (tests/test_pose_graph.py's own bound);
``optimize`` (dense and CG) poses within 1e-3 of the JAX package's and its
diagnostics within 1e-3 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.ops import pose_graph as jpg  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.ops import pose_graph as tpg  # noqa: E402
from tests.test_pose_graph import _noisy_circle_graph  # noqa: E402

REL = 1e-4
POSE_TOL = 1e-3


def _cfgs(**changes):
    kw = {**dict(max_nodes=64, max_edges=128, max_iterations=30), **changes}
    return jc.PoseGraphConfig(**kw), tc.PoseGraphConfig(**kw)


def _close(got, want, rel=REL, err=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale, (err, float(np.abs(got - want).max()))


def _graphs(n=12, seed=0, drift=0.02):
    g, gt, est = _noisy_circle_graph(n=n, drift=drift, seed=seed)
    return g, bridge.pose_graph(g, "cpu"), gt, est


def _rotated_measurements(g, angle=0.5):
    """The graph with every measurement turned by ``angle`` rad about a
    tilted axis, so every residual sits near ``angle``."""
    axis = np.array([0.3, 0.8, -0.5], np.float32)
    axis /= np.linalg.norm(axis)
    turn = jse3.se3_exp(jnp.asarray(np.concatenate([[0.1, -0.2, 0.3], angle * axis]),
                                    jnp.float32))
    return dataclasses.replace(g, edge_T=g.edge_T @ turn)


def _edge_inputs(g):
    return g.poses[g.edge_i], g.poses[g.edge_j], g.edge_T


@pytest.mark.parametrize("case", ["near_zero", "noisy", "half_radian"])
def test_residual_and_jacobians_match_jax(case):
    g = _graphs(drift=0.0 if case == "near_zero" else 0.02)[0]
    if case == "half_radian":
        g = _rotated_measurements(g)
    t = bridge.pose_graph(g, "cpu")
    r, Ji, Jj = jax.vmap(jpg._edge_residual_jac)(*_edge_inputs(g))
    tr, tJi, tJj = tpg._edge_residual_jac(t.poses[t.edge_i.long()], t.poses[t.edge_j.long()],
                                          t.edge_T)
    n = int(np.sum(np.asarray(g.edge_mask)))
    if case == "near_zero":
        assert float(np.abs(np.asarray(r[:n])).max()) < 1e-4
    if case == "half_radian":
        assert float(np.linalg.norm(np.asarray(r[:n, 3:]), axis=-1).min()) > 0.3
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=1e-4)
    np.testing.assert_allclose(tJi.numpy(), np.asarray(Ji), atol=1e-4)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(Jj), atol=1e-4)
    np.testing.assert_allclose(tpg.edge_residual(*_edge_inputs(t)).numpy(),
                               np.asarray(jpg.edge_residual(*_edge_inputs(g))), atol=1e-4)


def test_system_assembly_matches_jax():
    g, t, _, _ = _graphs(n=14, seed=2)
    n = g.poses.shape[0]
    lam = 1e-3
    plans = tpg.plans_for(t.edge_i, t.edge_j, n)
    jb = jpg._edge_blocks(g)
    tb = tpg._edge_blocks(t, plans)
    for name, a, b in zip(("H_ii", "H_jj", "H_ij", "g", "cost"), tb, jb):
        _close(a, b, err=name)
    H_ii, H_jj, H_ij, _, _ = jb
    tH_ii, tH_jj, tH_ij, _, _ = tb
    _close(tpg.dense_from_blocks(tH_ii, tH_jj, tH_ij, plans, n),
           jpg.dense_from_blocks(H_ii, H_jj, H_ij, g.edge_i, g.edge_j, n), err="dense")
    _close(tpg.node_diag_blocks(tH_ii, tH_jj, plans),
           jpg.node_diag_blocks(H_ii, H_jj, g.edge_i, g.edge_j, n), err="diag blocks")
    diag = np.random.RandomState(0).rand(n, 6).astype(np.float32)
    _close(tpg.gauge_damping(t.node_mask, torch.from_numpy(diag), torch.tensor(lam)),
           jpg.gauge_damping(g.node_mask, jnp.asarray(diag), jnp.float32(lam)), err="damping")
    H, gv = tpg._assemble(t, torch.tensor(lam), plans)
    jH, jgv = jpg._assemble(g, jnp.float32(lam))
    _close(H, jH, err="assembled H")
    _close(gv, jgv, err="assembled g")
    damp, M = tpg._damping_terms(t, tH_ii, tH_jj, torch.tensor(lam), plans)
    jdamp, jM = jpg._damping_terms(g, H_ii, H_jj, jnp.float32(lam))
    _close(damp, jdamp, err="damp")
    _close(M, jM, err="M")
    v = np.random.RandomState(1).randn(n, 6).astype(np.float32)
    _close(tpg._hvp(tH_ii, tH_jj, tH_ij, plans, t.edge_i, t.edge_j, damp, torch.from_numpy(v)),
           jpg._hvp(H_ii, H_jj, H_ij, g.edge_i, g.edge_j, jdamp, jnp.asarray(v)), err="hvp")
    _close(tpg._cost(t), jpg._cost(g), err="cost")
    dx = (0.01 * np.random.RandomState(2).randn(6 * n)).astype(np.float32)
    _close(tpg._apply_update(t, torch.from_numpy(dx)).poses,
           jpg._apply_update(g, jnp.asarray(dx)).poses, err="update")


def test_pcg_matches_the_dense_solve():
    """tests/test_pose_graph.py::test_cg_matches_dense_solution on the port,
    and the port's CG step against the JAX package's."""
    g, t, _, _ = _graphs(n=14, seed=2)
    n = g.poses.shape[0]
    lam = torch.tensor(1e-3)
    plans = tpg.plans_for(t.edge_i, t.edge_j, n)
    H, gv = tpg._assemble(t, lam, plans)
    dx_dense = -torch.linalg.solve(H.double(), gv.double()).float()
    H_ii, H_jj, H_ij, g2, _ = tpg._edge_blocks(t, plans)
    damp, M = tpg._damping_terms(t, H_ii, H_jj, lam, plans)
    dx_cg = tpg._pcg_solve(H_ii, H_jj, H_ij, plans, t.edge_i, t.edge_j, damp, M, g2, 400)
    np.testing.assert_allclose(dx_cg.reshape(-1).numpy(), dx_dense.numpy(), atol=5e-4)
    jb = jpg._edge_blocks(g)
    jdamp, jM = jpg._damping_terms(g, jb[0], jb[1], jnp.float32(1e-3))
    jdx = jpg._pcg_solve(jb[0], jb[1], jb[2], g.edge_i, g.edge_j, jdamp, jM, jb[3], iters=400)
    np.testing.assert_allclose(dx_cg.numpy(), np.asarray(jdx), atol=5e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_matches_jax(solver):
    n = 12 if solver == "dense" else 16
    g, t, gt, est = _graphs(n=n, seed=0 if solver == "dense" else 3)
    jcfg, tcfg = _cfgs(solver=solver, pcg_iters=128)
    jout, jd = jpg.optimize(g, jcfg)
    tout, td = tpg.optimize(t, tcfg)
    np.testing.assert_allclose(tout.poses.numpy(), np.asarray(jout.poses), atol=POSE_TOL)
    for k in ("initial_cost", "final_cost", "lambda"):
        assert isinstance(td[k], torch.Tensor) and td[k].dim() == 0
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-3, err_msg=k)
    # the JAX tests' own gates, on the port
    assert float(td["final_cost"]) < 0.2 * float(td["initial_cost"])
    np.testing.assert_allclose(tout.poses[0].numpy(), est[0], atol=1e-3)      # gauge-fixed
    np.testing.assert_array_equal(tout.poses[n:].numpy(),                      # masked slots
                                  np.broadcast_to(np.eye(4), (64 - n, 4, 4)))
    err = np.linalg.norm(tout.poses[n - 1, :3, 3].numpy() - gt[n - 1][:3, 3])
    assert err < 0.7 * np.linalg.norm(est[n - 1][:3, 3] - gt[n - 1][:3, 3])


def test_optimize_repeats_bit_for_bit():
    _, t, _, _ = _graphs(n=14, seed=1)
    for solver in ("dense", "cg"):
        cfg = _cfgs(solver=solver, max_iterations=10)[1]
        a, b = tpg.optimize(t, cfg)[0], tpg.optimize(t, cfg)[0]
        assert torch.equal(a.poses, b.poses), solver


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_nan_edge_keeps_the_poses_and_clips_lambda(solver):
    """An edge with a NaN measurement: the JAX package's Cholesky gives NaN,
    ``gn_nan_guard`` zeros the step and lambda grows to its clip; the port's
    ``cholesky_ex`` path does the same, with no exception."""
    g, t, _, _ = _graphs()
    bad = np.array(g.edge_T)
    bad[3, 0, 3] = np.nan
    g = dataclasses.replace(g, edge_T=jnp.asarray(bad))
    t = bridge.pose_graph(g, "cpu")
    jcfg, tcfg = _cfgs(solver=solver)
    jout, jd = jpg.optimize(g, jcfg)
    tout, td = tpg.optimize(t, tcfg)
    assert float(jd["lambda"]) == 1e6
    assert float(td["lambda"]) == 1e6
    np.testing.assert_array_equal(np.asarray(jout.poses), np.asarray(g.poses))
    np.testing.assert_array_equal(tout.poses.numpy(), t.poses.numpy())


def test_unknown_solver_raises():
    _, t, _, _ = _graphs()
    with pytest.raises(ValueError, match="pcg"):
        tpg.optimize(t, _cfgs(solver="pcg")[1])


def test_graph_constructors_match_jax():
    fields = [f.name for f in dataclasses.fields(tpg.PoseGraph)]

    def same(tg, jg):
        for f in fields:
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f)

    same(tpg.create(8, 16, "cpu"), jpg.create(8, 16))
    rng = np.random.RandomState(0)
    poses = rng.randn(5, 4, 4).astype(np.float32)
    T = rng.randn(4, 4, 4).astype(np.float32)
    info = rng.rand(4, 6).astype(np.float32)
    ei, ej = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 4])
    same(tpg.from_arrays(poses, ei, ej, T, info, 8, 16, device="cpu"),
         jpg.from_arrays(poses, ei, ej, T, info, 8, 16))
    same(tpg.from_arrays(poses, ei, ej, T, info, device="cpu"),
         jpg.from_arrays(poses, ei, ej, T, info))
    tg, jg = tpg.create(8, 16, "cpu"), jpg.create(8, 16)
    for k in range(3):
        tg = tpg.add_node(tg, k, poses[k])
        jg = jpg.add_node(jg, k, jnp.asarray(poses[k]))
        tg = tpg.add_edge(tg, k, k, k + 1, T[k], info[k])
        jg = jpg.add_edge(jg, k, k, k + 1, jnp.asarray(T[k]), jnp.asarray(info[k]))
    same(tg, jg)
    # the pose-graph benchmark's problem, built by the port's simulator
    from benchmarks.bench_pose_graph import build_graph
    from cooper_mapper_torch.io import sim

    same(tpg.from_arrays(*sim.drifted_ring_graph(64, loop_every=16), 64, 128, device="cpu"),
         build_graph(64, loop_every=16))


@pytest.mark.parametrize("n_targets", [1, 7, 64])
def test_scatter_plan_is_the_ordered_scatter_add(n_targets):
    """``ScatterPlan.sum`` adds each target's contributions in their order
    in the target list: equal, bit for bit, to a sequential loop."""
    rng = np.random.RandomState(n_targets)
    target = rng.randint(0, n_targets, 300)
    values = rng.randn(300, 6, 6).astype(np.float32)
    want = np.zeros((n_targets, 6, 6), np.float32)
    for k in range(300):
        want[target[k]] += values[k]
    got = tpg.ScatterPlan(torch.from_numpy(target), n_targets).sum(torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), want)
