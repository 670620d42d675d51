"""Port vs JAX package: the sharded and bucketed batch solves and the
edge-sharded pose-graph LM (``parallel/batch``, ``parallel/mesh``).

The port runs in gloo groups of 1, 2 and 4 spawned CPU processes
(``tests/torch_parallel_workers.py``); the JAX package runs on conftest's
8-device virtual mesh cut to the same number of devices.  The problems are
tests/test_parallel.py's.  Tolerances:

- sharded odometry: every lane within 1e-4 of the port's unsharded batch
  solve and lane 0 of its ``odometry_solve`` (the JAX test's claim), within
  2e-3 of the JAX package's ``sharded_odometry_solve`` (the tolerance
  between the packages' nearest-neighbour paths, tests/test_odometry.py);
  the sharded scan match within 1e-4 of the unsharded one;
- one rank: every sharded solve bit-identical to the unsharded port (the
  all-reduce over one rank is the identity);
- the bucket plan's dispatch tuples equal to the JAX package's; bucketed
  poses within 2e-4 of the full-capacity batch solve with ``n_matched``
  equal (TestBucketedOdometry);
- the sharded LM against the JAX package's at the same number of devices:
  the initial cost within 1e-4 relative, dense poses within 5e-3, CG
  positions within 1e-2, the final cost below 0.2 of the initial one
  (TestShardedPoseGraph, TestShardedPoseGraphCg).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import OdometryConfig as JOdo  # noqa: E402
from cooper_mapper_tpu.config import PoseGraphConfig as JPg  # noqa: E402
from cooper_mapper_tpu.parallel import batch as jbatch  # noqa: E402
from cooper_mapper_tpu.parallel import mesh as jmesh  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import OdometryConfig, ScanMatchConfig  # noqa: E402
from cooper_mapper_torch.ops import odometry as todo  # noqa: E402
from cooper_mapper_torch.ops import scan_match as tsm  # noqa: E402
from cooper_mapper_torch.parallel import batch as tbatch  # noqa: E402
from cooper_mapper_torch.parallel import mesh as tmesh  # noqa: E402
from tests import test_odometry as to  # noqa: E402
from tests import test_parallel as tpar  # noqa: E402
from tests import test_pose_graph as tpg  # noqa: E402
from tests import torch_parallel_workers as W  # noqa: E402

B, SM_B, ODO_ITERS, SM_ITERS = 4, 4, 10, 4
SHARD_TOL, JAX_TOL, BUCKET_TOL = 1e-4, 2e-3, 2e-4
PG = dict(max_nodes=64, max_edges=128, max_iterations=15)
PG_CG = dict(PG, solver="cg", pcg_iters=128)


@pytest.fixture(scope="module")
def problem():
    """TestShardedOdometry's sweep pair, tiled to B lanes with distinct
    priors (10 GN iterations: two correspondence refreshes), its frame's
    sharp / flat features against the previous sweep's for the scan match,
    and TestShardedPoseGraph's graphs, as numpy."""
    fp, fc, _ = to._sweep_pair(jnp.asarray(to._pose(x=0.25, y=0.0, z=0.35)))
    tile = lambda c, n: {k: np.ascontiguousarray(np.broadcast_to(v, (n,) + v.shape))
                         for k, v in W.cloud_arrays(c).items()}
    odo = [tile(c, B) for c in (fc.sharp, fc.flat, fp.less_sharp, fp.less_flat)]
    rng = np.random.RandomState(0)
    x0 = (0.01 * rng.randn(B, 6)).astype(np.float32)
    sm = ([tile(c, SM_B) for c in (fc.sharp, fc.flat)]
          + [W.cloud_arrays(c) for c in (fp.less_sharp, fp.less_flat)])
    sm_x0 = (0.01 * rng.randn(SM_B, 6)).astype(np.float32)
    graphs = {"dense": tpg._noisy_circle_graph()[0], "cg": tpg._noisy_circle_graph(seed=5)[0]}
    graph_arrays = {k: {f.name: np.array(getattr(g, f.name)) for f in dataclasses.fields(g)}
                    for k, g in graphs.items()}
    return dict(odo=odo, x0=x0, sm=sm, sm_x0=sm_x0, graphs=graphs, graph_arrays=graph_arrays)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def ranks(request, problem, tmp_path_factory):
    n = request.param
    jobs = {"odometry": ("odometry", (problem["odo"], problem["x0"], ODO_ITERS)),
            "scan_match": ("scan_match", (problem["sm"], problem["sm_x0"], SM_ITERS)),
            "dense": ("pose_graph", (problem["graph_arrays"]["dense"], PG)),
            "cg": ("pose_graph", (problem["graph_arrays"]["cg"], PG_CG))}
    return n, W.run(W.suite, n, tmp_path_factory.mktemp(f"batch{n}"), jobs)


@pytest.fixture(scope="module")
def unsharded(problem):
    """The port's unsharded solves of the same problems, in this process."""
    torch.set_num_threads(1)
    cl = [W.port_cloud(c) for c in problem["odo"]]
    x0 = torch.from_numpy(problem["x0"])
    x, _ = todo.batch_odometry_solve(*cl, x0, OdometryConfig(max_iterations=ODO_ITERS))
    one = lambda c: dataclasses.replace(c, **{k: getattr(c, k)[0] for k in W.CLOUD_FIELDS})
    x_one, _ = todo.odometry_solve(*(one(c) for c in cl), x0[0],
                                   OdometryConfig(max_iterations=ODO_ITERS))
    sm = tsm.batch_scan_match(*(W.port_cloud(c) for c in problem["sm"]),
                              torch.from_numpy(problem["sm_x0"]),
                              ScanMatchConfig(max_iterations=SM_ITERS))
    return dict(x=x.numpy(), x_one=x_one.numpy(), sm_x=sm.x.numpy(),
                sm_success=sm.success.numpy())


def bridge_back(d):
    """A dict of arrays as the JAX package's Cloud."""
    from cooper_mapper_tpu.utils.cloud import Cloud

    return Cloud(*(jnp.asarray(d[f]) for f in W.CLOUD_FIELDS))


def test_sharded_odometry(ranks, problem, unsharded):
    n, res = ranks
    if n > 1:
        want, _ = jbatch.sharded_odometry_solve(
            *(bridge_back(c) for c in problem["odo"]), jnp.asarray(problem["x0"]),
            JOdo(max_iterations=ODO_ITERS),
            jmesh.make_mesh(n))
    for rank in res:
        got = rank["odometry"]
        np.testing.assert_allclose(got["x"], unsharded["x"], atol=SHARD_TOL)
        np.testing.assert_allclose(got["x"][0], unsharded["x_one"], atol=SHARD_TOL)
        if n == 1:
            np.testing.assert_array_equal(got["x"], got["x_single"])
            np.testing.assert_array_equal(got["n_matched"], got["n_matched_single"])
        else:
            np.testing.assert_allclose(got["x"], np.asarray(want), atol=JAX_TOL)


def test_sharded_scan_match(ranks, unsharded):
    n, res = ranks
    for rank in res:
        got = rank["scan_match"]
        np.testing.assert_allclose(got["res"]["x"], unsharded["sm_x"], atol=SHARD_TOL)
        np.testing.assert_array_equal(got["res"]["success"], unsharded["sm_success"])
        if n == 1:
            for k, v in got["single"].items():
                np.testing.assert_array_equal(got["res"][k], v, err_msg=k)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_sharded_pose_graph(ranks, problem, solver):
    n, res = ranks
    if n > 1:
        cfg = JPg(**(PG if solver == "dense" else PG_CG))
        want, wdiag = jbatch.sharded_pose_graph_optimize(problem["graphs"][solver], cfg,
                                                         jmesh.make_mesh(n))
    for rank in res:
        got = rank[solver]
        c0, c1 = float(got["initial_cost"]), float(got["final_cost"])
        assert c1 < 0.2 * c0
        if n == 1:
            for k, v in got["single"].items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            continue
        np.testing.assert_allclose(c0, float(wdiag["initial_cost"]), rtol=1e-4)
        if solver == "dense":
            np.testing.assert_allclose(got["poses"][:12], np.asarray(want.poses)[:12], atol=5e-3)
        else:
            np.testing.assert_allclose(got["poses"][:12, :3, 3],
                                       np.asarray(want.poses)[:12, :3, 3], atol=1e-2)


# ---- the capacity buckets (one device) --------------------------------------

@pytest.fixture(scope="module")
def hetero():
    """TestBucketedOdometry's heterogeneous batch (6 problems, keep fractions
    1.0 / 0.6 / 0.25) for both packages, and its reference surf clouds with
    the points scattered (not front-packed)."""
    jclouds = tpar.TestBucketedOdometry()._hetero_batch()
    perm = np.random.RandomState(7).permutation(jclouds[3].capacity)
    scattered = jclouds[:3] + (bridge_back({f: np.asarray(getattr(jclouds[3], f))[:, perm]
                                            for f in W.CLOUD_FIELDS}),)
    port = lambda cs: tuple(bridge.cloud(c, "cpu") for c in cs)
    return {"packed": (jclouds, port(jclouds)), "scattered": (scattered, port(scattered))}


@pytest.mark.parametrize("layout", ["packed", "scattered"])
def test_bucket_plan_equals_jax(hetero, layout):
    jclouds, tclouds = hetero[layout]
    want = jbatch.bucket_plan(*jclouds, granule=128, chunk=4)
    got = tbatch.bucket_plan(*tclouds, granule=128, chunk=4)
    assert got[0] == want[0] == (layout == "packed")
    assert len(got[1]) == len(want[1]) >= 2
    for (caps, take_n, sl, idx), (wcaps, wtake, wsl, widx) in zip(got[1], want[1]):
        assert (caps, take_n, sl) == (wcaps, wtake, wsl)
        np.testing.assert_array_equal(idx, widx)
        assert idx.dtype == widx.dtype


@pytest.mark.parametrize("layout", ["packed", "scattered"])
def test_bucketed_matches_full_capacity_solve(hetero, layout):
    torch.set_num_threads(1)
    tclouds = hetero[layout][1]
    cfg = OdometryConfig(max_iterations=8)
    x0 = torch.from_numpy((0.02 * np.random.RandomState(0).randn(6, 6)).astype(np.float32))
    xb, stb = tbatch.bucketed_odometry_solve(*tclouds, x0, cfg, granule=128, chunk=4)
    xf, stf = todo.batch_odometry_solve(*tclouds, x0, cfg)
    np.testing.assert_allclose(xb.numpy(), xf.numpy(), atol=BUCKET_TOL)
    np.testing.assert_array_equal(stb.n_matched.numpy(), stf.n_matched.numpy())
    if layout == "packed":
        xs, none = tbatch.bucketed_odometry_solve(*tclouds, x0, cfg, granule=128, chunk=4,
                                                  with_states=False)
        assert none is None
        np.testing.assert_array_equal(xs.numpy(), xb.numpy())


def test_bucket_signatures_and_order(hetero):
    """Distinct sizes land in distinct buckets; results come back in input
    order: the first and last problems against their single solves."""
    torch.set_num_threads(1)
    tclouds = hetero["packed"][1]
    counts = tclouds[3].mask.sum(-1).tolist()
    assert len({tbatch._bucket_cap(n, 128) for n in counts}) >= 2
    cfg = OdometryConfig(max_iterations=4)
    x0 = torch.from_numpy((0.02 * np.random.RandomState(1).randn(6, 6)).astype(np.float32))
    plan = tbatch.bucket_plan(*tclouds, granule=128, chunk=4)
    xb, _ = tbatch.bucketed_odometry_solve(*tclouds, x0, cfg, plan=plan)
    for p in (0, 5):
        one = [dataclasses.replace(c, **{k: getattr(c, k)[p] for k in W.CLOUD_FIELDS})
               for c in tclouds]
        xs, _ = todo.odometry_solve(*one, x0[p], cfg)
        np.testing.assert_allclose(xb[p].numpy(), xs.numpy(), atol=BUCKET_TOL)


# ---- the mesh's layouts (no group needed) -----------------------------------

def test_shard_batch_replicated_and_raises():
    mesh = tmesh.Mesh(None, 2, 1, torch.device("cpu"))
    c = W.port_cloud({"xyz": np.arange(24, dtype=np.float32).reshape(4, 2, 3),
                      "mask": np.ones((4, 2), bool), "ring": np.zeros((4, 2), np.int32),
                      "rel_time": np.zeros((4, 2), np.float32)})
    got = tmesh.shard_batch((c, torch.arange(4)), mesh)
    assert got[0].xyz.tolist() == c.xyz[2:].tolist() and got[1].tolist() == [2, 3]
    assert tmesh.replicated({"a": c}, mesh)["a"].xyz.shape == (4, 2, 3)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(torch.zeros(5, 3), mesh)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh()
    with pytest.raises(ValueError, match="does not divide"):
        tbatch.sharded_pose_graph_optimize(
            bridge.pose_graph(tpg._noisy_circle_graph()[0], "cpu"),
            tbatch.PoseGraphConfig(**PG), tmesh.Mesh(None, 3, 0, torch.device("cpu")))
