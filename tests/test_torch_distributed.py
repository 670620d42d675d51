"""The port's process-group glue (``parallel/distributed``, ``parallel/mesh``)
in spawned gloo processes, and tests/test_distributed.py's two-process CG
pose-graph LM against the JAX package's sharded LM at two devices.

Every rank joins through a ``file://`` rendezvous under the test's
temporary directory and runs on one CPU thread; each run has its own time
limit (``tests/torch_parallel_workers.py``).  Tolerances for the LM: the
cost falls below half its initial value (the JAX child's gate), the initial
cost within 1e-4 relative and the positions within 1e-2 of the JAX
package's (TestShardedPoseGraphCg's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import PoseGraphConfig as JPg  # noqa: E402
from cooper_mapper_tpu.ops import pose_graph as jpg  # noqa: E402
from cooper_mapper_tpu.parallel import batch as jbatch  # noqa: E402
from cooper_mapper_tpu.parallel import mesh as jmesh  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch.parallel import distributed  # noqa: E402
from tests import torch_parallel_workers as W  # noqa: E402

CG = dict(max_nodes=16, max_edges=16, max_iterations=4, solver="cg", pcg_iters=24)


@pytest.mark.parametrize("world", [2, 4])
def test_initialize_and_counts(tmp_path, world):
    res = W.run(W.group_facts, world, tmp_path)
    per = 16 // world
    for rank, r in enumerate(res):
        assert r["multihost"] is True
        assert r["slice"] == slice(rank * per, (rank + 1) * per)
        assert r["mesh"] == (world, rank, "cpu", ("batch",))
        # make_mesh(2): a mesh over ranks 0 and 1; the others are outside it
        assert r["sub"] == ((2, rank) if rank < 2 else None)
        assert r["sum"] == world * (world + 1) / 2
        assert r["gathered"] == [k for k in range(world) for _ in range(2)]


def test_single_process_without_a_group():
    assert distributed.local_batch_slice(16) == slice(0, 16)
    assert distributed.is_multihost() is False


def test_torchrun_environment(monkeypatch):
    for k, v in {"MASTER_ADDR": "node0", "MASTER_PORT": "29500", "WORLD_SIZE": "8",
                 "RANK": "5", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    assert distributed._from_env() == ("tcp://node0:29500", 8, 5, 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed._from_env()[3] == 5


def _chain_graph():
    """tests/test_distributed.py's child graph: 12 nodes, 11 noisy odometry
    edges, capacity 16 / 16, made with the JAX package's se3."""
    rng = np.random.RandomState(0)
    graph = jpg.create(CG["max_nodes"], CG["max_edges"])
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(1, 12):
        rel = np.asarray(jse3.se3_exp(jnp.asarray(0.1 * rng.randn(6), jnp.float32)))
        poses.append(poses[-1] @ rel)
        noise = np.asarray(jse3.se3_exp(jnp.asarray(0.05 * rng.randn(6), jnp.float32)))
        graph = jpg.add_node(graph, k, jnp.asarray(poses[k] @ noise))
        graph = jpg.add_edge(graph, k - 1, k - 1, k, jnp.asarray(rel), jnp.ones(6))
    return jpg.add_node(graph, 0, jnp.asarray(poses[0]))


def test_two_process_cg_pose_graph(tmp_path):
    import dataclasses

    graph = _chain_graph()
    arrays = {f.name: np.array(getattr(graph, f.name)) for f in dataclasses.fields(graph)}
    want, wdiag = jbatch.sharded_pose_graph_optimize(graph, JPg(**CG), jmesh.make_mesh(2))
    for r in W.run(W.pose_graph, 2, tmp_path, arrays, CG):
        c0, c1 = float(r["initial_cost"]), float(r["final_cost"])
        assert np.isfinite(c1) and c1 < 0.5 * c0, (c0, c1)
        np.testing.assert_allclose(c0, float(wdiag["initial_cost"]), rtol=1e-4)
        np.testing.assert_allclose(r["poses"][:, :3, 3], np.asarray(want.poses)[:, :3, 3],
                                   atol=1e-2)
