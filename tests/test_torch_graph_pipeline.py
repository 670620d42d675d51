"""Port vs JAX package: ``SlamPipeline`` with ``enable_graph=True`` at
tests/test_pipeline.py's reduced configuration over 5 sweeps of its drive
(``_simulate``), the JAX package's sweeps for both, the JAX pipeline with
op-by-op extraction (tests/torch_pipeline_drives.py says why).

The drive goes straight, so the loop gates are set small enough that the
JAX pipeline closes loops against keyframes a metre back (accumulated
distance 1.0 m, interval 0.5 m, radius 3.0 m, estimated 9.0): the test
asserts that it does, so the comparison covers keyframe gating, candidate
search, ICP, the damped fine match, the loop edges and the LM.  The pose
graph holds 64 nodes / 128 edges (the dense system of the default 1024
would be [6144, 6144] on the CPU).  Tolerances: keyframe and loop flags per
sweep, the loops and the stats() counts equal; merged, graph and corrected
poses and the graph estimates within 2e-3 (tests/test_odometry.py's
tolerance between NN paths); the average score within 1e-3 relative.
(That ``map_mesh`` and ``dynamic_mode`` still raise with the graph on is
tests/test_torch_pipeline.py::test_unported_options_raise.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.models.pipeline import SlamPipeline  # noqa: E402
from tests import torch_pipeline_drives as D  # noqa: E402

N_SWEEPS = 5


def graph_changes(m):
    return dict(enable_graph=True,
                loop=m.LoopConfig(distance_thresh=3.0, estimated_distance_thresh=9.0,
                                  accum_distance_thresh=1.0, min_loop_interval=0.5),
                pose_graph=m.PoseGraphConfig(max_nodes=64, max_edges=128))


@pytest.fixture(scope="module")
def drives():
    sweeps, _ = D.simulate(N_SWEEPS)
    return {"jax": D.drive(False, sweeps, "mapping", **graph_changes(jc))[:2],
            "port": D.drive(True, sweeps, "mapping", **graph_changes(tc))[:2]}


def test_graph_pipeline_closes_the_same_loops(drives):
    (tp, tr), (jp, jr) = drives["port"], drives["jax"]
    assert len(jp.graph.loops) >= 1, "the drive must close a loop in the JAX package"
    assert [(r.new_keyframe, r.loop_closed) for r in tr] == \
        [(r.new_keyframe, r.loop_closed) for r in jr]
    assert [(lp.key_new, lp.key_old) for lp in tp.graph.loops] == \
        [(lp.key_new, lp.key_old) for lp in jp.graph.loops]
    for tl, jl in zip(tp.graph.loops, jp.graph.loops):
        np.testing.assert_allclose(tl.relative, jl.relative, atol=D.POSE_TOL)
    D.check_stats(tp, jp)
    assert tp.stats()["loop_closures"] == len(jp.graph.loops)


def test_graph_pipeline_poses_match_jax(drives):
    (tp, tr), (jp, jr) = drives["port"], drives["jax"]
    assert tr[0].graph_pose is None and jr[0].graph_pose is None
    for k, (g, w) in enumerate(zip(tr[1:], jr[1:]), 1):
        np.testing.assert_allclose(g.merged_pose, w.merged_pose, atol=D.POSE_TOL, err_msg=k)
        np.testing.assert_allclose(g.graph_pose, w.graph_pose, atol=D.POSE_TOL, err_msg=k)
        assert g.graph_pose.dtype == np.float32
    np.testing.assert_allclose(tp.graph.estimates(), jp.graph.estimates(), atol=D.POSE_TOL)
    np.testing.assert_allclose(tp.graph.T_odom2graph, jp.graph.T_odom2graph, atol=D.POSE_TOL)
    assert np.linalg.norm(tp.graph.T_odom2graph - np.eye(4)) > 1e-6
    corrected = tp.corrected_trajectory()
    assert corrected.shape == (N_SWEEPS, 4, 4)
    np.testing.assert_allclose(corrected, jp.corrected_trajectory(), atol=D.POSE_TOL)
    np.testing.assert_allclose(np.stack(tp.graph_trajectory), np.stack(jp.graph_trajectory),
                               atol=D.POSE_TOL)
    assert tp.timer.calls["graph"] == sum(r.mapping_success is not None for r in tr)


def test_graph_on_builds_a_graph_and_off_builds_none():
    on = SlamPipeline(D.small_cfg(tc, **graph_changes(tc)), device="cpu")
    off = SlamPipeline(D.small_cfg(tc), device="cpu")
    assert on.graph is not None and on.graph.device.type == "cpu"
    assert off.graph is None
    assert "keyframes" in on.stats() and "keyframes" not in off.stats()

