"""Port vs JAX package: the demo scripts (``examples/demo_*.py``,
``examples/bayes_filter_tutorial.py`` and their ports in
``cooper_mapper_torch/examples/``) at a reduced size.

The JAX scripts are loaded by path, unedited.  Both packages' scripts get
the same reduction patched into their module namespaces
(``torch_example_drives.reduced_demo``: every sweep at 256 columns, small
feature, map and frame capacities; the port's scripts get the JAX
simulator's sweeps of the same worlds and poses), every ``SlamPipeline``
they build is recorded, and the JAX pipelines extract features op by op.  Trajectories
agree within 2e-3 m.  ``demo_graph_slam`` runs at ``noise=0``, where the
two packages' noise draws cannot differ.  ``demo_localization``'s test is
in tests/test_torch_demos_localization.py.
"""

import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.models import graph as jgraph  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.examples import (  # noqa: E402
    bayes_filter_tutorial as tbayes, demo_graph_slam as tgraph, demo_mapping as tmapping,
    demo_wander as twander,
)
from tests import torch_example_drives as E  # noqa: E402

WIDTH = 256


def drive(jmod, tmod, jcall, tcall):
    """Both demos under the same reduction; returns (JAX pipelines, port's,
    JAX result, port's)."""
    pj, pt = [], []
    with E.reduced_demo(jmod, jc, WIDTH, pj), E.D.op_by_op_extraction():
        rj = jcall()
    with E.reduced_demo(tmod, tc, WIDTH, pt):
        rt = tcall()
    assert len(pj) == len(pt) > 0
    for a, b in zip(pj, pt):
        E.assert_same_trajectory(a.trajectory, b.trajectory)
        assert b.device.type == "cpu"
    return pj, pt, rj, rt


def test_demo_mapping_matches_jax(tmp_path):
    jmod = E.load_example("demo_mapping")
    pj, pt, _, (_, stats) = drive(jmod, tmapping,
                                  lambda: jmod.main(4, str(tmp_path / "jax")),
                                  lambda: tmapping.main(4, str(tmp_path / "torch"), device="cpu"))
    assert pt[0].stats()["mapping_solves"] == pj[0].stats()["mapping_solves"] == 2
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert np.isfinite(stats.rmse)


def test_demo_graph_slam_matches_jax(tmp_path, monkeypatch):
    jmod = E.load_example("demo_graph_slam")
    for mod in (jmod, tgraph):
        monkeypatch.setattr(mod, "simulate_loop",
                            functools.partial(mod.simulate_loop, n_sweeps=6, noise=0.0))
    # the JAX demo saves to a fixed directory: redirect it here
    save = jgraph.GraphSlam.save
    monkeypatch.setattr(jgraph.GraphSlam, "save",
                        lambda self, d, *a, **kw: save(self, str(tmp_path / "jax"), *a, **kw))
    pj, pt, _, (_, ate) = drive(jmod, tgraph, jmod.main,
                                lambda: tgraph.main(str(tmp_path / "torch"), device="cpu"))
    gj, gt = pj[0].graph, pt[0].graph
    assert len(gt.keyframes) == len(gj.keyframes) > 1
    np.testing.assert_allclose(gt.estimates(), np.asarray(gj.estimates()), atol=E.POSE_TOL)
    np.testing.assert_allclose(pt[0].corrected_trajectory(),
                               np.asarray(pj[0].corrected_trajectory()), atol=E.POSE_TOL)
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert all(np.isfinite(v) for v in ate.values())


def test_simulate_loop_without_noise_matches_jax():
    jmod = E.load_example("demo_graph_slam")
    sj, gj, _ = jmod.simulate_loop(n_sweeps=2, noise=0.0, width=64)
    st, gt, _ = tgraph.simulate_loop(n_sweeps=2, noise=0.0, width=64, device="cpu")
    np.testing.assert_array_equal(gt, gj)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz), atol=1e-4)
    # with noise the port draws from a torch.Generator: seeded, repeatable
    n1, _, _ = tgraph.simulate_loop(n_sweeps=1, width=64, device="cpu")
    n2, _, _ = tgraph.simulate_loop(n_sweeps=1, width=64, device="cpu")
    assert torch.equal(n1[0].xyz, n2[0].xyz) and not torch.equal(n1[0].xyz, st[0].xyz)


def test_demo_wander_matches_jax():
    jmod = E.load_example("demo_wander")
    pj, pt, _, (_, stats) = drive(jmod, twander, lambda: jmod.main(4),
                                  lambda: twander.main(4, device="cpu"))
    assert len(pt[0].trajectory) == 4 and np.isfinite(stats.rmse)
    # the controller: the same step from the same pose in both worlds
    from cooper_mapper_tpu.io import sim as jsim
    from cooper_mapper_torch.io import sim as tsim

    wj = jsim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=4)
    wt = tsim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=4, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[1, 3] = 1.5
    for _ in range(6):
        nj, nt = jmod.wander_step(wj, pose), twander.wander_step(wt, pose)
        np.testing.assert_allclose(nt, nj, atol=1e-5)
        pose = nt
    for key in "wasdx":
        np.testing.assert_array_equal(twander.teleop_step(pose, key),
                                      jmod.teleop_step(pose, key))


def test_teleop_matches_jax(monkeypatch):
    # the key loop with stdin not a tty (the line-input fallback): w, w, d,
    # an ignored key, a, then q ends the drive
    jmod = E.load_example("demo_wander")
    room = dict(size=(24.0, 4.0, 30.0), n_pillars=6, seed=4)
    keys = "wwdxa q w\n"
    pj, pt = [], []
    with E.reduced_demo(jmod, jc, WIDTH, pj), E.D.op_by_op_extraction():
        monkeypatch.setattr("sys.stdin", io.StringIO(keys))
        jmod.teleop(_wander_cfg(jc, jmod), jmod.sim.make_room_world(**room))
    with E.reduced_demo(twander, tc, WIDTH, pt):
        monkeypatch.setattr("sys.stdin", io.StringIO(keys))
        twander.teleop(twander._cfg(), twander.sim.make_room_world(**room, device="cpu"))
    assert len(pt[0].trajectory) == len(pj[0].trajectory) == 4
    E.assert_same_trajectory(pj[0].trajectory, pt[0].trajectory)


def _wander_cfg(m, mod):
    """The JAX demo's teleop configuration (its __main__ block), built with
    the module's (patched) config classes."""
    return m.PipelineConfig(
        registration=mod.RegistrationConfig(n_rings=16, max_points_per_ring=768),
        scan_match=m.ScanMatchConfig(score_threshold=50.0),
        feature_map=mod.MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=2048,
                                  surf_cube_capacity=4096, surround_corner_capacity=8192,
                                  surround_surf_capacity=16384, valid_distance=60.0),
        matcher=mod.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096),
        mapping_stride=2)


def test_bayes_filter_posteriors_equal(capsys):
    jmod = E.load_example("bayes_filter_tutorial")
    outs = []
    for mod in (jmod, tbayes):
        p1, p2 = mod.demo_1d(), mod.demo_2d()
        outs.append((p1, p2, capsys.readouterr().out))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
