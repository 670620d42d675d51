"""Shared drives of the SlamPipeline parity tests
(tests/test_torch_pipeline_*.py): tests/test_pipeline.py's reduced
configuration and simulated drive, the JAX pipeline with op-by-op feature
extraction, and a drive loop for either package.

Under ``jit`` XLA re-associates the curvature sums and reorders exact
curvature ties on the flat floor (ROADMAP.md Queue 3), which moves poses by
up to ~1e-3; the port equals the op-by-op evaluation.  So the JAX pipeline
runs with ``feat_ops.extract_features`` replaced, for the drive only, by
``features._extract_impl`` outside ``jit``; its other stages stay jitted.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cooper_mapper_tpu import config as jc
from cooper_mapper_tpu.fusion import imu_queue as jiq
from cooper_mapper_tpu.io import sim as jsim
from cooper_mapper_tpu.models import pipeline as jpipe
from cooper_mapper_tpu.ops import features as jfeat
from cooper_mapper_torch import bridge
from cooper_mapper_torch import config as tc
from cooper_mapper_torch.fusion import imu_queue as tiq
from cooper_mapper_torch.models import pipeline as tpipe

POSE_TOL = 2e-3      # between NN paths, tests/test_odometry.py
FUSED_TOL = 1e-4


def small_cfg(m, **changes):
    """tests/test_pipeline.py::_small_cfg for the config module ``m``."""
    cfg = m.PipelineConfig(
        registration=m.RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=m.ScanMatchConfig(score_threshold=50.0),
        feature_map=m.MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                                surf_cube_capacity=2048, surround_corner_capacity=8192,
                                surround_surf_capacity=16384, valid_distance=60.0),
        matcher=m.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096),
        mapping_stride=2)
    return dataclasses.replace(cfg, **changes)


def seed_pose():
    """A localization seed 0.1 m / 0.01 rad off the start (identity)."""
    c, s = np.cos(0.01), np.sin(0.01)
    return np.array([[c, 0, s, 0.1], [0, 1, 0, -0.05], [-s, 0, c, 0.05], [0, 0, 0, 1]],
                    np.float32)


def simulate(n_sweeps, width=768, speed=0.35, yaw_rate=0.02):
    """tests/test_pipeline.py::_simulate: the JAX simulator's sweeps and the
    start poses."""
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=21)
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    c, s = np.cos(yaw_rate), np.sin(yaw_rate)
    step = np.array([[c, 0, s, 0.2 * speed], [0, 1, 0, 0], [-s, 0, c, speed], [0, 0, 0, 1]],
                    np.float32)
    for _ in range(n_sweeps):
        poses.append(poses[-1] @ step)
    sweeps = [jsim.scan_sweep(world, jnp.asarray(poses[i]), jnp.asarray(poses[i + 1]),
                              n_rings=16, width=width) for i in range(n_sweeps)]
    return sweeps, np.stack(poses[:n_sweeps])


@contextlib.contextmanager
def op_by_op_extraction():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.feat_ops, "extract_features",
                   lambda sweep, cfg: jfeat._extract_impl(sweep, cfg)[0])
        yield


def imu_window(i, port):
    """TestImuFusion's IMU window for sweep i: 10 samples of zero acc and
    gyro over the 0.1 s that ends at the sweep's stamp."""
    stamp = 0.1 * (i + 1)
    if port:
        st = torch.linspace(stamp - 0.1, stamp, 10, dtype=torch.float64).to(torch.float32)
        return stamp, tiq.ImuBatch(st, torch.zeros(10, 3), torch.zeros(10, 3),
                                   torch.ones(10, dtype=torch.bool))
    st = jnp.linspace(stamp - 0.1, stamp, 10).astype(jnp.float32)
    return stamp, jiq.ImuBatch(st, jnp.zeros((10, 3)), jnp.zeros((10, 3)), jnp.ones(10, bool))


def config(m, dedup_stride=None, **changes):
    """small_cfg, with the matcher's dedup_stride replaced where given."""
    cfg = small_cfg(m, **changes)
    if dedup_stride is None:
        return cfg
    return dataclasses.replace(cfg, matcher=dataclasses.replace(cfg.matcher,
                                                                dedup_stride=dedup_stride))


def drive(port, sweeps, mode, imu=False, map_state=None, initial_pose=None, **changes):
    """SlamPipeline of the port (on the CPU) or of the JAX package over the
    sweeps, at ``config(**changes)``.  Returns (pipeline, results, the last
    IMU window or None)."""
    if port:
        pipe = tpipe.SlamPipeline(config(tc, **changes), mode, map_state=map_state,
                                  initial_pose=initial_pose, device="cpu")
        sweeps = [bridge.sweep(s, "cpu") for s in sweeps]
        ctx = contextlib.nullcontext()
    else:
        pipe = jpipe.SlamPipeline(config(jc, **changes), mode, map_state=map_state,
                                  initial_pose=initial_pose)
        ctx = op_by_op_extraction()
    results, window = [], None
    with ctx:
        for i, s in enumerate(sweeps):
            if imu:
                stamp, window = imu_window(i, port)
                results.append(pipe.process(s, imu=window, stamp=stamp))
            else:
                results.append(pipe.process(s))
    return pipe, results, window


def check_results(got, want, tol=POSE_TOL):
    """Per sweep: merged, odometry and mapped poses within ``tol``; the
    mapping gates and matched counts equal."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.merged_pose, w.merged_pose, atol=tol, err_msg=f"sweep {k}")
        np.testing.assert_allclose(g.odom_pose, w.odom_pose, atol=tol, err_msg=f"sweep {k}")
        assert (g.mapped_pose is None) == (w.mapped_pose is None)
        if w.mapped_pose is not None:
            np.testing.assert_allclose(g.mapped_pose, w.mapped_pose, atol=tol)
        assert g.mapping_success == w.mapping_success, k
        assert g.graph_pose is None and w.graph_pose is None


def check_stats(got, want):
    """stats(): every count equal, the average score within 1e-3 relative
    (each solve's score sums weighted residuals over thousands of points,
    and moves by ~3e-4 relative when the poses agree to ~1e-5)."""
    g, w = got.stats(), want.stats()
    assert g.keys() == w.keys()
    for k in w:
        if k == "average_score":
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
        else:
            assert g[k] == w[k], k
