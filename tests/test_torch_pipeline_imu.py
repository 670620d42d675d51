"""Port vs JAX package: ``SlamPipeline`` with IMU fusion
(tests/test_pipeline.py::TestImuFusion: 5 sweeps, a map solve on every
sweep, no predict cool-down, a 10-sample window of zero acc / gyro per
sweep) at the reduced configuration of tests/test_pipeline.py.

Both packages get the JAX simulator's sweeps; the JAX pipeline extracts
features op by op (tests/torch_pipeline_drives.py says why).  Tolerances:
every merged, odometry and mapped pose within 2e-3 (the tolerance between
NN paths in tests/test_odometry.py), mapping gates and stats() counts
equal, the average score within 1e-3 relative; the fused UKF pose and the
IMU-rate poses within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests import torch_pipeline_drives as D  # noqa: E402


@pytest.fixture(scope="module")
def imu_drive():
    sweeps, _ = D.simulate(5)
    out = {}
    for name, port, m in (("jax", False, D.jc), ("port", True, D.tc)):
        out[name] = D.drive(port, sweeps, "mapping", imu=True, mapping_stride=1,
                            ukf=m.UKFConfig(cool_time_duration=0.0))
    return out


def test_imu_drive_poses_and_stats_match_jax(imu_drive):
    (tp, tr, _), (jp, jr, _) = imu_drive["port"], imu_drive["jax"]
    D.check_results(tr, jr)
    D.check_stats(tp, jp)
    assert tp.timer.calls["ukf"] == 4          # every sweep after the first


def test_fused_pose_matches_jax(imu_drive):
    (tp, tr, window), (jp, _, jwindow) = imu_drive["port"], imu_drive["jax"]
    fused = tp.fused_pose()
    np.testing.assert_allclose(fused, jp.fused_pose(), rtol=0, atol=D.FUSED_TOL)
    np.testing.assert_allclose(tp.ukf.ukf.mean.numpy(), np.asarray(jp.ukf.ukf.mean), rtol=0,
                               atol=D.FUSED_TOL)
    # TestImuFusion's own bounds
    assert np.linalg.norm(fused[:3, 3] - tr[-1].merged_pose[:3, 3]) < 0.5
    poses, valid = tp.imu_rate_poses(window)
    jposes, jvalid = jp.imu_rate_poses(jwindow)
    assert poses.shape == (10, 4, 4) and np.all(np.isfinite(poses))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_allclose(poses, np.asarray(jposes), rtol=0, atol=D.FUSED_TOL)
