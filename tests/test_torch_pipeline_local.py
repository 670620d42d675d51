"""Port vs JAX package: ``SlamPipeline`` in "local" mode (the sliding-window
map) over the 6-sweep drive of tests/test_pipeline.py::TestLocalPipeline, at
the reduced configuration of tests/test_pipeline.py.

Both packages get the JAX simulator's sweeps; the JAX pipeline extracts
features op by op (tests/torch_pipeline_drives.py says why).  Tolerances:
every merged, odometry and mapped pose within 2e-3 (the tolerance between
NN paths in tests/test_odometry.py), mapping gates, stats() counts and the
window's masks equal, the average score within 1e-3 relative, and
TestLocalPipeline's ATE bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_tpu.io import evaluation  # noqa: E402
from tests import torch_pipeline_drives as D  # noqa: E402


@pytest.fixture(scope="module")
def local_drive():
    sweeps, gt = D.simulate(6)
    return {"jax": D.drive(False, sweeps, "local"), "port": D.drive(True, sweeps, "local"),
            "gt": gt}


def test_local_mode_matches_jax(local_drive):
    (tp, tr, _), (jp, jr, _) = local_drive["port"], local_drive["jax"]
    D.check_results(tr, jr)
    D.check_stats(tp, jp)
    for f in ("frame_valid", "head", "corner_mask", "surf_mask"):
        np.testing.assert_array_equal(getattr(tp.map_state, f).numpy(),
                                      np.asarray(getattr(jp.map_state, f)))
    # TestLocalPipeline's ATE bound
    gt = local_drive["gt"]
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])
    est = np.stack([r.merged_pose for r in tr])
    assert evaluation.ate(est[:, :3, 3], gt_rel[:, :3, 3]).rmse < 0.15
