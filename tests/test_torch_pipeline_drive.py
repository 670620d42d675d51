"""Port vs JAX package: ``SlamPipeline`` in "mapping" mode with the cube map
re-deduplicated after every solve (``dedup_stride=1``), at
tests/test_pipeline.py's reduced configuration over its 6-sweep drive
(``_simulate(6)``).

Both packages get the JAX simulator's sweeps; the JAX pipeline extracts
features op by op (tests/torch_pipeline_drives.py says why).  Tolerances:
every merged, odometry and mapped pose within 2e-3 (the tolerance between
NN paths in tests/test_odometry.py), mapping gates and stats() counts
equal, the average score within 1e-3 relative, and the ground truth within
tests/test_pipeline.py's ATE bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_tpu.io import evaluation  # noqa: E402
from tests import torch_pipeline_drives as D  # noqa: E402

N_SWEEPS = 6


@pytest.fixture(scope="module")
def sweeps():
    return D.simulate(N_SWEEPS)


@pytest.fixture(scope="module")
def mapping(sweeps):
    return {name: D.drive(port, sweeps[0], "mapping", dedup_stride=1)
            for name, port in (("jax", False), ("port", True))}


def test_mapping_poses_and_stats_match_jax(mapping):
    (tp, tr, _), (jp, jr, _) = mapping["port"], mapping["jax"]
    D.check_results(tr, jr)
    D.check_stats(tp, jp)
    st = tp.stats()
    assert st["mapping_solves"] == 3 and st["match_count"] >= 1
    assert tp.timer.calls["dedup"] == jp.timer.calls["dedup"] == 3
    np.testing.assert_allclose(np.stack(tp.trajectory), np.stack(jp.trajectory), atol=D.POSE_TOL)
    np.testing.assert_allclose(tp.corrected_trajectory(), np.stack(tp.trajectory))


def test_mapping_tracks_ground_truth(mapping, sweeps):
    # tests/test_pipeline.py::TestSlamPipeline's bound
    tp = mapping["port"][0]
    gt = sweeps[1]
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])
    est = np.stack(tp.trajectory)
    assert evaluation.ate(est[:, :3, 3], gt_rel[:, :3, 3]).rmse < 0.12
    assert int(tp.single_map_state().surf.count.sum()) > 2000


def test_mapping_map_after_dedup_matches_jax(mapping):
    tm, jm = mapping["port"][0].map_state, mapping["jax"][0].map_state
    np.testing.assert_array_equal(tm.origin.numpy(), np.asarray(jm.origin))
    for ct, cj in ((tm.corner, jm.corner), (tm.surf, jm.surf)):
        n_t, n_j = int(ct.count.sum()), int(np.asarray(cj.count).sum())
        # the poses differ by up to ~1e-5, so a handful of points may land in
        # a neighbouring voxel; the maps hold the same number of points to 0.5%
        assert abs(n_t - n_j) <= 0.005 * n_j, (n_t, n_j)


