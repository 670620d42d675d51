"""Port vs JAX package: ``SlamPipeline`` in "localization" mode at
tests/test_pipeline.py's reduced configuration over its 6-sweep drive
(``_simulate(6)``), on the map the JAX pipeline builds in "mapping" mode
over the same drive, seeded 0.1 m / 0.01 rad off (``initial_pose``).

Both packages get the JAX simulator's sweeps and the same map (the JAX
run's, bridged); the JAX pipeline extracts features op by op
(tests/torch_pipeline_drives.py says why).  Tolerances: every merged,
odometry and mapped pose within 2e-3 (the tolerance between NN paths in
tests/test_odometry.py), mapping gates and stats() counts equal, the
average score within 1e-4 relative; the map is never written.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_torch import bridge  # noqa: E402
from tests import torch_pipeline_drives as D  # noqa: E402


@pytest.fixture(scope="module")
def localization():
    sweeps, gt = D.simulate(6)
    jmap = D.drive(False, sweeps, "mapping")[0].map_state
    seed = D.seed_pose()
    tmap = bridge.feature_map_state(jmap, "cpu")
    return {"jax": D.drive(False, sweeps, "localization", map_state=jmap, initial_pose=seed),
            "port": D.drive(True, sweeps, "localization", map_state=tmap, initial_pose=seed),
            "seed": seed, "jax_map": jmap,
            "truth": np.stack([np.linalg.inv(gt[0]) @ g for g in gt])}


def test_localization_matches_jax(localization):
    (tp, tr, _), (jp, jr, _) = localization["port"], localization["jax"]
    D.check_results(tr, jr)
    D.check_stats(tp, jp)
    np.testing.assert_array_equal(tr[0].merged_pose, localization["seed"])
    assert tp.stats()["match_count"] >= 2
    assert "dedup" not in tp.timer.calls


def test_localization_leaves_the_map_unchanged(localization):
    jm, tm = localization["jax_map"], localization["port"][0].map_state
    for ct, cj in ((tm.corner, jm.corner), (tm.surf, jm.surf)):
        np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
        np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))


def _steady_errors(results, truth):
    """Mean position error from the third sweep on: over every merged pose,
    and over the solved sweeps' mapped poses only."""
    err = lambda T, k: float(np.linalg.norm(T[:3, 3] - truth[k][:3, 3]))
    every = [err(r.merged_pose, k) for k, r in enumerate(results)][2:]
    solved = [err(r.mapped_pose, k) for k, r in enumerate(results)
              if k >= 2 and r.mapped_pose is not None]
    return float(np.mean(every)), float(np.mean(solved)), len(solved)


def test_steady_error_matches_jax(localization):
    """The localization pipeline's steady error, over every sweep and over
    the solved sweeps only (at mapping_stride 2, sweeps 3 and 5 carry merged
    poses that odometry alone predicted), is the JAX package's within 2e-3,
    and under half the seed error in both."""
    truth = localization["truth"]
    got = _steady_errors(localization["port"][1], truth)
    want = _steady_errors(localization["jax"][1], truth)
    assert got[2] == want[2] == 2
    np.testing.assert_allclose(got[:2], want[:2], atol=D.POSE_TOL)
    seed_err = float(np.linalg.norm(localization["seed"][:3, 3] - truth[0][:3, 3]))
    assert max(got[:2]) < 0.5 * seed_err
