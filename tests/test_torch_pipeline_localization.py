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
    sweeps, _ = D.simulate(6)
    jmap = D.drive(False, sweeps, "mapping")[0].map_state
    seed = D.seed_pose()
    tmap = bridge.feature_map_state(jmap, "cpu")
    return {"jax": D.drive(False, sweeps, "localization", map_state=jmap, initial_pose=seed),
            "port": D.drive(True, sweeps, "localization", map_state=tmap, initial_pose=seed),
            "seed": seed, "jax_map": jmap}


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
