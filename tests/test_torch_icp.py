"""Port vs JAX package: point-to-point ICP (``ops/icp``).

``_kabsch`` on random weighted point sets, with some zero weights and with
all weights zero (no inlier: the cross-covariance is zero and both packages
give the identity), within 1e-5.  ``icp`` on tests/test_io.py::TestIcp's
two-plane cloud and on a JAX-built sweep's surf cloud, each aligned onto a
copy of itself moved by a known pose with 0.01 m of noise: T within 1e-4
of the JAX package's, rmse within 1e-5, the inlier counts equal.  The noise
lifts the aligned rmse above the rounding of the expanded squared distance
|q|^2 - 2 q.r + |r|^2 (~3e-6 m^2 per point at 5 m, in either package):
without it the two-plane cloud aligns to an rmse of ~1e-4 m that is
rounding alone, 1.2e-4 in the JAX package and 5.1e-4 in the port.  The JAX
correspondence search is dense XLA (``neighbors.nn1``), the port's the
plain version of its nn1 kernel: the two differ only by rounding, so the
selections agree but on near-ties.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import RegistrationConfig  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_tpu.ops import icp as jicp  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.ops import icp as ticp  # noqa: E402


@pytest.mark.parametrize("weights", ["random", "some_zero", "all_zero"])
def test_kabsch_matches_jax(weights):
    rng = np.random.RandomState(3)
    src = rng.randn(200, 3).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.4, -0.1, 0.2, 0.1, -0.3, 0.2], jnp.float32)))
    dst = (src @ T[:3, :3].T + T[:3, 3] + 0.01 * rng.randn(200, 3)).astype(np.float32)
    w = rng.rand(200).astype(np.float32)
    if weights == "some_zero":
        w[::3] = 0.0
    if weights == "all_zero":
        w[:] = 0.0
    want = np.asarray(jicp._kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    got = ticp._kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if weights == "all_zero":
        np.testing.assert_array_equal(got.numpy(), np.eye(4, dtype=np.float32))


def _two_planes():
    """tests/test_io.py::TestIcp's structured cloud."""
    pts = np.random.RandomState(0).uniform(-5, 5, (500, 3)).astype(np.float32)
    pts[:250, 1] = 0.0
    pts[250:, 0] = 3.0
    return pts


def _sweep_surf():
    """The valid less-flat points of a JAX-simulated 16 x 512 sweep."""
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=3)
    pose = np.eye(4, dtype=np.float32)
    pose[1, 3] = 1.5
    sweep = jsim.scan_sweep(world, jnp.asarray(pose), jnp.asarray(pose), n_rings=16, width=512,
                            distortion=False)
    fc = jfeat.extract_features(sweep, RegistrationConfig(n_rings=16, max_points_per_ring=512))
    c = fc.less_flat
    return np.asarray(c.xyz)[np.asarray(c.mask)][:3000]


@pytest.mark.parametrize("cloud", ["two_planes", "sweep_surf"])
def test_icp_matches_jax(cloud):
    pts = _two_planes() if cloud == "two_planes" else _sweep_surf()
    T_true = np.asarray(jse3.se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.02, 0.05, -0.03],
                                                 jnp.float32)))
    src = ((pts - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)   # T_true^-1 pts
    pts = (pts + 0.01 * np.random.RandomState(5).randn(*pts.shape)).astype(np.float32)
    # padded with invalid FAR slots, as the keyframe clouds are
    target = jcloud.from_points(jnp.asarray(pts), capacity=len(pts) + 37)
    source = jcloud.from_points(jnp.asarray(src), capacity=len(src) + 11)
    T, rmse, n = jicp.icp(source, target, jnp.eye(4), max_iterations=15)
    tT, trmse, tn = ticp.icp(bridge.cloud(source, "cpu"), bridge.cloud(target, "cpu"),
                             torch.eye(4), max_iterations=15)
    np.testing.assert_allclose(tT.numpy(), np.asarray(T), atol=1e-4)
    np.testing.assert_allclose(float(trmse), float(rmse), atol=1e-5)
    assert int(tn) == int(n)
    if cloud == "sweep_surf":
        return
    # tests/test_io.py::TestIcp's gates, on the port
    err = np.asarray(jse3.se3_log(jnp.asarray(np.linalg.inv(T_true) @ tT.numpy())))
    assert np.linalg.norm(err) < 0.05, err
    assert float(trmse) < 0.1
