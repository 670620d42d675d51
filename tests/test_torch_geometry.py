"""Port vs JAX package: SE(3) helpers, twist warps and cloud compaction.

Inputs are made with numpy from a seed and fed to both packages; tolerance
atol 1e-5 (f32 transcendentals of the two libraries differ by an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.utils import cloud as jcloud, se3 as jse3, twist as jtwist  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.utils import cloud as tcloud, se3 as tse3, twist as ttwist  # noqa: E402

ATOL = 1e-5


def _inputs(seed, B=3, N=64):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.3, 0.3, (B, 6)).astype(np.float32)
    pts = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (B, N)).astype(np.float32)
    return x, pts, s


@pytest.mark.parametrize("seed", [0, 1])
def test_twist_warps_match(seed):
    x, pts, s = _inputs(seed)
    np.testing.assert_allclose(
        ttwist.warp_to_start(torch.from_numpy(x), torch.from_numpy(pts), torch.from_numpy(s)).numpy(),
        np.asarray(jtwist.warp_to_start(jnp.asarray(x), jnp.asarray(pts), jnp.asarray(s))),
        atol=ATOL)
    np.testing.assert_allclose(
        ttwist.point_to_map(torch.from_numpy(x), torch.from_numpy(pts)).numpy(),
        np.asarray(jtwist.point_to_map(jnp.asarray(x), jnp.asarray(pts))),
        atol=ATOL)


def test_twist_matrix_roundtrip_matches():
    x, _, _ = _inputs(2)
    Mt = ttwist.to_mat(torch.from_numpy(x))
    np.testing.assert_allclose(Mt.numpy(), np.asarray(jtwist.to_mat(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(ttwist.from_relative_motion(Mt).numpy(), x, atol=ATOL)
    inv_t = tse3.inverse(Mt).numpy()
    np.testing.assert_allclose(inv_t, np.asarray(jse3.inverse(jnp.asarray(Mt.numpy()))), atol=ATOL)


@pytest.mark.parametrize("seed", [4, 5])
def test_single_stream_helpers_match(seed):
    # warp_to_end, from_mat, to_relative_motion, transform_associate
    x, pts, s = _inputs(seed)
    tx, tp, ts = map(torch.from_numpy, (x, pts, s))
    jx, jp, js = map(jnp.asarray, (x, pts, s))
    T = ttwist.to_mat(tx)
    jT = jnp.asarray(T.numpy())
    pairs = [
        (ttwist.warp_to_end(tx, tp, ts), jtwist.warp_to_end(jx, jp, js)),
        (ttwist.to_relative_motion(tx), jtwist.to_relative_motion(jx)),
        (ttwist.from_mat(T), jtwist.from_mat(jT)),
        (tse3.transform_associate(T[0], T[1], T[2]),
         jse3.transform_associate(jT[0], jT[1], jT[2])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_empty_cloud_matches():
    got, want = tcloud.empty(5), jcloud.empty(5)
    for f in ("xyz", "mask", "ring", "rel_time"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_se3_exp_log_match():
    rng = np.random.RandomState(3)
    # both Taylor branches: small (|w| < 1e-2) and regular rotations
    xi = np.concatenate([rng.uniform(-1, 1, (4, 3)),
                         rng.uniform(-1, 1, (4, 3)) * np.array([[1e-3], [5e-3], [0.3], [1.0]])],
                        1).astype(np.float32)
    Tt = tse3.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(jse3.se3_exp(jnp.asarray(xi))), atol=ATOL)
    np.testing.assert_allclose(tse3.se3_log(Tt).numpy(),
                               np.asarray(jse3.se3_log(jnp.asarray(Tt.numpy()))), atol=1e-4)


def test_compact_is_a_stable_front_pack():
    rng = np.random.RandomState(4)
    n = 300
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    mask = rng.rand(n) > 0.6
    ring = rng.randint(0, 16, n).astype(np.int32)
    rel = rng.rand(n).astype(np.float32)
    jc = jcloud.compact(jcloud.make(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(ring),
                                    jnp.asarray(rel)), 160)
    tc = tcloud.compact(bridge.cloud(jcloud.make(xyz, mask, ring, rel), "cpu"), 160)
    for f in ("xyz", "mask", "ring", "rel_time"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
