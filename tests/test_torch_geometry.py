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


@pytest.mark.parametrize("seed", [6, 7])
def test_map_to_point_inverts_point_to_map_like_jax(seed):
    x, pts, _ = _inputs(seed)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pts)
    got = ttwist.map_to_point(tx, tp)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jtwist.map_to_point(jnp.asarray(x), jnp.asarray(pts))),
                               atol=ATOL)
    # the round trip through point_to_map gives the points back
    np.testing.assert_allclose(ttwist.map_to_point(tx, ttwist.point_to_map(tx, tp)).numpy(), pts,
                               atol=1e-4)


def test_compose_helpers_match():
    # compose_accumulate, compose, identity_mat
    x, _, _ = _inputs(8)
    T = ttwist.to_mat(torch.from_numpy(x))
    jT = jnp.asarray(T.numpy())
    np.testing.assert_allclose(ttwist.compose_accumulate(T, torch.from_numpy(x[::-1].copy())).numpy(),
                               np.asarray(jtwist.compose_accumulate(jT, jnp.asarray(x[::-1]))),
                               atol=ATOL)
    np.testing.assert_allclose(tse3.compose(T[0], T[1]).numpy(),
                               np.asarray(jse3.compose(jT[0], jT[1])), atol=ATOL)
    eye = tse3.identity_mat(device="cpu")
    assert eye.dtype == torch.float32 and eye.device.type == "cpu"
    np.testing.assert_array_equal(eye.numpy(), np.asarray(jse3.identity_mat()))
    np.testing.assert_array_equal(tse3.identity_mat(torch.float64, "cpu").numpy(), np.eye(4))


def test_quat_from_axis_angle_matches():
    rng = np.random.RandomState(9)
    axis = rng.randn(6, 3).astype(np.float32)
    axis[1] *= 1e-3                  # any length: the axis is normalised
    axis[2] = 0.0                    # a zero axis: the 1e-12 floor
    angle = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    got = tse3.quat_from_axis_angle(torch.from_numpy(axis), torch.from_numpy(angle))
    want = np.asarray(jse3.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # a quaternion of unit length where the axis is not zero, and the rotation of its angle
    np.testing.assert_allclose(torch.linalg.vector_norm(got[[0, 1, 3, 4, 5]], dim=-1).numpy(), 1.0,
                               atol=1e-6)


def test_cloud_count_and_masked_xyz_match():
    rng = np.random.RandomState(10)
    xyz = rng.uniform(-5, 5, (3, 40, 3)).astype(np.float32)
    mask = rng.rand(3, 40) > 0.5
    jc, tc = jcloud.make(jnp.asarray(xyz), jnp.asarray(mask)), tcloud.make(
        torch.from_numpy(xyz), torch.from_numpy(mask))
    assert tc.count().dtype == torch.int32
    np.testing.assert_array_equal(tc.count().numpy(), np.asarray(jc.count()))
    for fill in ({}, {"fill": -7.5}):
        np.testing.assert_array_equal(tc.masked_xyz(**fill).numpy(),
                                      np.asarray(jc.masked_xyz(**fill)))
