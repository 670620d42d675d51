"""Port vs JAX package: the UKF and the IMU fusion layer (``ops/ukf``,
``fusion/pose_system``, ``fusion/ukf_estimator``, ``fusion/imu_queue``,
``fusion/extrinsics``, ``models/transform_maintenance``) and the quaternion
helpers of ``utils/se3`` they call.

The same numpy-seeded inputs go through the JAX function and its port.  The
cases mirror tests/test_ukf.py.  Tolerances: means, poses and quaternions
within 1e-5 absolute; covariances within 1e-5 x max|P| (the two packages'
Cholesky factorizations and einsum reductions round differently in f32).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import UKFConfig as JUKFConfig  # noqa: E402
from cooper_mapper_tpu.fusion import extrinsics as jext  # noqa: E402
from cooper_mapper_tpu.fusion import imu_queue as jiq  # noqa: E402
from cooper_mapper_tpu.fusion import pose_system as jps  # noqa: E402
from cooper_mapper_tpu.fusion import ukf_estimator as jest  # noqa: E402
from cooper_mapper_tpu.models import transform_maintenance as jtm  # noqa: E402
from cooper_mapper_tpu.ops import ukf as jukf  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3  # noqa: E402
from cooper_mapper_torch.config import UKFConfig  # noqa: E402
from cooper_mapper_torch.fusion import extrinsics as text  # noqa: E402
from cooper_mapper_torch.fusion import imu_queue as tiq  # noqa: E402
from cooper_mapper_torch.fusion import pose_system as tps  # noqa: E402
from cooper_mapper_torch.fusion import ukf_estimator as test_  # noqa: E402
from cooper_mapper_torch.models import transform_maintenance as ttm  # noqa: E402
from cooper_mapper_torch.ops import ukf as tukf  # noqa: E402
from cooper_mapper_torch.utils import se3 as tse3  # noqa: E402

MEAN_TOL, COV_RTOL = 1e-5, 1e-5
CFG, JCFG = UKFConfig(), JUKFConfig()


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def close_mean(got, want, tol=MEAN_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def close_cov(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=COV_RTOL * max(np.abs(want).max(), 1e-30))


def spd(rng, n, batch=(), scale=0.3, floor=0.5):
    A = rng.randn(*batch, n, n) * scale
    return (A @ np.swapaxes(A, -1, -2) + floor * np.eye(n)).astype(np.float32)


def rand_quat(rng, *batch):
    q = rng.randn(*batch, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ---- se3 quaternion helpers ------------------------------------------------

def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(0)
    q1, q2 = rand_quat(rng, 64), rand_quat(rng, 64) * 3.0
    close_mean(tse3.quat_multiply(T(q1), T(q2)), jse3.quat_multiply(q1, q2))
    close_mean(tse3.quat_normalize(T(q2)), jse3.quat_normalize(q2))
    R = np.asarray(jse3.quat_to_rot(q1))
    close_mean(tse3.quat_to_rot(T(q1)), R)
    # every branch of rot_to_quat: near-identity, and 180-degree turns about
    # x, y and z (the trace is smallest there, a diagonal entry largest)
    flips = np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
                     ).astype(np.float32)
    R_all = np.concatenate([R, flips, np.eye(3, dtype=np.float32)[None]])
    close_mean(tse3.rot_to_quat(T(R_all)), jse3.rot_to_quat(R_all))


def test_rotate_helpers_match_jax():
    rng = np.random.RandomState(1)
    p = rng.randn(50, 3).astype(np.float32)
    a, b, c = (rng.uniform(-3, 3, 50).astype(np.float32) for _ in range(3))
    close_mean(tse3.rotate_zxy(T(p), T(a), T(b), T(c)), jse3.rotate_zxy(p, a, b, c))
    close_mean(tse3.rotate_yxz(T(p), T(a), T(b), T(c)), jse3.rotate_yxz(p, a, b, c))


# ---- ops/ukf ---------------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(5, ()), (16, ()), (16, (3,)), (26, ())])
def test_sigma_points_and_moments_match_jax(n, batch):
    rng = np.random.RandomState(n)
    mean = rng.randn(*batch, n).astype(np.float32)
    cov = spd(rng, n, batch)
    pts_j, w_j = jukf.sigma_points(mean, cov, lam=1.0)
    pts_t, w_t = tukf.sigma_points(T(mean), T(cov), lam=1.0)
    assert pts_t.shape == (*batch, 2 * n + 1, n)
    close_mean(w_t, w_j)
    close_mean(pts_t, pts_j)
    m_j, c_j = jukf.unscented_moments(pts_j, w_j)
    m_t, c_t = tukf.unscented_moments(pts_t, w_t)
    close_mean(m_t, m_j)
    close_cov(c_t, c_j)
    # the moments give back the mean and covariance (test_moments_roundtrip)
    close_mean(m_t, mean, 1e-4)
    np.testing.assert_allclose(c_t.numpy(), cov, atol=1e-3)


def test_safe_cholesky_positive_definite_matches_jax():
    P = spd(np.random.RandomState(3), 16, (2,))
    close_cov(tukf._safe_cholesky(T(P)), jukf._safe_cholesky(P))


def test_safe_cholesky_falls_back_on_a_matrix_that_is_not_positive_definite():
    # one batch member indefinite at the 1e-9 jitter (an eigenvalue of
    # -1e-5) takes the 1e-4 jitter, the other keeps its own factor
    rng = np.random.RandomState(4)
    Q, _ = np.linalg.qr(rng.randn(16, 16))
    bad = (Q @ np.diag(np.r_[np.linspace(0.01, 1.0, 15), -1e-5]) @ Q.T).astype(np.float32)
    P = np.stack([bad, spd(rng, 16)])
    L_j = np.asarray(jukf._safe_cholesky(P))
    assert np.isnan(np.asarray(jnp.linalg.cholesky(P[0] + 1e-9 * np.eye(16)))).any()
    L_t = tukf._safe_cholesky(T(P))
    assert torch.isfinite(L_t).all()
    close_cov(L_t, L_j)
    close_cov(L_t[0], np.linalg.cholesky(0.5 * (bad + bad.T) + 1e-4 * np.eye(16, dtype=np.float32)))


def test_linear_predict_and_correct_match_jax():
    F = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)
    H = np.array([[1.0, 0.0]], np.float32)
    Q, R = 0.01 * np.eye(2, dtype=np.float32), np.array([[0.1]], np.float32)
    mean = np.array([1.0, -2.0], np.float32)
    cov = np.array([[0.5, 0.1], [0.1, 0.3]], np.float32)
    z = np.array([1.4], np.float32)
    pj = jukf.predict(jukf.UKFState(mean, cov), lambda p, u: p @ F.T, jnp.zeros(0), Q)
    pt = tukf.predict(tukf.UKFState(T(mean), T(cov)), lambda p, u: p @ T(F).T,
                      torch.zeros(0), T(Q))
    close_mean(pt.mean, pj.mean)
    close_cov(pt.cov, pj.cov)
    cj = jukf.correct(jukf.UKFState(mean, cov), lambda p: p @ H.T, z, R)
    ct = tukf.correct(tukf.UKFState(T(mean), T(cov)), lambda p: p @ T(H).T, T(z), T(R))
    close_mean(ct.mean, cj.mean)
    close_cov(ct.cov, cj.cov)
    # and the closed-form Kalman filter (test_linear_correct_matches_kalman)
    S = H @ cov @ H.T + R
    K = cov @ H.T @ np.linalg.inv(S)
    np.testing.assert_allclose(ct.mean.numpy(), mean + K @ (z - H @ mean), atol=1e-4)


# ---- fusion/pose_system ----------------------------------------------------

def _states(rng, S=33, antipode=False):
    x = rng.randn(S, 16).astype(np.float32) * 0.3
    x[:, 6:10] = rand_quat(rng, S)
    if antipode:
        # quaternions straddling w = 0: the sign canonicalization decides
        x[:, 6] = np.where(np.arange(S) % 2 == 0, 1e-7, -1e-7)
        x[0, 6] = 0.0
    return x


@pytest.mark.parametrize("antipode", [False, True])
def test_pose_system_matches_jax(antipode):
    rng = np.random.RandomState(5 + antipode)
    x = _states(rng, antipode=antipode)
    u = rng.randn(6).astype(np.float32)
    for dt in (0.01, 0.1):
        close_mean(tps.f(T(x), T(u), dt), jps.f(x, u, dt))
        close_mean(tps.make_f(dt)(T(x), T(u)), jps.make_f(dt)(x, u))
    close_mean(tps.h(T(x)), jps.h(x))
    assert (tps.h(T(x))[:, 6] >= 0).all()


# ---- fusion/ukf_estimator --------------------------------------------------

def jstate(rng, init_stamp=0.0):
    mean = np.zeros(16, np.float32)
    mean[0:6] = rng.randn(6) * 0.5
    mean[6:10] = rand_quat(rng)
    mean[10:] = rng.randn(6) * 1e-3
    cov = spd(rng, 16, scale=0.05, floor=0.01)
    return mean, cov, np.float32(init_stamp)


def pair(mean, cov, init_stamp, last=None):
    last = mean[0:3] if last is None else last
    return (jest.PoseEstimatorState(jukf.UKFState(jnp.asarray(mean), jnp.asarray(cov)),
                                    jnp.asarray(last), jnp.float32(init_stamp)),
            test_.PoseEstimatorState(tukf.UKFState(T(mean), T(cov)), T(last),
                                     torch.tensor(init_stamp, dtype=torch.float32)))


def close_state(t, j):
    close_mean(t.ukf.mean, j.ukf.mean)
    close_cov(t.ukf.cov, j.ukf.cov)
    close_mean(t.last_correct_pos, j.last_correct_pos)
    assert float(t.init_stamp) == float(j.init_stamp)


def test_create_matches_jax():
    close_state(test_.create(CFG, device="cpu"), jest.create(JCFG))
    pos, quat = np.array([1.0, 2.0, 3.0], np.float32), rand_quat(np.random.RandomState(6))
    close_state(test_.create(CFG, pos=pos, quat=quat, init_stamp=4.5, device="cpu"),
                jest.create(JCFG, pos=pos, quat=quat, init_stamp=4.5))
    close_mean(test_.process_noise(CFG, "cpu"), jest.process_noise(JCFG))
    close_mean(test_.measurement_noise(CFG, "cpu"), jest.measurement_noise(JCFG))


@pytest.mark.parametrize("stamp", [None, 0.5, 1.5])
def test_predict_matches_jax_inside_and_outside_the_cool_down(stamp):
    # init_stamp 0: stamp 0.5 is inside the 1 s cool-down (the state passes
    # through), 1.5 is outside
    rng = np.random.RandomState(7)
    sj, st = pair(*jstate(rng))
    acc, gyro = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    for _ in range(5):
        sj = jest.predict(sj, acc, gyro, np.float32(0.05), JCFG, stamp=stamp)
        st = test_.predict(st, T(acc), T(gyro), torch.tensor(0.05), CFG, stamp=stamp)
    close_state(st, sj)
    if stamp == 0.5:
        close_mean(st.ukf.mean, pair(*jstate(np.random.RandomState(7)))[1].ukf.mean, 0.0)


@pytest.mark.parametrize("case", ["plain", "velocity_discard", "reset_on_jump"])
def test_correct_matches_jax(case):
    rng = np.random.RandomState(8)
    mean, cov, stamp = jstate(rng)
    sj, st = pair(mean, cov, stamp)
    pos = mean[0:3] + rng.randn(3).astype(np.float32) * 0.1
    vel = rng.randn(3).astype(np.float32)
    quat = rand_quat(rng) * 2.0                  # normalized by the correct
    if case == "velocity_discard":
        vel = np.array([1000.0, 0.0, 0.0], np.float32)
    if case == "reset_on_jump":
        pos = pos + np.array([100.0, 0.0, 0.0], np.float32)
    cj = jest.correct(sj, pos, vel, quat, JCFG)
    ct = test_.correct(st, T(pos), T(vel), T(quat), CFG)
    close_state(ct, cj)
    if case == "velocity_discard":
        # the whole velocity measurement is discarded: as if it were zero
        close_state(ct, test_.correct(st, T(pos), torch.zeros(3), T(quat), CFG))
    if case == "reset_on_jump":
        close_mean(ct.ukf.mean[0:3], pos, 1e-4)
        close_mean(ct.ukf.cov, np.float32(0.01) * np.eye(16, dtype=np.float32), 0.0)
    close_mean(test_.pose_matrix(ct), jest.pose_matrix(cj))
    close_mean(test_.velocity(ct), jest.velocity(cj))


def test_predict_correct_cycles_match_jax():
    # test_correct_pulls_to_measurement's cycle
    sj, st = jest.create(JCFG), test_.create(CFG, device="cpu")
    z = np.array([1.0, 2.0, 3.0], np.float32)
    q = np.array([1.0, 0, 0, 0], np.float32)
    for _ in range(15):
        sj = jest.predict(sj, jnp.zeros(3), jnp.zeros(3), 0.1, JCFG)
        sj = jest.correct(sj, z, jnp.zeros(3), q, JCFG)
        st = test_.predict(st, torch.zeros(3), torch.zeros(3), 0.1, CFG)
        st = test_.correct(st, T(z), torch.zeros(3), T(q), CFG)
    close_state(st, sj)
    close_mean(st.ukf.mean[0:3], z, 0.05)


# ---- fusion/imu_queue ------------------------------------------------------

def batches(rng, stamps, mask):
    acc = rng.randn(len(stamps), 3).astype(np.float32)
    gyro = rng.randn(len(stamps), 3).astype(np.float32) * 0.5
    stamps = np.asarray(stamps, np.float32)
    return (jiq.ImuBatch(jnp.asarray(stamps), jnp.asarray(acc), jnp.asarray(gyro),
                         jnp.asarray(mask)),
            tiq.ImuBatch(T(stamps), T(acc), T(gyro), torch.from_numpy(np.asarray(mask))))


@pytest.mark.parametrize("init_stamp,t_from,t_until", [
    (-10.0, 0.0, 0.05),   # warm; half the window after t_until (test_masked_replay)
    (0.0, 0.0, 0.1),      # every sample inside the cool-down (test_predict_cool_down)
    (-0.95, 0.0, 0.1),    # the cool-down ends inside the window
])
def test_replay_predict_matches_jax(init_stamp, t_from, t_until):
    rng = np.random.RandomState(9)
    mean, cov, _ = jstate(rng)
    mean[3:6] = [2.0, 0.0, 0.0]
    sj, st = pair(mean, cov, init_stamp)
    stamps = np.arange(1, 11, dtype=np.float32) * 0.01
    mask = np.ones(10, bool)
    mask[[2, 7]] = False
    bj, bt = batches(rng, stamps, mask)
    oj = jiq.replay_predict(sj, bj, jnp.float32(t_from), jnp.float32(t_until), JCFG)
    ot = tiq.replay_predict(st, bt, t_from, t_until, CFG)
    close_state(ot, oj)
    if init_stamp == 0.0:
        close_mean(ot.ukf.mean, mean, 0.0)


def test_replay_cool_down_advances_prev_stamp_as_jax():
    # test_cool_down_advances_prev_stamp: the cold sample still moves prev_stamp
    rng = np.random.RandomState(10)
    mean, cov, _ = jstate(rng)
    mean[3:6] = [1.0, 0.0, 0.0]
    sj, st = pair(mean, cov, 0.0)
    bj, bt = batches(rng, [0.5, 1.2], np.ones(2, bool))
    close_state(tiq.replay_predict(st, bt, 0.0, 1.5, CFG),
                jiq.replay_predict(sj, bj, jnp.float32(0.0), jnp.float32(1.5), JCFG))


def _extrinsic():
    return np.asarray(jse3.make_mat(jse3.rot_z(jnp.array(0.3)), jnp.array([0.1, 0.0, -0.2])))


def test_lidar_pose_and_correct_from_lidar_match_jax():
    rng = np.random.RandomState(11)
    sj, st = pair(*jstate(rng))
    T_li = _extrinsic()
    close_mean(tiq.lidar_pose(st, T(T_li)), jiq.lidar_pose(sj, T_li))
    T_lidar = np.asarray(jse3.make_mat(jse3.quat_to_rot(rand_quat(rng)),
                                       jnp.asarray(rng.randn(3).astype(np.float32))))
    vel = rng.randn(3).astype(np.float32)
    close_state(tiq.correct_from_lidar(st, T(T_lidar), T(vel), T(T_li), CFG),
                jiq.correct_from_lidar(sj, T_lidar, vel, T_li, JCFG))
    # test_extrinsic_roundtrip: the filter's own pose barely moves it
    st0 = test_.create(CFG, pos=np.array([1.0, 2.0, 3.0], np.float32), device="cpu")
    st2 = tiq.correct_from_lidar(st0, tiq.lidar_pose(st0, T(T_li)), torch.zeros(3), T(T_li),
                                 CFG)
    close_mean(st2.ukf.mean[0:3], st0.ukf.mean[0:3], 0.01)


def test_empty_batch_matches_jax():
    bj, bt = jiq.empty_batch(7), tiq.empty_batch(7, device="cpu")
    for f in dataclasses.fields(bj):
        np.testing.assert_array_equal(getattr(bt, f.name).numpy(), np.asarray(getattr(bj, f.name)))


# ---- models/transform_maintenance ------------------------------------------

def test_imu_rate_poses_match_jax():
    rng = np.random.RandomState(12)
    anchor = np.asarray(jse3.make_mat(jse3.quat_to_rot(rand_quat(rng)),
                                      jnp.asarray(rng.randn(3).astype(np.float32))))
    vel = rng.randn(3).astype(np.float32)
    stamps = 2.0 + np.arange(12, dtype=np.float32) * 0.01
    mask = np.ones(12, bool)
    mask[5] = False
    bj, bt = batches(rng, stamps, mask)
    T_li = _extrinsic()
    pj, vj = jtm.imu_rate_poses(anchor, jnp.float32(2.025), vel, bj, T_li)
    pt, vt = ttm.imu_rate_poses(T(anchor), torch.tensor(2.025), T(vel), bt, T(T_li))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt[:3].any() and vt[3:].sum() == 8
    close_mean(pt, pj)


# ---- fusion/extrinsics -----------------------------------------------------

def test_extrinsics_round_trip_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    T_li = _extrinsic()
    text.save_extrinsic(str(tmp_path / "port.yaml"), T_li)
    jext.save_extrinsic(str(tmp_path / "jax.yaml"), T_li)
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    np.testing.assert_array_equal(text.load_extrinsic(str(tmp_path / "jax.yaml")), T_li)
    np.testing.assert_array_equal(text.identity(), jext.identity())
