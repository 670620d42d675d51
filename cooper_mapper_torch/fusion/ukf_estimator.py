"""Pose-estimator facade over the generic UKF
(port of ``cooper_mapper_tpu/fusion/ukf_estimator.py``; ``kf::UKFPoseEstimator``,
ukf_pose_estimator.hpp:16-130).

A fixed process / measurement noise profile (:35-60), the predict with its
noise scaled by dt, the 10-dim [p, v, q] correct, and the velocity discard
and reset of LaserLocalization::transformUpdate (LaserLocalization.cpp:
140-166).  The cool-down, the discard and the reset are ``torch.where``
selects on the device: nothing here reads a tensor on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import UKFConfig
from ..ops import ukf
from ..utils import se3
from . import pose_system


@dataclasses.dataclass
class PoseEstimatorState:
    ukf: ukf.UKFState
    last_correct_pos: torch.Tensor  # [..., 3] for the reset-on-jump check
    init_stamp: torch.Tensor        # [...] filter birth time, for the predict
                                    # cool-down (ukf_pose_estimator.hpp:67-71)


def select(cond, a: PoseEstimatorState, b: PoseEstimatorState) -> PoseEstimatorState:
    """Field by field ``torch.where(cond, a, b)`` for a scalar ``cond``."""
    w = lambda x, y: torch.where(cond, x, y)
    return PoseEstimatorState(ukf.UKFState(w(a.ukf.mean, b.ukf.mean), w(a.ukf.cov, b.ukf.cov)),
                              w(a.last_correct_pos, b.last_correct_pos),
                              w(a.init_stamp, b.init_stamp))


def process_noise(cfg: UKFConfig, device="cuda"):
    d = torch.cat([torch.full((3,), cfg.process_noise_pos), torch.full((3,), cfg.process_noise_vel),
                   torch.full((4,), cfg.process_noise_quat), torch.full((6,), cfg.process_noise_bias)])
    return torch.diag(d.to(torch.float32)).to(device)


def measurement_noise(cfg: UKFConfig, device="cuda"):
    d = torch.cat([torch.full((3,), cfg.measure_noise_pos), torch.full((3,), cfg.measure_noise_vel),
                   torch.full((4,), cfg.measure_noise_quat)])
    return torch.diag(d.to(torch.float32)).to(device)


def create(cfg: UKFConfig, pos=None, quat=None, init_stamp=0.0,
           device="cuda") -> PoseEstimatorState:
    mean = torch.zeros(16, dtype=torch.float32, device=device)
    mean[6] = 1.0                                       # identity quaternion
    if pos is not None:
        mean[0:3] = torch.as_tensor(pos, dtype=torch.float32, device=device)
    if quat is not None:
        mean[6:10] = torch.as_tensor(quat, dtype=torch.float32, device=device)
    cov = 0.01 * torch.eye(16, dtype=torch.float32, device=device)
    return PoseEstimatorState(ukf.UKFState(mean, cov), mean[0:3].clone(),
                              torch.tensor(init_stamp, dtype=torch.float32, device=device))


def predict(state: PoseEstimatorState, acc, gyro, dt, cfg: UKFConfig,
            stamp=None) -> PoseEstimatorState:
    """IMU-driven unscented predict, the process noise scaled by dt
    (continuous-time white noise; the reference adds a fixed Q per call,
    unscented_kalman_filter.hpp:93).

    With ``stamp`` given, the predict is skipped inside the cool-down window
    after filter creation (``stamp - init_stamp < cfg.cool_time_duration``,
    ukf_pose_estimator.hpp:67-71): the state passes through unchanged.
    """
    dev = state.ukf.mean.device
    control = torch.cat([acc, gyro], dim=-1)
    new = ukf.predict(state.ukf, pose_system.make_f(dt), control,
                      dt * process_noise(cfg, dev), cfg.lam)
    out = PoseEstimatorState(new, state.last_correct_pos, state.init_stamp)
    if stamp is None:
        return out
    warm = (torch.as_tensor(stamp, dtype=torch.float32, device=dev) - state.init_stamp
            ) >= cfg.cool_time_duration
    return select(warm, out, state)


def correct(state: PoseEstimatorState, pos, vel, quat, cfg: UKFConfig) -> PoseEstimatorState:
    """Pose / velocity correction from the matcher.

    A velocity above cfg.max_velocity is zeroed: the reference discards the
    whole estimate, not its excess (LaserLocalization.cpp:158-160); the
    filter resets when the correction jumps more than cfg.reset_jump metres
    (TransformMaintenance.h:393-402).
    """
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    vel = torch.where(speed > cfg.max_velocity, torch.zeros_like(vel), vel)
    qn = se3.quat_normalize(quat)
    z = torch.cat([pos, vel, qn], dim=-1)
    corrected = ukf.correct(state.ukf, pose_system.h, z,
                            measurement_noise(cfg, pos.device), cfg.lam)

    jump = torch.linalg.vector_norm(pos - state.last_correct_pos, dim=-1)
    reset_mean = torch.cat([pos, vel, qn, torch.zeros_like(corrected.mean[..., 10:])], dim=-1)
    reset_cov = 0.01 * torch.eye(16, dtype=corrected.mean.dtype, device=pos.device)

    do_reset = jump > cfg.reset_jump
    mean = torch.where(do_reset[..., None], reset_mean, corrected.mean)
    cov = torch.where(do_reset[..., None, None], reset_cov, corrected.cov)
    return PoseEstimatorState(ukf.UKFState(mean, cov), pos, state.init_stamp)


def pose_matrix(state: PoseEstimatorState):
    """Current [4, 4] pose estimate."""
    mean = state.ukf.mean
    return se3.make_mat(se3.quat_to_rot(mean[..., 6:10]), mean[..., 0:3])


def velocity(state: PoseEstimatorState):
    return state.ukf.mean[..., 3:6]
