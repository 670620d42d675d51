"""IMU sample replay into the UKF pose estimator
(port of ``cooper_mapper_tpu/fusion/imu_queue.py``; ``IMUQueue``,
imu_queue.h:30-163).

The host hands over a fixed-capacity window of IMU samples per sweep
interval (``ImuBatch``, stamp-sorted and masked).  The replay steps through
every sample on the device, as the JAX package's ``lax.scan`` does: each
step runs the unscented predict, and a sample that is masked, outside
(t_from, t_until] or inside the cool-down keeps the previous state by
``torch.where``.  Predict and correct hop between the IMU and lidar frames
through the extrinsic ``T_li`` (:68-139).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import UKFConfig
from ..utils import se3
from . import ukf_estimator


@dataclasses.dataclass
class ImuBatch:
    """Fixed-capacity IMU sample window (sorted by stamp, masked)."""

    stamp: torch.Tensor  # [M] seconds, f32
    acc: torch.Tensor    # [M, 3]
    gyro: torch.Tensor   # [M, 3]
    mask: torch.Tensor   # [M] bool


def replay_predict(state: ukf_estimator.PoseEstimatorState, batch: ImuBatch, t_from, t_until,
                   cfg: UKFConfig) -> ukf_estimator.PoseEstimatorState:
    """UKF predicts through the samples with t_from < stamp <= t_until.

    Each step's dt is the gap to the previous sample in the window, clamped
    to [0, 0.5] s.  Samples inside the cool-down after filter creation are
    skipped (``(stamp - init_stamp) < cool_time_duration``,
    ukf_pose_estimator.hpp:67-71), but the previous stamp still advances
    over them, as the reference's early return sets prev_stamp.
    """
    dev = state.ukf.mean.device
    t_prev = torch.as_tensor(t_from, dtype=torch.float32, device=dev)
    t_until = torch.as_tensor(t_until, dtype=torch.float32, device=dev)
    in_window = batch.mask & (batch.stamp > t_prev) & (batch.stamp <= t_until)
    use = in_window & (batch.stamp - state.init_stamp >= cfg.cool_time_duration)
    est = state
    for i in range(batch.stamp.shape[0]):
        dt = torch.clamp(batch.stamp[i] - t_prev, 0.0, 0.5)
        pred = ukf_estimator.predict(est, batch.acc[i], batch.gyro[i], dt, cfg)
        est = ukf_estimator.select(use[i], pred, est)
        t_prev = torch.where(in_window[i], batch.stamp[i], t_prev)
    return est


def lidar_pose(state: ukf_estimator.PoseEstimatorState, T_li):
    """UKF (IMU-frame) pose -> lidar-frame pose: T_lidar = T_imu @ T_li^-1,
    with T_li mapping lidar -> imu (imu_queue.h:102-112)."""
    return ukf_estimator.pose_matrix(state) @ se3.inverse(T_li)


def correct_from_lidar(state: ukf_estimator.PoseEstimatorState, T_lidar, vel, T_li,
                       cfg: UKFConfig) -> ukf_estimator.PoseEstimatorState:
    """A lidar-frame pose taken to the IMU frame, then the correct (:124-139)."""
    T_imu = T_lidar @ T_li
    q = se3.rot_to_quat(T_imu[..., :3, :3])
    return ukf_estimator.correct(state, T_imu[..., :3, 3], vel, q, cfg)


def empty_batch(capacity: int, device="cuda") -> ImuBatch:
    return ImuBatch(stamp=torch.zeros(capacity, dtype=torch.float32, device=device),
                    acc=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
                    gyro=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
                    mask=torch.zeros(capacity, dtype=torch.bool, device=device))
