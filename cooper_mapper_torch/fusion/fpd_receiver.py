"""GNSS/INS adapter: GPFPD fixes to map-frame odometry (port of
``cooper_mapper_tpu/fusion/fpd_receiver.py``).

Re-design of ``FPDReceiver`` + ``OdomFPDQueue``
(L_SLAM/src/kf_fusion/fpdReceiver.cpp:120-222, fpd_queue.h:46-149):
lat/lon/alt + attitude fixes are projected to UTM, offset by the configured
map origin, rotated into the lidar frame through the IMU->lidar extrinsic,
and served through a time-interpolating queue (position lerp + quaternion
slerp): the ground-truth feed for evaluation and the ``initialpose2``
relocalization seed.

This is host glue for single 4x4 poses: the rotations and quaternions go
through ``utils/se3`` on CPU float32 tensors (a card round trip per fix
would cost more than the arithmetic), and every function returns numpy,
as the JAX package's do.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import se3
from . import utm


@dataclasses.dataclass(frozen=True)
class MapOrigin:
    lat: float
    lon: float
    alt: float


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def fpd_to_pose(
    lat, lon, alt, roll, pitch, heading, origin: MapOrigin,
    T_imu_to_lidar: Optional[np.ndarray] = None,
) -> np.ndarray:
    """One GPFPD fix -> [4,4] lidar pose in the map frame.

    Heading is degrees clockwise from north (GPFPD convention); the map frame
    is x-east, y-up, z-north (fpdReceiver.cpp:120-165).
    """
    pos = utm.gnss_to_map(lat, lon, alt, origin.lat, origin.lon, origin.alt)
    yaw = np.deg2rad(90.0 - heading)            # heading CW from north -> CCW from east
    R = (se3.rot_y(_f32(yaw)) @ se3.rot_x(_f32(np.deg2rad(pitch)))
         @ se3.rot_z(_f32(np.deg2rad(roll)))).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = pos
    if T_imu_to_lidar is not None:
        T = T @ np.asarray(T_imu_to_lidar, np.float32)
    return T


class FpdQueue:
    """Buffered odometry queue with timestamp interpolation (fpd_queue.h)."""

    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        self.stamps: List[float] = []
        self.poses: List[np.ndarray] = []

    def push(self, stamp: float, pose: np.ndarray) -> None:
        self.stamps.append(float(stamp))
        self.poses.append(np.asarray(pose, np.float32))
        if len(self.stamps) > self.capacity:
            self.stamps.pop(0)
            self.poses.pop(0)

    def find_nearest(self, stamp: float) -> Optional[np.ndarray]:
        """Slerp-interpolated pose at the given stamp (fpd_queue.h:46-149)."""
        if not self.stamps:
            return None
        i = bisect.bisect_left(self.stamps, stamp)
        if i == 0:
            return self.poses[0]
        if i >= len(self.stamps):
            return self.poses[-1]
        t0, t1 = self.stamps[i - 1], self.stamps[i]
        u = 0.0 if t1 <= t0 else (stamp - t0) / (t1 - t0)
        P0, P1 = self.poses[i - 1], self.poses[i]
        q0 = se3.rot_to_quat(torch.from_numpy(P0[:3, :3]))
        q1 = se3.rot_to_quat(torch.from_numpy(P1[:3, :3]))
        q = se3.quat_slerp(q0, q1, np.float32(u))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = se3.quat_to_rot(q).numpy()
        T[:3, 3] = (1 - u) * P0[:3, 3] + u * P1[:3, 3]
        return T


def imu_raw_convert(gyro_dps, accel_g) -> Tuple[np.ndarray, np.ndarray]:
    """Vendor IMU units -> SI (imuReceiver.cpp:47-58): deg/s -> rad/s, g -> m/s^2."""
    return (
        np.deg2rad(np.asarray(gyro_dps, np.float32)),
        9.80665 * np.asarray(accel_g, np.float32),
    )
