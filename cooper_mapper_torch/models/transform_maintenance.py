"""TransformMaintenance: the IMU-rate pose output
(port of ``cooper_mapper_tpu/models/transform_maintenance.py``;
TransformMaintenance.h:35-498).

From the latest map-corrected anchor pose and the IMU samples newer than
it, dead-reckon one pose per sample:

    pos += v * dt;   q <- q * (T_li dq T_li^-1)      (imuStep, :453-467)

Acceleration is left out, as in the reference.  The JAX package runs the
window as one ``lax.scan``; here a loop over the window on the device,
each sample kept or passed over by ``torch.where``.
"""

from __future__ import annotations

import torch

from ..fusion.imu_queue import ImuBatch
from ..utils import se3


def imu_rate_poses(anchor_pose, anchor_stamp, velocity, batch: ImuBatch, T_li):
    """Dead-reckon poses at each IMU sample newer than the anchor.
    ``anchor_pose`` [4, 4] (lidar frame), ``anchor_stamp`` [], ``velocity``
    [3] world frame, ``T_li`` [4, 4] lidar -> imu.
    Returns (poses [M, 4, 4], valid [M])."""
    dev = anchor_pose.device
    q = se3.rot_to_quat(anchor_pose[:3, :3])
    p = anchor_pose[:3, 3]
    q_li = se3.rot_to_quat(T_li[:3, :3])
    q_il = se3.rot_to_quat(se3.inverse(T_li)[:3, :3])
    t_prev = torch.as_tensor(anchor_stamp, dtype=torch.float32, device=dev)
    use = batch.mask & (batch.stamp > t_prev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    ps, qs = [], []
    for i in range(batch.stamp.shape[0]):
        stamp, ok = batch.stamp[i], use[i]
        dt = torch.clamp(stamp - t_prev, 0.0, 0.5)
        p_new = p + velocity * dt
        dq = se3.quat_normalize(torch.cat([one, 0.5 * dt * batch.gyro[i]]))
        # the gyro is measured in the IMU frame: q <- q * (q_li dq q_li^-1)
        dq_l = se3.quat_multiply(se3.quat_multiply(q_li, dq), q_il)
        q_new = se3.quat_normalize(se3.quat_multiply(q, dq_l))
        p = torch.where(ok, p_new, p)
        q = torch.where(ok, q_new, q)
        t_prev = torch.where(ok, stamp, t_prev)
        ps.append(p)
        qs.append(q)
    poses = se3.make_mat(se3.quat_to_rot(torch.stack(qs)), torch.stack(ps))
    return poses, use
