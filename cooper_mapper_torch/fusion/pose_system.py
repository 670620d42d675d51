"""16-state IMU pose process and observation model
(port of ``cooper_mapper_tpu/fusion/pose_system.py``; ``kf::PoseSystem``,
pose_system.hpp:16-78).

state    x = [p(3), v(3), q(4: w x y z), acc_bias(3), gyro_bias(3)]   (16)
control  u = [acc(3), gyro(3)]
measure  z = [p(3), v(3), q(4)]                                       (10)

f: p += v*dt; v constant (the reference leaves acceleration out,
pose_system.hpp:47); q <- q * dq(gyro - gyro_bias, dt); biases constant.
h: observe [p, v, normalize(q)].
"""

from __future__ import annotations

import torch

from ..utils import se3

P = slice(0, 3)
V = slice(3, 6)
Q = slice(6, 10)
ACC_BIAS = slice(10, 13)
GYRO_BIAS = slice(13, 16)


def f(states, control, dt=0.01):
    """Process model over sigma points: states [..., S, 16], control [..., 6]."""
    p = states[..., P]
    v = states[..., V]
    q = se3.quat_normalize(states[..., Q])
    gyro_bias = states[..., GYRO_BIAS]

    p_new = p + dt * v

    gyro = control[..., None, 3:6] - gyro_bias
    half = 0.5 * dt * gyro
    dq = se3.quat_normalize(torch.cat([torch.ones_like(half[..., :1]), half], dim=-1))
    q_new = se3.quat_normalize(se3.quat_multiply(q, dq))
    # the double cover made canonical (w >= 0): sigma points on both sides of
    # the antipode would otherwise average to a biased mean quaternion
    q_new = q_new * torch.sign(q_new[..., :1] + 1e-30)

    return torch.cat([p_new, v, q_new, states[..., ACC_BIAS], gyro_bias], dim=-1)


def h(states):
    """Observation: [..., S, 16] -> [..., S, 10]."""
    q = se3.quat_normalize(states[..., Q])
    q = q * torch.sign(q[..., :1] + 1e-30)
    return torch.cat([states[..., P], states[..., V], q], dim=-1)


def make_f(dt):
    return lambda pts, u: f(pts, u, dt)
