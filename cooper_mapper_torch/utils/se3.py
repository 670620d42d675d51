"""SE(3) / Euler-convention and quaternion math (port of
``cooper_mapper_tpu/utils/se3.py``).

Conventions are the JAX package's: ``TZYX`` poses ``p' = Rz Ry Rx p + t``,
Euler 6-vectors ``[rx, ry, rz, tx, ty, tz]``, twists ``[v, w]`` (translation
first).  Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def _stack_rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x(a):
    """(...,) angle -> (..., 3, 3) rotation about x."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack_rows([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack_rows([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack_rows([[c, -s, z], [s, c, z], [z, z, o]])


def euler_zyx_to_rot(rx, ry, rz):
    """R = Rz(rz) @ Ry(ry) @ Rx(rx) — the TZYX convention."""
    return rot_z(rz) @ rot_y(ry) @ rot_x(rx)


def rot_to_euler_zyx(R):
    """Inverse of euler_zyx_to_rot; returns (rx, ry, rz)."""
    rx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ry = torch.asin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    rz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return rx, ry, rz


def make_mat(R, t):
    """(...,3,3), (...,3) -> (...,4,4) homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotate_zxy(p, az, ax, ay):
    """Rotate points p (..., 3) about z by az, then x by ax, then y by ay:
    p' = Ry(ay) @ Rx(ax) @ Rz(az) @ p (rotateZXY, math_utils.h:184-205)."""
    R = rot_y(ay) @ rot_x(ax) @ rot_z(az)
    return (R @ p[..., None])[..., 0]


def rotate_yxz(p, ay, ax, az):
    """p' = Rz(az) @ Rx(ax) @ Ry(ay) @ p (rotateYXZ, math_utils.h:215-236)."""
    R = rot_z(az) @ rot_x(ax) @ rot_y(ay)
    return (R @ p[..., None])[..., 0]


def euler6_to_mat(x):
    """[..., 6] (rx,ry,rz,tx,ty,tz) -> [..., 4, 4] with R = Rz Ry Rx."""
    R = euler_zyx_to_rot(x[..., 0], x[..., 1], x[..., 2])
    return make_mat(R, x[..., 3:6])


def mat_to_euler6(T):
    """[..., 4, 4] -> [..., 6] (rx,ry,rz,tx,ty,tz), TZYX convention."""
    rx, ry, rz = rot_to_euler_zyx(T[..., :3, :3])
    return torch.cat([torch.stack([rx, ry, rz], -1), T[..., :3, 3]], dim=-1)


def identity_mat(dtype=torch.float32, device="cuda"):
    return torch.eye(4, dtype=dtype, device=device)


def compose(A, B):
    """A @ B for (...,4,4) transforms."""
    return A @ B


def inverse(T):
    """Closed-form inverse of a rigid transform (...,4,4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_mat(Rt, -(Rt @ t[..., None])[..., 0])


def apply(T, p):
    """Apply (...,4,4) to points (..., N, 3) or (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if p.dim() >= 2:
        return p @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ p[..., None])[..., 0] + t


def transform_associate(L_old, L_new, W_old):
    """W_new = (W_old @ L_old^-1) @ L_new  (transform_utils.h:502-507):
    chains the mapping correction onto fresh odometry."""
    return W_old @ inverse(L_old) @ L_new


# Quaternions (w, x, y, z): the UKF and fusion layer.

def quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rot(q):
    w, x, y, z = quat_normalize(q).unbind(-1)
    return _stack_rows([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rot_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z) with w >= 0: the best
    conditioned of four constructions, chosen without a branch."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1),
    ], -2)                                                     # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    idx = torch.argmax(scores, dim=-1)          # the first maximum, as jnp.argmax
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q * torch.sign(q[..., :1] + 1e-30)       # w >= 0
    return quat_normalize(q)


def quat_from_axis_angle(axis, angle):
    """(..., 3) axis (any length), (...,) angle -> (..., 4) (w, x, y, z)."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_slerp(q0, q1, u):
    """Spherical interpolation from ``q0`` to ``q1``, ``u`` in [0, 1]; the
    shorter arc, and a plain lerp where the two are nearly parallel
    (sin theta < 1e-5)."""
    u = torch.as_tensor(u, dtype=q0.dtype, device=q0.device)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(use_lerp, u, torch.sin(u * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)

def skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return _stack_rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w):
    """(...,3) -> (...,3,3) via Rodrigues, Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    W = skew(w)
    small = theta < 1e-2
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    """(...,3,3) -> (...,3), Taylor-safe (small branch from the vee vector)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = 0.5 * (R - R.transpose(-1, -2))
    vee = torch.stack([w_skew[..., 2, 1], w_skew[..., 0, 2], w_skew[..., 1, 0]], -1)
    small = cos_theta > 0.9999
    safe_cos = torch.where(small, torch.full_like(cos_theta, 0.5), cos_theta)
    theta = torch.arccos(safe_cos)
    sin_theta = torch.sqrt(torch.clamp(1.0 - safe_cos * safe_cos, min=1e-12))
    scale_exact = theta / sin_theta
    s2 = torch.sum(vee * vee, dim=-1)
    scale_small = 1.0 + s2 / 6.0
    scale = torch.where(small, scale_small, scale_exact)
    return vee * scale[..., None]


def se3_exp(xi):
    """(...,6) [v, w] -> (...,4,4)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    W = skew(w)
    small = theta < 1e-2
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-30))
    V = _eye3(R) + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return make_mat(R, (V @ v[..., None])[..., 0])


def se3_log(T):
    """(...,4,4) -> (...,6) [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    W = skew(w)
    small = theta < 1e-2
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=1e-30),
    )
    Vinv = _eye3(R) - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], dim=-1)
