"""LOAM twist parameterization and in-sweep motion warps
(port of ``cooper_mapper_tpu/utils/twist.py``).

The solver state is a 6-vector ``x = [rx, ry, rz, tx, ty, tz]``; the warps
are forward TZYX transforms of the (time-scaled) twist
(LaserOdometry.cpp:135-142, transform_utils.h:476-482).  All functions
broadcast over leading batch dimensions of state and points.
"""

from __future__ import annotations

import torch

from . import se3


def _tzyx_apply_elementwise(rx, ry, rz, tx, ty, tz, points):
    """Rz(rz) Ry(ry) Rx(rx) p + t with per-point angles, elementwise."""
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    ox = cz * cy * px + (cz * sy * sx - sz * cx) * py + (cz * sy * cx + sz * sx) * pz + tx
    oy = sz * cy * px + (sz * sy * sx + cz * cx) * py + (sz * sy * cx - cz * sx) * pz + ty
    oz = -sy * px + cy * sx * py + cy * cx * pz + tz
    return torch.stack([ox, oy, oz], dim=-1)


def warp_to_start(x, points, s):
    """``p_start = TZYX(s*x) p``: x [..., 6], points [..., N, 3], s [..., N]."""
    return _tzyx_apply_elementwise(
        s * x[..., None, 0], s * x[..., None, 1], s * x[..., None, 2],
        s * x[..., None, 3], s * x[..., None, 4], s * x[..., None, 5],
        points,
    )


def warp_to_end(x, points, s):
    """Project points to the sweep end frame (transformToEnd,
    LaserOdometry.cpp:156-168): ``p_end = TZYX(x)^-1 warp_to_start(p)``."""
    p_start = warp_to_start(x, points, s)
    T_inv = se3.inverse(se3.euler6_to_mat(x))
    return p_start @ T_inv[..., :3, :3].transpose(-1, -2) + T_inv[..., None, :3, 3]


def point_to_map(x, points):
    """World registration ``Rz Ry Rx p + t``: x [..., 6], points [..., N, 3]."""
    return _tzyx_apply_elementwise(
        x[..., None, 0], x[..., None, 1], x[..., None, 2],
        x[..., None, 3], x[..., None, 4], x[..., None, 5],
        points,
    )


def map_to_point(x, points):
    """Inverse of point_to_map (pointAssociateTobeMapped)."""
    R = se3.euler_zyx_to_rot(x[..., 0], x[..., 1], x[..., 2])
    return (points - x[..., None, 3:6]) @ R


def to_mat(x):
    """Twist 6-vec -> 4x4 matrix in the canonical TZYX convention."""
    return se3.euler6_to_mat(x)


def from_mat(T):
    return se3.mat_to_euler6(T)


def compose_accumulate(T_sum, x):
    """_Tsum = _Tsum @ TZYX(x)  (LaserOdometry::transformUpdate, :649-653)."""
    return T_sum @ to_mat(x)


def to_relative_motion(x):
    """Twist -> the relative sensor pose over the sweep, M = T_start^-1 T_end,
    which under the forward TZYX warp convention is TZYX(x)."""
    return se3.euler6_to_mat(x)


def from_relative_motion(M):
    """Relative sweep motion (4x4) -> twist 6-vec."""
    return se3.mat_to_euler6(M)
