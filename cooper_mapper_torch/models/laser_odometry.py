"""LaserOdometry stage: stateful scan-to-scan tracking
(port of ``cooper_mapper_tpu/models/laser_odometry.py``;
LaserOdometry.{h,cpp}).

Holds the previous sweep's less-sharp / less-flat clouds, solves the
in-sweep motion twist against them (warm-started from the previous twist,
the reference's constant-velocity prior), accumulates the odometry pose with
the exact relative motion of the solved twist, and projects the current
clouds to the sweep end as the next sweep's reference (process(),
LaserOdometry.cpp:288-326).  One problem at a time, on the state's device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import OdometryConfig
from ..ops import odometry as odometry_ops
from ..ops.features import FeatureClouds
from ..utils import cloud as cloud_lib
from ..utils import twist
from ..utils.cloud import Cloud


@dataclasses.dataclass
class OdometryState:
    last_corner: Cloud      # previous sweep less-sharp, projected to sweep end
    last_surf: Cloud        # previous sweep less-flat, projected to sweep end
    x_prev: torch.Tensor    # [6] last solved twist (constant-velocity warm start)
    T_sum: torch.Tensor     # [4, 4] accumulated odometry pose


@dataclasses.dataclass
class OdometryOutput:
    T_sum: torch.Tensor         # pose after this sweep
    x: torch.Tensor             # solved in-sweep twist
    n_matched: torch.Tensor
    converged: torch.Tensor
    corner_for_map: Cloud       # end-projected clouds handed to the mapper
    surf_for_map: Cloud


def create(corner_capacity: int, surf_capacity: int, device="cuda") -> OdometryState:
    return OdometryState(
        last_corner=cloud_lib.empty(corner_capacity, device),
        last_surf=cloud_lib.empty(surf_capacity, device),
        x_prev=torch.zeros(6, dtype=torch.float32, device=device),
        T_sum=torch.eye(4, dtype=torch.float32, device=device),
    )


def _project_to_end(x, c: Cloud) -> Cloud:
    xyz = twist.warp_to_end(x, c.xyz, c.rel_time)
    return Cloud(torch.where(c.mask[:, None], xyz, cloud_lib.FAR), c.mask, c.ring,
                 torch.zeros_like(c.rel_time))


def init_step(state: OdometryState, fc: FeatureClouds, cfg: OdometryConfig,
              parity_mode: bool = False) -> OdometryState:
    """First sweep: store clouds, no solve (process(), :295-303).
    ``parity_mode`` is accepted as in the JAX package; the first sweep does
    not solve, so it changes nothing."""
    return OdometryState(
        last_corner=cloud_lib.compact(fc.less_sharp, state.last_corner.capacity),
        last_surf=cloud_lib.compact(fc.less_flat, state.last_surf.capacity),
        x_prev=state.x_prev,
        T_sum=state.T_sum,
    )


def step(state: OdometryState, fc: FeatureClouds, cfg: OdometryConfig,
         parity_mode: bool = False):
    """One odometry sweep: solve, accumulate, roll the reference clouds.
    ``parity_mode=True`` solves with the reference's iteration dynamics
    (``ops/odometry``).  Returns (state', OdometryOutput)."""
    x, diag = odometry_ops.odometry_solve(fc.sharp, fc.flat, state.last_corner,
                                          state.last_surf, state.x_prev, cfg, parity_mode)
    T_new = state.T_sum @ twist.to_relative_motion(x)

    corner_end = _project_to_end(x, fc.less_sharp)
    surf_end = _project_to_end(x, fc.less_flat)
    new_state = OdometryState(
        last_corner=cloud_lib.compact(corner_end, state.last_corner.capacity),
        last_surf=cloud_lib.compact(surf_end, state.last_surf.capacity),
        x_prev=x,
        T_sum=T_new,
    )
    out = OdometryOutput(T_sum=T_new, x=x, n_matched=diag.n_matched[0],
                         converged=diag.converged[0], corner_for_map=corner_end,
                         surf_for_map=surf_end)
    return new_state, out
