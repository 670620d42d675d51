"""Sliding-window local feature map (port of ``cooper_mapper_tpu/maps/local_map.py``;
LocalFeatureMap.h:29-99, DataFrame.h, FrameUpdater.hpp:17-42).

A ring buffer of recent keyframe-like feature frames, evicted by travelled
distance, concatenated and voxel-filtered into the matching surround.
Fixed shapes: the window holds ``window`` frames of fixed capacities, and
eviction clears masks.  ``add_frame`` writes the state's tensors in place
and returns the same object; its gate, slot and eviction are decided on
the device (``torch.where``), with no host read.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import KeyframeConfig
from ..ops.voxel import voxel_downsample
from ..utils import cloud as cloud_lib
from ..utils.cloud import Cloud


@dataclasses.dataclass
class LocalMapState:
    """Ring buffer of world-frame feature frames."""

    corner_xyz: torch.Tensor   # [W, Nc, 3]
    corner_mask: torch.Tensor  # [W, Nc]
    surf_xyz: torch.Tensor     # [W, Ns, 3]
    surf_mask: torch.Tensor    # [W, Ns]
    accum_dist: torch.Tensor   # [W] travelled distance at frame insertion
    frame_valid: torch.Tensor  # [W]
    head: torch.Tensor         # [] int32 next slot
    last_pos: torch.Tensor     # [3] position at the last accepted frame
    last_rot: torch.Tensor     # [3, 3]
    total_dist: torch.Tensor   # [] accumulated travel


def create(window: int, corner_cap: int, surf_cap: int, device="cuda") -> LocalMapState:
    f32 = dict(dtype=torch.float32, device=device)
    return LocalMapState(
        corner_xyz=torch.full((window, corner_cap, 3), cloud_lib.FAR, **f32),
        corner_mask=torch.zeros((window, corner_cap), dtype=torch.bool, device=device),
        surf_xyz=torch.full((window, surf_cap, 3), cloud_lib.FAR, **f32),
        surf_mask=torch.zeros((window, surf_cap), dtype=torch.bool, device=device),
        accum_dist=torch.zeros(window, **f32),
        frame_valid=torch.zeros(window, dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        last_pos=torch.full((3,), float("inf"), **f32),
        last_rot=torch.eye(3, **f32),
        total_dist=torch.zeros((), **f32),
    )


def _put(arr, slot, new, accept):
    """arr[slot] = new where ``accept``, in place (slot [1] on the device)."""
    arr.index_copy_(0, slot, torch.where(accept, new[None], arr.index_select(0, slot)))


def add_frame(state: LocalMapState, corner_world: Cloud, surf_world: Cloud, pose,
              cfg: KeyframeConfig = KeyframeConfig(),
              eviction_distance: float = 30.0) -> LocalMapState:
    """Distance / angle gated insert (FrameUpdater thresholds 0.25 m /
    0.05 rad), then eviction of frames older than total_dist -
    eviction_distance (LocalFeatureMap.h:70-81).  In place."""
    pos = pose[:3, 3]
    rot = pose[:3, :3]
    dt = torch.linalg.vector_norm(pos - state.last_pos)
    cos_da = 0.5 * (torch.trace(state.last_rot.T @ rot) - 1.0)
    da = torch.arccos(torch.clamp(cos_da, -1.0, 1.0))
    first = ~torch.isfinite(dt)
    accept = first | (dt > cfg.keyframe_delta_trans) | (da > cfg.keyframe_delta_angle)

    dist_new = torch.where(first, state.total_dist, state.total_dist + dt)
    slot = state.head.long().reshape(1)
    corner_c = cloud_lib.compact(corner_world, state.corner_xyz.shape[1])
    surf_c = cloud_lib.compact(surf_world, state.surf_xyz.shape[1])
    _put(state.corner_xyz, slot, corner_c.xyz, accept)
    _put(state.corner_mask, slot, corner_c.mask, accept)
    _put(state.surf_xyz, slot, surf_c.xyz, accept)
    _put(state.surf_mask, slot, surf_c.mask, accept)
    _put(state.accum_dist, slot, dist_new, accept)
    _put(state.frame_valid, slot, torch.ones((), dtype=torch.bool, device=pos.device), accept)
    state.head.copy_(torch.where(accept, (state.head + 1) % state.frame_valid.shape[0],
                                 state.head))
    state.last_pos.copy_(torch.where(accept, pos, state.last_pos))
    state.last_rot.copy_(torch.where(accept, rot, state.last_rot))
    state.total_dist.copy_(dist_new)

    stale = state.frame_valid & (state.accum_dist < state.total_dist - eviction_distance)
    state.frame_valid &= ~stale
    state.corner_mask &= ~stale[:, None]
    state.surf_mask &= ~stale[:, None]
    return state


def get_surround(state: LocalMapState, corner_capacity: int, surf_capacity: int,
                 corner_leaf: float = 0.2, surf_leaf: float = 0.4):
    """The window's frames concatenated and voxel-filtered
    (LocalFeatureMap.h:84-99).  Reads the state, writes nothing."""
    def pool(xyz, mask, cap, leaf):
        c = cloud_lib.make(torch.where(mask[..., None], xyz, cloud_lib.FAR).reshape(-1, 3),
                           mask.reshape(-1))
        return voxel_downsample(cloud_lib.compact(c, cap), leaf)

    return (pool(state.corner_xyz, state.corner_mask, corner_capacity, corner_leaf),
            pool(state.surf_xyz, state.surf_mask, surf_capacity, surf_leaf))
