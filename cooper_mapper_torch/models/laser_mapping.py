"""LaserMapping / LaserLocalization stages
(port of ``cooper_mapper_tpu/models/laser_mapping.py``; LaserMatcher.{h,cpp},
LaserMapping.cpp, LaserLocalization.cpp).

One step over an explicit state: ``transform_associate`` chains the mapping
correction onto fresh odometry (LaserMatcher.cpp:333-340), the frame is
voxel-downsampled, the scan-to-map solve runs against the cube map's
surround, and the mapping step inserts the registered frame into the map.
The merged high-rate pose is ``W_last @ inv(L_last) @ L_now``, computed on
demand.  The map is updated in place (``maps/feature_map.py``,
``maps/local_map.py``); the localization step never writes it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig, MatcherConfig, ScanMatchConfig
from ..maps import feature_map as fm
from ..maps import local_map as lm
from ..ops import scan_match as sm
from ..ops.voxel import voxel_downsample
from ..utils import cloud as cloud_lib
from ..utils import profiling, se3, twist
from ..utils.cloud import Cloud


@dataclasses.dataclass
class MatcherState:
    """Shared scan-to-map tracking state (LaserMatcher.h:34-172)."""

    L_last: torch.Tensor  # [4, 4] odometry pose at the last mapping solve
    W_last: torch.Tensor  # [4, 4] map-corrected pose at the last mapping solve


def create_matcher(device="cuda") -> MatcherState:
    return MatcherState(L_last=torch.eye(4, dtype=torch.float32, device=device),
                        W_last=torch.eye(4, dtype=torch.float32, device=device))


def merged_pose(state: MatcherState, L_now):
    """High-rate merged pose: the 10 Hz /lidar_to_map2 output
    (laserOdometryHandler, LaserMatcher.cpp:221-261)."""
    return se3.transform_associate(state.L_last, L_now, state.W_last)


def prepare_frame(corner: Cloud, surf: Cloud, cfg: MatcherConfig):
    """Voxel-downsample the incoming end-projected feature stacks
    (prepareFeatureFrame, LaserMatcher.cpp:288-301)."""
    return (
        voxel_downsample(corner, cfg.corner_leaf, cfg.max_frame_corner),
        voxel_downsample(surf, cfg.surf_leaf, cfg.max_frame_surf),
    )


def _to_world(c: Cloud, T) -> Cloud:
    """``c`` moved by the [4, 4] pose T; invalid points stay at FAR."""
    xyz = se3.apply(T, c.xyz)
    return Cloud(torch.where(c.mask[:, None], xyz, cloud_lib.FAR), c.mask, c.ring,
                 c.rel_time)


@dataclasses.dataclass
class MappingOutput:
    W: torch.Tensor              # corrected world pose after the solve
    result: sm.ScanMatchResult
    # the downsampled frame stacks in the sensor frame
    # (/laser_cloud_{corner,surf}_last2, LaserMatcher.cpp:357-383)
    corner_ds: Cloud
    surf_ds: Cloud


def mapping_step(matcher: MatcherState, map_state: fm.FeatureMapState, corner: Cloud,
                 surf: Cloud, L_now, sm_cfg: ScanMatchConfig, matcher_cfg: MatcherConfig,
                 map_cfg: MapConfig, recenter: bool = True):
    """Full LaserMapping step against the cube-grid map: recentre the window
    on the merge guess (unless ``recenter=False``), gather the surround,
    solve, commit and insert.  ``map_state`` is updated in place.  Spans
    ``mapping.prepare_frame``, ``mapping.recenter``, ``mapping.surround``,
    the solve's ``scan_match.solve`` and ``mapping.insert`` (the commit).
    Returns (matcher', map_state, MappingOutput)."""
    T_guess = se3.transform_associate(matcher.L_last, L_now, matcher.W_last)
    with profiling.span("mapping.prepare_frame"):
        corner_ds, surf_ds = prepare_frame(corner, surf, matcher_cfg)

    sensor_pos = T_guess[:3, 3]
    if recenter:
        with profiling.span("mapping.recenter"):
            map_state = fm.recenter(map_state, sensor_pos, map_cfg)
    with profiling.span("mapping.surround"):
        ref_corner, ref_surf = fm.get_surround(map_state, sensor_pos, map_cfg)

    res = sm.scan_match(corner_ds, surf_ds, ref_corner, ref_surf, twist.from_mat(T_guess),
                        sm_cfg)
    with profiling.span("mapping.insert"):
        W_new, map_state = _commit(res, T_guess, map_state, corner_ds, surf_ds, map_cfg,
                                   matcher_cfg)
    return (MatcherState(L_last=L_now, W_last=W_new), map_state,
            MappingOutput(W=W_new, result=res, corner_ds=corner_ds, surf_ds=surf_ds))


def _commit(res, T_guess, map_state, corner_ds, surf_ds, map_cfg, matcher_cfg):
    """Commit the solve into (pose, map) under the rejection policy.

    ``commit_rejected_solves=True`` is the reference: the solved pose is
    committed and inserted even when the score gate rejected it
    (ScanMatch.cpp:325-346).  The default falls back to the dead-reckoned
    merge guess for a rejected solve (LaserLocalization.cpp:140-166) and
    inserts the frame at that guess.
    """
    W_new = _committed_pose(res, T_guess, matcher_cfg)
    map_state = fm.add_feature_cloud(map_state, _to_world(corner_ds, W_new),
                                     _to_world(surf_ds, W_new), map_cfg)
    return W_new, map_state


def _committed_pose(res, T_guess, matcher_cfg):
    if matcher_cfg.commit_rejected_solves:
        return twist.to_mat(res.x)
    return torch.where(res.success, twist.to_mat(res.x), T_guess)


def mapping_local_step(matcher: MatcherState, map_state: lm.LocalMapState, corner: Cloud,
                       surf: Cloud, L_now, sm_cfg: ScanMatchConfig, matcher_cfg: MatcherConfig,
                       surround_corner: int = 8192, surround_surf: int = 16384):
    """LaserMappingLocal step against the sliding-window map
    (LaserMappingLocal.cpp:55-77): surround, solve, then the frame enters
    the window at the committed pose (the dead-reckoned guess where the gate
    rejected the solve, as in ``mapping_step``).  ``map_state`` is updated
    in place.  Returns (matcher', map_state, MappingOutput)."""
    T_guess = se3.transform_associate(matcher.L_last, L_now, matcher.W_last)
    corner_ds, surf_ds = prepare_frame(corner, surf, matcher_cfg)
    ref_corner, ref_surf = lm.get_surround(map_state, surround_corner, surround_surf,
                                           matcher_cfg.corner_leaf, matcher_cfg.surf_leaf)

    res = sm.scan_match(corner_ds, surf_ds, ref_corner, ref_surf, twist.from_mat(T_guess),
                        sm_cfg)
    W_new = _committed_pose(res, T_guess, matcher_cfg)
    map_state = lm.add_frame(map_state, _to_world(corner_ds, W_new), _to_world(surf_ds, W_new),
                             W_new)
    return (MatcherState(L_last=L_now, W_last=W_new), map_state,
            MappingOutput(W=W_new, result=res, corner_ds=corner_ds, surf_ds=surf_ds))


def localization_step(matcher: MatcherState, map_state: fm.FeatureMapState, corner: Cloud,
                      surf: Cloud, L_now, sm_cfg: ScanMatchConfig,
                      matcher_cfg: MatcherConfig, map_cfg: MapConfig):
    """LaserLocalization step: match against a pre-built map and never
    write it (LaserLocalization.cpp:124-138).  The pose is committed only on
    a passing gate; a failed one keeps the dead-reckoned guess.
    Returns (matcher', MappingOutput)."""
    T_guess = se3.transform_associate(matcher.L_last, L_now, matcher.W_last)
    corner_ds, surf_ds = prepare_frame(corner, surf, matcher_cfg)
    ref_corner, ref_surf = fm.get_surround(map_state, T_guess[:3, 3], map_cfg)

    res = sm.scan_match(corner_ds, surf_ds, ref_corner, ref_surf, twist.from_mat(T_guess),
                        sm_cfg)
    W_new = torch.where(res.success, twist.to_mat(res.x), T_guess)
    return (MatcherState(L_last=L_now, W_last=W_new),
            MappingOutput(W=W_new, result=res, corner_ds=corner_ds, surf_ds=surf_ds))


def seed_localization(matcher: MatcherState, pose, L_now) -> MatcherState:
    """(Re)seed from an initial pose (initialpose/GNSS, LaserLocalization.cpp:39-110)."""
    return MatcherState(L_last=L_now, W_last=pose)
