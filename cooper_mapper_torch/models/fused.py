"""Single-stream SLAM sweep steps: registration -> odometry [-> mapping]
(port of ``cooper_mapper_tpu/models/fused.py``).

The JAX package runs each sweep as one jitted program with donated state.
Here each step is a sequence of eager PyTorch calls on the state's device,
and the state is carried the same way: the odometry reference clouds and
the matcher poses are replaced, the cube map is updated in place
(``maps/feature_map.py``), the counterpart of the donated buffers.  Used by
``chip_smoke.py`` to drive the single-stream deployment of
``benchmarks/bench_realtime.py`` (LOAM's 100 ms odometry / 1000 ms mapping
budgets per sweep).  With ``utils/profiling.tracing`` on, a sweep's stages
are spans: ``features.extract`` here, the solves' roots
(``odometry.solve``, ``scan_match.solve``) and the map's stages
(``mapping.*``, ``laser_mapping.mapping_step``).
"""

from __future__ import annotations

import dataclasses

from ..config import PipelineConfig
from ..maps import feature_map as fm
from ..ops import features as feat_ops
from ..ops.features import Sweep
from ..utils import profiling
from . import laser_mapping, laser_odometry


@dataclasses.dataclass
class FusedState:
    odo: laser_odometry.OdometryState
    matcher: laser_mapping.MatcherState
    map: fm.FeatureMapState


def create(cfg: PipelineConfig, map_state: fm.FeatureMapState | None = None,
           device="cuda") -> FusedState:
    r = cfg.registration
    return FusedState(
        odo=laser_odometry.create(r.max_less_sharp, r.max_less_flat, device),
        matcher=laser_mapping.create_matcher(device),
        map=map_state if map_state is not None else fm.create(cfg.feature_map, device),
    )


def _extract(sweep: Sweep, cfg: PipelineConfig):
    """The sweep's features (span ``features.extract``)."""
    with profiling.span("features.extract"):
        return feat_ops.extract_features(sweep, cfg.registration)


def init_sweep(state: FusedState, sweep: Sweep, cfg: PipelineConfig) -> FusedState:
    """First sweep: extract and store the reference clouds, no solve."""
    fc = _extract(sweep, cfg)
    odo = laser_odometry.init_step(state.odo, fc, cfg.odometry)
    return FusedState(odo=odo, matcher=state.matcher, map=state.map)


def odometry_sweep(state: FusedState, sweep: Sweep, cfg: PipelineConfig):
    """Registration + scan-to-scan solve + high-rate merged pose.
    Returns (state', merged_pose [4, 4], n_matched)."""
    fc = _extract(sweep, cfg)
    odo, out = laser_odometry.step(state.odo, fc, cfg.odometry)
    merged = laser_mapping.merged_pose(state.matcher, out.T_sum)
    return FusedState(odo=odo, matcher=state.matcher, map=state.map), merged, out.n_matched


def mapping_sweep(state: FusedState, sweep: Sweep, cfg: PipelineConfig):
    """Registration + odometry + the scan-to-map step (recentre, surround
    gather, solve, gate, insert; the map in place).
    Returns (state', mapped_pose [4, 4], success)."""
    fc = _extract(sweep, cfg)
    odo, out = laser_odometry.step(state.odo, fc, cfg.odometry)
    matcher, map_state, mo = laser_mapping.mapping_step(
        state.matcher, state.map, out.corner_for_map, out.surf_for_map, out.T_sum,
        cfg.scan_match, cfg.matcher, cfg.feature_map)
    return FusedState(odo=odo, matcher=matcher, map=map_state), mo.W, mo.result.success
