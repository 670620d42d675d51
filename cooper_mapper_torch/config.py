"""Configuration dataclasses of the ported slices.

Field-for-field copies of ``RegistrationConfig``, ``OdometryConfig``,
``ScanMatchConfig``, ``MapConfig`` and ``MatcherConfig`` in
``cooper_mapper_tpu/config.py`` (tests/test_torch_config.py holds them
together).  ``PipelineConfig`` carries only the fields the single-stream
sweep (``models/fused.py``) reads; the UKF, keyframe, loop and pose-graph
sections belong to slices not ported yet.  The port keeps its own
copy because it must import nothing of the JAX package.
``OdometryConfig``'s ``nn_query_chunk``, ``kernel_backend``,
``nn_precision`` and ``unroll_iters`` and ``ScanMatchConfig.kernel_backend``
are carried for field parity only, and the solves raise unless they keep
their defaults: the port's dispatch follows the tensors' device (a CUDA
tensor launches the kernels, a CPU tensor runs their plain versions), its
products are always full f32, and its GN loops are Python loops.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Feature-extraction parameters (ScanRegistration.h:43-119)."""

    scan_period: float = 0.1
    n_feature_regions: int = 6
    curvature_region: int = 5
    max_corner_sharp: int = 2
    max_corner_less_sharp: int = 20
    max_surface_flat: int = 4
    surface_curvature_threshold: float = 0.02
    corner_curvature_threshold: float = 1.0
    less_flat_filter_size: float = 0.2
    blind_threshold: float = 0.9996
    min_range: float = 0.5
    max_range: float = 150.0
    classify_eig_ratio12: float = 100.0
    classify_eig_ratio13: float = 10000.0
    classify_line_tol: float = 0.08
    n_rings: int = 16
    max_points_per_ring: int = 2048
    max_sharp: int = 256
    max_less_sharp: int = 2048
    max_flat: int = 1024
    max_less_flat: int = 8192


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan solver (LaserOdometry.cpp:24-25 and scanMatch)."""

    max_iterations: int = 25
    delta_r_abort: float = 0.1
    delta_t_abort: float = 0.1
    refresh_every: int = 5
    n_rings: int = 16
    nn_sq_dist_max: float = 25.0
    ring_span: float = 2.5
    residual_scale: float = 0.05
    corner_weight_slope: float = 1.8
    weight_min: float = 0.1
    eig_threshold: float = 10.0
    min_matched: int = 10
    trust_region_t: float = 0.3
    trust_region_r: float = 0.05
    min_converge_iter: int = 6
    nn_query_chunk: int = 0
    kernel_backend: str = "auto"
    nn_precision: str | None = None
    unroll_iters: bool = False
    cv_dewarp: bool = True
    dewarp_passes: int = 1


@dataclasses.dataclass(frozen=True)
class ScanMatchConfig:
    """Scan-to-map solver (ScanMatch.cpp)."""

    max_iterations: int = 10
    delta_r_abort: float = 0.05
    delta_t_abort: float = 0.05
    knn: int = 5
    nn_sq_dist_max: float = 5.0       # 5th-NN gate (ScanMatch.cpp:102)
    plane_max_dist: float = 0.2       # findPlane inlier check (:122)
    line_eig_ratio: float = 5.0       # findLine lambda2 > 5*lambda1 (feature_utils.h:145)
    weight_slope: float = 0.9         # map-variant robust weight (feature_utils.h:70,102)
    weight_min: float = 0.1
    eig_threshold: float = 100.0      # degeneracy (:223)
    min_matched: int = 50
    use_score: bool = True
    score_threshold: float = 800.0    # (:24)
    match_percentage_threshold: float = 0.4
    # scanMatchLocal downsample leaves (:29-30)
    local_corner_leaf: float = 0.2
    local_surf_leaf: float = 0.4
    # Marquardt-scaled diagonal damping: solve (JtJ + lam*diag(JtJ)) dx = Jtb;
    # 0 = pure GN (the reference's dynamics, ScanMatch.cpp:196-201)
    lm_damping: float = 0.0
    kernel_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Cube-grid feature map (FeatureMap.h; params LaserMatcher.cpp:107-113)."""

    cube_size: float = 50.0
    n_cubes: Tuple[int, int, int] = (21, 11, 21)
    valid_distance: float = 150.0        # lidarValidDistance (active-area cull)
    corner_cube_capacity: int = 4096     # points stored per cube
    surf_cube_capacity: int = 8192
    corner_leaf: float = 0.2             # insertion re-voxelize leaves
    surf_leaf: float = 0.4
    margin_cubes: int = 3                # sensor kept >= 3 cubes from boundary
    dedup_policy: str = "centroid"       # read by dedup_active, not ported yet
    surround_corner_capacity: int = 32768
    surround_surf_capacity: int = 65536
    # vertical-FOV active-area cull (DynamicFeatureMap.h:748-804); 0/0 disables
    vfov_up_deg: float = 0.0
    vfov_down_deg: float = 0.0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """LaserMatcher shared knobs (LaserMatcher.cpp:45-170)."""

    corner_leaf: float = 0.2     # prepareFeatureFrame voxel leaves (:288-301)
    surf_leaf: float = 0.4
    dynamic_mode: bool = False
    map_directory: str = "/tmp/cooper_dynamic_map"  # cube PCD store for dynamic_mode
    max_frame_corner: int = 4096   # downsampled incoming stack capacities
    max_frame_surf: int = 8192
    dedup_stride: int = 4
    commit_rejected_solves: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The fields of the JAX package's ``PipelineConfig`` that the
    single-stream sweep reads, with the same defaults."""

    registration: RegistrationConfig = RegistrationConfig()
    odometry: OdometryConfig = OdometryConfig()
    scan_match: ScanMatchConfig = ScanMatchConfig()
    feature_map: MapConfig = MapConfig()
    matcher: MatcherConfig = MatcherConfig()
    mapping_stride: int = 2   # mapping every Nth sweep (rate decoupling)
