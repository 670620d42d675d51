"""Configuration dataclasses of the port.

Field-for-field copies of every configuration class in
``cooper_mapper_tpu/config.py``, and of its per-sensor presets
(tests/test_torch_config.py holds them together).  The port keeps its own
copy because it must import nothing of the JAX package.
``OdometryConfig``'s ``nn_query_chunk``, ``kernel_backend``,
``nn_precision`` and ``unroll_iters`` and ``ScanMatchConfig.kernel_backend``
are the JAX package's memory, dispatch and loop knobs.  The port accepts
each at every value the JAX package accepts, since on the CPU the JAX
package gives its default's result at each (``ops/odometry.check_knobs``):
``nn_query_chunk`` caps the plain
versions' query chunk (the card's kernels hold no distance tile);
``kernel_backend`` ("auto", "pallas" or "dense") names the same search,
which follows the tensors' device (a CUDA tensor launches the kernels, a
CPU tensor runs their plain versions); every ``nn_precision`` string the
JAX package accepts leaves the port's full-f32 products as they are; and
``unroll_iters`` changes nothing (the GN loops are Python loops).
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
    dedup_policy: str = "centroid"       # dedup_active: "centroid" or "anchor"
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
class UKFConfig:
    """UKF fusion (ukf_pose_estimator.hpp:35-60, unscented_kalman_filter.hpp)."""

    state_dim: int = 16    # [p(3), v(3), q(4), acc_bias(3), gyro_bias(3)]
    input_dim: int = 6     # [acc(3), gyro(3)]
    measure_dim: int = 10  # [p(3), v(3), q(4)]
    lam: float = 1.0       # sigma-point lambda (:45)
    # process noise scaling (pos/vel x10, quat x5, biases 1e-6)
    process_noise_pos: float = 10.0 * 1e-3
    process_noise_vel: float = 10.0 * 1e-3
    process_noise_quat: float = 5.0 * 1e-3
    process_noise_bias: float = 1e-6
    measure_noise_pos: float = 0.01
    measure_noise_vel: float = 0.1
    measure_noise_quat: float = 0.001
    cool_time_duration: float = 1.0   # predict cool-down (:70)
    max_velocity: float = 30.0        # clamp before correct (LaserLocalization.cpp:158)
    reset_jump: float = 5.0           # UKF reset when correction jumps > 5 m


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe gating (keyframe_updater.hpp:12-48)."""

    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.05


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop detection thresholds (loop_detector.hpp:57-63, 106-164)."""

    distance_thresh: float = 5.0          # radius for trajectory NN
    estimated_distance_thresh: float = 25.0
    accum_distance_thresh: float = 30.0   # traveled-distance gap
    min_loop_interval: float = 3.0        # distance since last loop
    max_candidates: int = 6
    candidate_cluster_dist: float = 5.0
    # fine matching reuses ScanMatchConfig with scanMatchLocal leaves, plus
    # Marquardt damping (ScanMatchConfig.lm_damping): the stacked
    # multi-keyframe reference makes the undamped GN prone to a
    # correspondence-flip limit cycle just above the convergence thresholds
    # (measured: lam=1 converges in 7 iters to the cycle's center pose;
    # lam=0 oscillates forever — BENCH.md round-5 notes)
    fine_damping: float = 1.0


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Pose-graph backend (graph.cpp, solver_g2o.cpp)."""

    max_iterations: int = 50            # LM iterations (g2o budget is 1000)
    max_nodes: int = 1024
    max_edges: int = 2048
    lm_init_lambda: float = 1e-4
    lm_lambda_factor: float = 10.0
    # hand-set information matrices (graph.cpp:281-291, 334-341)
    seq_info_trans: Tuple[float, float, float] = (0.8, 0.4, 0.8)
    seq_info_rot: Tuple[float, float, float] = (1.0, 2.0, 1.0)
    loop_info: float = 2.0
    # inner linear solver: "dense" (Cholesky/LU on the [6N,6N] system, best
    # for small graphs) or "cg" (matrix-free block-Jacobi PCG over per-edge
    # 6x6 blocks — O(E+N) memory, the scalable path for city-size graphs)
    solver: str = "dense"
    pcg_iters: int = 64                 # CG iterations for solver="cg"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    registration: RegistrationConfig = RegistrationConfig()
    odometry: OdometryConfig = OdometryConfig()
    scan_match: ScanMatchConfig = ScanMatchConfig()
    feature_map: MapConfig = MapConfig()
    matcher: MatcherConfig = MatcherConfig()
    ukf: UKFConfig = UKFConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    loop: LoopConfig = LoopConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    mapping_stride: int = 2   # mapping every Nth sweep (rate decoupling)
    # run the pose-graph backend in-loop: mapping outputs are gated into
    # keyframes, loops are detected/optimized, and the odom->graph correction
    # is applied to the reported trajectory (the Graph node riding the
    # mapping output, graph.cpp:301-378)
    enable_graph: bool = False


# Per-sensor presets mirroring the launch-file parameter sets
# (launch/node/lidar_mapping.launch, lidar_localization.launch).

def vlp16() -> PipelineConfig:
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=16, max_points_per_ring=2048),
        odometry=OdometryConfig(n_rings=16),
    )


def hdl32() -> PipelineConfig:
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=32, max_points_per_ring=2048),
        odometry=OdometryConfig(n_rings=32),
    )


def hdl64() -> PipelineConfig:
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=64, max_points_per_ring=2048),
        odometry=OdometryConfig(n_rings=64),
    )


def pandar40() -> PipelineConfig:
    return PipelineConfig(
        registration=RegistrationConfig(n_rings=40, max_points_per_ring=2048),
        odometry=OdometryConfig(n_rings=40),
    )


def tiny_test() -> PipelineConfig:
    """Small capacities for fast CPU tests."""
    return PipelineConfig(
        registration=RegistrationConfig(
            n_rings=8,
            max_points_per_ring=256,
            max_sharp=64,
            max_less_sharp=256,
            max_flat=128,
            max_less_flat=1024,
        ),
        feature_map=MapConfig(
            n_cubes=(7, 5, 7),
            corner_cube_capacity=512,
            surf_cube_capacity=1024,
            surround_corner_capacity=2048,
            surround_surf_capacity=4096,
        ),
        matcher=MatcherConfig(max_frame_corner=512, max_frame_surf=1024),
        pose_graph=PoseGraphConfig(max_nodes=64, max_edges=128),
    )
