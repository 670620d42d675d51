"""Configuration dataclasses of the ported slice.

Field-for-field copies of ``RegistrationConfig`` and ``OdometryConfig`` in
``cooper_mapper_tpu/config.py`` (tests/test_torch_config.py holds them
together).  The port keeps its own copy because it must import nothing of
the JAX package.  ``nn_query_chunk``, ``kernel_backend``, ``nn_precision``
and ``unroll_iters`` are carried for field parity only, and the solve
raises unless they keep their defaults: the port's dispatch follows the
tensors' device (a CUDA tensor launches the race kernels, a CPU tensor runs
their plain versions), its products are always full f32, and its GN loop
is a Python loop.
"""

from __future__ import annotations

import dataclasses


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
