"""Offline map -> localization feature map converter (port of
``cooper_mapper_tpu/io/feature_extracter.py``).

Re-design of the ``featureExtracter`` CLI (io_module/feature_extracter.cpp:
30-133, driven by scripts/map_convert_for_localization.sh): load a dense
aggregated map cloud, estimate the local surface structure of every point,
classify planar points as surf features and edge points as corner
features, insert them into a cube map, and save the cube manifest.

The structure comes from a k-NN PCA over the whole cloud: the k neighbours
of every point from ``ops/knn.knn`` (on the card the CUDA k-NN kernels at
the caller's k, 10 by default, any ``1 <= k <= N``; on the CPU
``knn_plain``, which chunks the distance tile itself, so the JAX package's
``chunk`` argument has no counterpart), then the eigenvalues of the
neighbourhood covariance (``torch.linalg.eigvalsh``): planarity marks surf
points, linearity corner points.  Points past a cube's capacity are dropped
on insertion, as in the JAX package (``feature_map._insert``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MapConfig
from ..maps import feature_map as fm
from ..ops import knn as knn_ops
from ..utils import cloud as cloud_lib
from . import map_io


def neighbours(pts: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Indices [N, k] (int64) of the k nearest points of every point of
    ``pts`` [N, 3] within the cloud itself (itself included), ascending."""
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    idx, _ = knn_ops.knn(pts[None], pts, mask, k)
    return idx[0].long()


# Covariances per eigvalsh call: on the card, cuSOLVER's batched solver
# (cusolverDnXsyevBatched) rejects 32768 or more 3x3 matrices in one call
# (CUSOLVER_STATUS_INVALID_VALUE; PyTorch 2.11 with CUDA 12.8), and a map
# cloud has hundreds of thousands.
EIG_BATCH = 1 << 14


def eigenvalues(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues [N, 3] of each neighbourhood's covariance
    (``idx`` [N, k] rows of ``pts``), EIG_BATCH neighbourhoods at a time."""
    nb = pts[idx]                                    # [N, k, 3]
    a = nb - nb.mean(dim=-2, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", a, a) / idx.shape[-1]
    return torch.cat([torch.linalg.eigvalsh(c) for c in cov.split(EIG_BATCH)])


def labels(evals: torch.Tensor, planar_thresh: float = 0.05, linear_thresh: float = 5.0):
    """(is_surf, is_corner) from ascending eigenvalues [N, 3]: planar when
    the smallest is tiny against the middle one (and the middle one is not
    tiny against the largest); linear when the largest dominates the
    middle one."""
    l0, l1, l2 = evals.unbind(-1)
    is_surf = (l0 < planar_thresh * torch.clamp(l1, min=1e-12)) & (
        l1 > 0.05 * torch.clamp(l2, min=1e-12))
    is_corner = (l2 > linear_thresh * torch.clamp(l1, min=1e-12)) & ~is_surf
    return is_surf, is_corner


def threshold_margin(evals: torch.Tensor, planar_thresh: float = 0.05,
                     linear_thresh: float = 5.0) -> torch.Tensor:
    """Per point, the smallest relative distance of ``labels``' three
    comparisons from their thresholds: where it is within an ulp-sized
    margin, another evaluation of the same eigenvalues may flip a label."""
    l0, l1, l2 = evals.unbind(-1)
    rel = lambda a, b: (a - b).abs() / torch.clamp(b.abs(), min=1e-30)
    return torch.stack([rel(l0, planar_thresh * torch.clamp(l1, min=1e-12)),
                        rel(l1, 0.05 * torch.clamp(l2, min=1e-12)),
                        rel(l2, linear_thresh * torch.clamp(l1, min=1e-12))], -1).amin(-1)


def classify_map_points(xyz, k: int = 10, planar_thresh: float = 0.05,
                        linear_thresh: float = 5.0, device="cuda"):
    """Per-point structure classification by k-NN PCA on ``device``.

    Returns (is_surf [N], is_corner [N]) as numpy bool arrays.
    """
    pts = torch.as_tensor(np.asarray(xyz, np.float32)).to(device)
    evals = eigenvalues(pts, neighbours(pts, k))
    is_surf, is_corner = labels(evals, planar_thresh, linear_thresh)
    return is_surf.cpu().numpy(), is_corner.cpu().numpy()


def extract_feature_map(xyz, cfg: MapConfig, k: int = 10, batch_insert: int = 8192,
                        device="cuda") -> fm.FeatureMapState:
    """Dense map cloud -> FeatureMapState of corner / surf features on
    ``device``: corners first, then surfs, in batches of ``batch_insert``."""
    xyz = np.asarray(xyz, np.float32)
    is_surf, is_corner = classify_map_points(xyz, k=k, device=device)
    state = fm.create(cfg, device)
    empty = cloud_lib.empty(1, device)
    for points, as_corner in ((xyz[is_corner], True), (xyz[is_surf], False)):
        for lo in range(0, len(points), batch_insert):
            c = cloud_lib.from_points(points[lo:lo + batch_insert], device=device)
            state = fm.add_feature_cloud(state, *((c, empty) if as_corner else (empty, c)), cfg)
    return state


def convert_map_for_localization(pcd_path: str, out_dir: str, cfg: MapConfig,
                                 device="cuda") -> int:
    """The map_convert_for_localization.sh flow: PCD in, cube manifest out.
    Returns the number of cube files written."""
    from . import pcd as pcd_io

    xyz, _ = pcd_io.read_pcd(pcd_path)
    return map_io.save_feature_map(extract_feature_map(xyz, cfg, device=device), cfg, out_dir)
