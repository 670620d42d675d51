"""Point-to-line / point-to-plane residuals, odometry half
(port of ``cooper_mapper_tpu/ops/residuals.py``; feature_utils.h:17-95).

Batched over any leading dimensions; validity comes back as masks.
"""

from __future__ import annotations

import torch


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def line_point_distance(A, B, X, eps=1e-12):
    """Distance from X to line AB and the unit direction of steepest descent
    (getLinePointDistance, feature_utils.h:17-26)."""
    cr = torch.linalg.cross(X - B, X - A)
    cr_norm = _norm(cr)
    ab = _norm(A - B)
    denom = torch.clamp(cr_norm * ab, min=eps)
    direction = -torch.linalg.cross(cr, B - A) / denom[..., None]
    distance = cr_norm / torch.clamp(ab, min=eps)
    return distance, direction


def surface_point_distance(A, B, C, X, eps=1e-12):
    """Distance from X to plane ABC; normal oriented toward X
    (getSurfacePointDistance, feature_utils.h:28-40)."""
    n = torch.linalg.cross(B - A, C - A)
    n = n / torch.clamp(_norm(n)[..., None], min=eps)
    signed = torch.sum((X - A) * n, dim=-1)
    n = torch.where(signed[..., None] < 0, -n, n)
    return torch.abs(signed), n


def corner_coeff_odometry(A, B, X, iteration: int, slope=1.8, weight_min=0.1):
    """Odometry corner coefficients (feature_utils.h:42-61): weight
    ``1 - slope*|d|`` once iteration >= 5.  Returns (direction*w, d*w, valid)."""
    d, direction = line_point_distance(A, B, X)
    w = 1.0 - slope * torch.abs(d) if iteration >= 5 else torch.ones_like(d)
    valid = (w > weight_min) & (d != 0.0)
    return direction * w[..., None], d * w, valid


def surf_coeff_odometry(A, B, C, X, iteration: int, slope=1.8, weight_min=0.1,
                        eps=1e-12):
    """Odometry surface coefficients (feature_utils.h:77-95): weight
    ``1 - slope*|d| / sqrt(|X|)`` once iteration >= 5 (the square root of the
    norm, as the reference has it)."""
    d, n = surface_point_distance(A, B, C, X)
    xnorm = torch.sqrt(torch.clamp(_norm(X), min=eps))
    w = 1.0 - slope * torch.abs(d) / xnorm if iteration >= 5 else torch.ones_like(d)
    valid = (w > weight_min) & (d != 0.0)
    return n * w[..., None], d * w, valid
