"""Point-to-line / point-to-plane residuals and the 5-NN line and plane fits
(port of ``cooper_mapper_tpu/ops/residuals.py``; feature_utils.h:17-204).

Batched over any leading dimensions; validity comes back as masks.  The
scan-to-map solve calls the component-plane fits (``fit_line_planes`` /
``fit_plane_planes``), which keep the JAX package's order of f32 operations
(Python ``sum`` over the K neighbours, the centred adjugate, the 1e-8
diagonal floor).  ``fit_line`` / ``fit_plane`` are the array forms of the
library's API, on ``torch.linalg`` as the JAX ones are on ``jnp.linalg``.
"""

from __future__ import annotations

import torch

from . import eig3


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


def corner_coeff_map(A, B, X, slope=0.9, weight_min=0.1):
    """Map corner coefficients (feature_utils.h:63-75): w = 1 - 0.9|d|."""
    d, direction = line_point_distance(A, B, X)
    w = 1.0 - slope * torch.abs(d)
    valid = w > weight_min
    return direction * w[..., None], d * w, valid


def surf_coeff_map(plane, X, slope=0.9, weight_min=0.1, eps=1e-12):
    """Map surface coefficients from a fitted plane (feature_utils.h:97-106).
    plane: [..., 4] (a, b, c, d) with |abc| = 1; signed distance, not abs."""
    signed = torch.sum(plane[..., :3] * X, dim=-1) + plane[..., 3]
    xnorm = torch.sqrt(torch.clamp(_norm(X), min=eps))
    w = 1.0 - slope * torch.abs(signed) / xnorm
    valid = w > weight_min
    return plane[..., :3] * w[..., None], signed * w, valid


def fit_line(neighbors, mask=None, eig_ratio=5.0, half_length=0.1):
    """5-point PCA line fit (findLine, feature_utils.h:108-154).

    neighbors: [..., K, 3].  Returns (A, B, valid): two points
    ``half_length`` either side of the centroid along the principal
    direction (its sign is the eigensolver's); valid iff
    lambda_max > eig_ratio * lambda_mid.
    """
    k = neighbors.shape[-2]
    centroid = torch.mean(neighbors, dim=-2, keepdim=True)
    a = neighbors - centroid
    cov = torch.einsum("...ki,...kj->...ij", a, a) / k
    evals, evecs = torch.linalg.eigh(cov)
    v = evecs[..., :, 2]
    valid = evals[..., 2] > eig_ratio * evals[..., 1]
    c = centroid[..., 0, :]
    A = c - half_length * v
    B = c + half_length * v
    if mask is not None:
        valid = valid & mask
    return A, B, valid


def fit_plane(neighbors, mask=None, max_dist=0.2, planar_ratio=0.05, eps=1e-12):
    """5-point least-squares plane (findPlane, feature_utils.h:156-204).

    Solves n . p = -1 in the least-squares sense, normalizes, sets
    d = -n . centroid, and rejects a fit with a neighbour further than
    ``max_dist`` from the plane, and (``planar_ratio > 0``) a collinear
    neighbour set: lambda_mid <= planar_ratio * lambda_max.  Returns
    (plane [..., 4], valid).
    """
    k = neighbors.shape[-2]
    AtA = torch.einsum("...ki,...kj->...ij", neighbors, neighbors)
    Atb = -torch.sum(neighbors, dim=-2)
    eye = torch.eye(3, dtype=neighbors.dtype, device=neighbors.device)
    n = torch.linalg.solve(AtA + 1e-8 * eye, Atb[..., None])[..., 0]
    n = n / torch.clamp(_norm(n)[..., None], min=eps)
    centroid = torch.mean(neighbors, dim=-2)
    d = -torch.sum(n * centroid, dim=-1)
    dist = torch.abs(torch.einsum("...ki,...i->...k", neighbors, n) + d[..., None])
    valid = torch.all(dist <= max_dist, dim=-1)
    if planar_ratio > 0.0:
        a = neighbors - centroid[..., None, :]
        cov = torch.einsum("...ki,...kj->...ij", a, a) / k
        evals = torch.linalg.eigvalsh(cov)
        valid = valid & (evals[..., 1] > planar_ratio * evals[..., 2])
    if mask is not None:
        valid = valid & mask
    return torch.cat([n, d[..., None]], dim=-1), valid


def fit_line_planes(px, py, pz, mask=None, eig_ratio=5.0, half_length=0.1):
    """5-point PCA line fit (findLine, feature_utils.h:108-154) on K
    coordinate planes (px/py/pz: lists of K [...] tensors).

    Returns (A, B, valid): points ``half_length`` either side of the
    centroid along the principal direction; valid iff
    lambda_max > eig_ratio * lambda_mid.
    """
    k = len(px)
    mx, my, mz = sum(px) / k, sum(py) / k, sum(pz) / k
    ax = [c - mx for c in px]
    ay = [c - my for c in py]
    az = [c - mz for c in pz]
    cxx = sum(a * a for a in ax) / k
    cyy = sum(a * a for a in ay) / k
    czz = sum(a * a for a in az) / k
    cxy = sum(a * b for a, b in zip(ax, ay)) / k
    cxz = sum(a * b for a, b in zip(ax, az)) / k
    cyz = sum(a * b for a, b in zip(ay, az)) / k
    lam0, lam1, lam2 = eig3.eigvalsh3(cxx, cxy, cxz, cyy, cyz, czz)
    vx, vy, vz = eig3.principal_evec3(cxx, cxy, cxz, cyy, cyz, czz, lam2)
    valid = lam2 > eig_ratio * lam1
    h = half_length
    A = torch.stack([mx - h * vx, my - h * vy, mz - h * vz], dim=-1)
    B = torch.stack([mx + h * vx, my + h * vy, mz + h * vz], dim=-1)
    if mask is not None:
        valid = valid & mask
    return A, B, valid


def fit_plane_planes(px, py, pz, mask=None, max_dist=0.2, planar_ratio=0.05,
                     eps=1e-12):
    """5-point least-squares plane (findPlane, feature_utils.h:156-204) on K
    coordinate planes.  Returns (plane [..., 4], valid).

    The n.p = -1 LSQ normal is ``-(C + 1e-8 I)^{-1} c`` up to a positive
    scale, with C the centred covariance sums and c the centroid, solved by
    the closed-form symmetric adjugate.  Rejects a fit with a neighbour
    further than ``max_dist`` from the plane, and (``planar_ratio > 0``) a
    collinear neighbour set: lambda_mid <= planar_ratio * lambda_max.
    """
    k = len(px)
    mx, my, mz = sum(px) / k, sum(py) / k, sum(pz) / k
    ax = [c - mx for c in px]
    ay = [c - my for c in py]
    az = [c - mz for c in pz]
    cxx = sum(a * a for a in ax) + 1e-8
    cyy = sum(a * a for a in ay) + 1e-8
    czz = sum(a * a for a in az) + 1e-8
    cxy = sum(a * b for a, b in zip(ax, ay))
    cxz = sum(a * b for a, b in zip(ax, az))
    cyz = sum(a * b for a, b in zip(ay, az))

    adj00 = cyy * czz - cyz * cyz
    adj01 = cxz * cyz - cxy * czz
    adj02 = cxy * cyz - cyy * cxz
    adj11 = cxx * czz - cxz * cxz
    adj12 = cxy * cxz - cxx * cyz
    adj22 = cxx * cyy - cxy * cxy
    nx = -(adj00 * mx + adj01 * my + adj02 * mz)
    ny = -(adj01 * mx + adj11 * my + adj12 * mz)
    nz = -(adj02 * mx + adj12 * my + adj22 * mz)

    norm = torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=eps)
    nx, ny, nz = nx / norm, ny / norm, nz / norm
    d = -(nx * mx + ny * my + nz * mz)

    valid = torch.ones_like(d, dtype=torch.bool)
    for x, y, z in zip(px, py, pz):
        dist = torch.abs(x * nx + y * ny + z * nz + d)
        valid = valid & (dist <= max_dist)
    if planar_ratio > 0.0:
        _, lam1, lam2 = eig3.eigvalsh3(cxx, cxy, cxz, cyy, cyz, czz)
        valid = valid & (lam1 > planar_ratio * lam2)
    if mask is not None:
        valid = valid & mask
    return torch.stack([nx, ny, nz, d], dim=-1), valid
