"""Closed-form symmetric 3x3 eigen-analysis on component planes
(port of ``cooper_mapper_tpu/ops/eig3.py``).

Smith's trigonometric eigenvalues (Comm. ACM 4(4), 1961) and the
cross-product principal eigenvector, elementwise over the six covariance
component planes (cxx, cxy, cxz, cyy, cyz, czz).
"""

from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigvalsh3(cxx, cxy, cxz, cyy, cyz, czz):
    """Eigenvalues (ascending) of symmetric 3x3 given component planes."""
    q = (cxx + cyy + czz) / 3.0
    dxx, dyy, dzz = cxx - q, cyy - q, czz - q
    p2 = dxx * dxx + dyy * dyy + dzz * dzz + 2.0 * (cxy * cxy + cxz * cxz + cyz * cyz)
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    safe_p = torch.where(p > 0.0, p, torch.ones_like(p))
    bxx, byy, bzz = dxx / safe_p, dyy / safe_p, dzz / safe_p
    bxy, bxz, byz = cxy / safe_p, cxz / safe_p, cyz / safe_p
    detb = (
        bxx * (byy * bzz - byz * byz)
        - bxy * (bxy * bzz - byz * bxz)
        + bxz * (bxy * byz - byy * bxz)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    l1 = 3.0 * q - l2 - l0
    return l0, l1, l2


def principal_evec3(cxx, cxy, cxz, cyy, cyz, czz, lam):
    """Unit eigenvector (vx, vy, vz) for eigenvalue ``lam``; +x when the
    spectrum is (near-)isotropic."""
    m00, m11, m22 = cxx - lam, cyy - lam, czz - lam
    c01 = (cxy * cyz - cxz * m11, cxz * cxy - m00 * cyz, m00 * m11 - cxy * cxy)
    c02 = (cxy * m22 - cxz * cyz, cxz * cxz - m00 * m22, m00 * cyz - cxy * cxz)
    c12 = (m11 * m22 - cyz * cyz, cyz * cxz - cxy * m22, cxy * cyz - m11 * cxz)
    n01 = c01[0] ** 2 + c01[1] ** 2 + c01[2] ** 2
    n02 = c02[0] ** 2 + c02[1] ** 2 + c02[2] ** 2
    n12 = c12[0] ** 2 + c12[1] ** 2 + c12[2] ** 2

    use02 = n02 >= n01
    bx = torch.where(use02, c02[0], c01[0])
    by = torch.where(use02, c02[1], c01[1])
    bz = torch.where(use02, c02[2], c01[2])
    bn = torch.where(use02, n02, n01)
    use12 = n12 >= bn
    bx = torch.where(use12, c12[0], bx)
    by = torch.where(use12, c12[1], by)
    bz = torch.where(use12, c12[2], bz)
    bn = torch.where(use12, n12, bn)

    ok = bn > 0.0
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, bn, torch.ones_like(bn))),
                      torch.zeros_like(bn))
    vx = torch.where(ok, bx * inv, torch.ones_like(bx))
    vy = torch.where(ok, by * inv, torch.zeros_like(by))
    vz = torch.where(ok, bz * inv, torch.zeros_like(bz))
    return vx, vy, vz
