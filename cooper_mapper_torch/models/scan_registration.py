"""Scan-registration front ends (port of ``cooper_mapper_tpu/models/scan_registration.py``;
MultiScanRegistration / OrganisedScanRegistration, ScanRegistration.cpp).

Turn raw device output into the organized [rings, W] ``Sweep`` grid, and
de-warp a sweep by the IMU's nonlinear motion.

* organized input (row = ring, column = azimuth): passed through with
  rel_time = column / width (OrganizedScanRegistration.cpp:111) and the
  range cull (:121-123);
* unorganized input (MultiScanRegistration): the LOAM axis remap
  (x, y, z) <- (y, z, x) (MultiScanRegistration.cpp:120-123), vertical
  angle -> ring (a linear mapper or the Pandar40 table), azimuth ->
  in-sweep time (:144-168), ring binning.

The organizers are per-sensor data marshalling on the host, in numpy as in
the JAX package (copied here; the port imports nothing of it); their
``Sweep`` goes to ``device``.  The IMU integration and de-warp run on the
tensors' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import RegistrationConfig
from ..ops.features import Sweep
from ..utils import se3


@dataclasses.dataclass(frozen=True)
class LinearRingMapper:
    """Linear vertical-angle -> ring mapping (MultiScanMapper)."""

    lower_deg: float
    upper_deg: float
    n_rings: int

    def ring(self, angle_deg):
        f = (self.n_rings - 1) / (self.upper_deg - self.lower_deg)
        return np.round((angle_deg - self.lower_deg) * f).astype(np.int32)


VLP16 = LinearRingMapper(-15.0, 15.0, 16)
HDL32 = LinearRingMapper(-30.67, 10.67, 32)
HDL64E = LinearRingMapper(-24.9, 2.0, 64)

# Pandar40 vendor elevation table (angle_pandar, lidar_type.h:13-53; the
# vendor lists rings top-down and scanID_pandar40 assigns ring = 39 - i, so
# the ascending-order table below gives the same ring ids via argmin).
_PANDAR40_ANGLES = np.array([
    -15.444, -14.543, -13.63, -12.705, -11.772, -10.826, -9.871, -8.908,
    -7.934, -6.957, -5.974, -5.647, -5.311, -4.986, -4.657, -4.321,
    -3.996, -3.663, -3.327, -3.0, -2.667, -2.331, -2.001, -1.667,
    -1.334, -1.001, -0.667, -0.334, 0.0, 0.333, 0.667, 1.001,
    1.333, 1.667, 2.001, 2.999, 3.996, 4.988, 5.976, 6.96,
])


@dataclasses.dataclass(frozen=True)
class TableRingMapper:
    angles_deg: tuple

    @property
    def n_rings(self):
        return len(self.angles_deg)

    def ring(self, angle_deg):
        table = np.asarray(self.angles_deg)
        return np.argmin(np.abs(np.asarray(angle_deg)[..., None] - table), axis=-1).astype(
            np.int32)


PANDAR40 = TableRingMapper(tuple(_PANDAR40_ANGLES.tolist()))


def _sweep(xyz, mask, rel_time, device) -> Sweep:
    return Sweep(xyz=torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(device),
                 mask=torch.from_numpy(np.ascontiguousarray(mask, bool)).to(device),
                 rel_time=torch.from_numpy(np.ascontiguousarray(rel_time, np.float32)).to(device))


def organize_unordered(points: np.ndarray, cfg: RegistrationConfig,
                       mapper: LinearRingMapper | TableRingMapper = VLP16,
                       axis_remap: bool = True, device="cuda") -> Sweep:
    """Unorganized [N, 3] device points -> organized Sweep grid
    (MultiScanRegistration::process, MultiScanRegistration.cpp:95-200): axis
    remap, NaN / range cull, ring id from the vertical angle, azimuth ->
    rel_time, ring-major rebuild sorted by azimuth."""
    pts = np.asarray(points, np.float32)
    if axis_remap:
        pts = pts[:, [1, 2, 0]]  # (x,y,z) <- (y,z,x)

    finite = np.isfinite(pts).all(-1)
    rng = np.linalg.norm(pts, axis=-1)
    ok = finite & (rng > cfg.min_range) & (rng < cfg.max_range)
    pts = pts[ok]

    # vertical angle about the spin (y) axis; azimuth in the x-z plane
    horiz = np.sqrt(pts[:, 0] ** 2 + pts[:, 2] ** 2)
    v_angle = np.rad2deg(np.arctan2(pts[:, 1], horiz))
    ring = mapper.ring(v_angle)
    ring_ok = (ring >= 0) & (ring < cfg.n_rings)
    pts, ring = pts[ring_ok], ring[ring_ok]

    azim = np.arctan2(pts[:, 2], pts[:, 0])
    rel = (azim - azim.min()) % (2 * np.pi) / (2 * np.pi)

    R, W = cfg.n_rings, cfg.max_points_per_ring
    xyz = np.zeros((R, W, 3), np.float32)
    mask = np.zeros((R, W), bool)
    rel_time = np.zeros((R, W), np.float32)
    for r in range(R):
        sel = ring == r
        order = np.argsort(rel[sel])
        p = pts[sel][order][:W]
        t = rel[sel][order][:W]
        n = len(p)
        xyz[r, :n] = p
        mask[r, :n] = True
        rel_time[r, :n] = t
    return _sweep(xyz, mask, rel_time, device)


def organize_grid(xyz: np.ndarray, cfg: RegistrationConfig, valid: Optional[np.ndarray] = None,
                  scan_period_fraction: bool = True, device="cuda") -> Sweep:
    """Organized [R, W, 3] input -> Sweep (OrganisedScanRegistration)."""
    xyz = np.asarray(xyz, np.float32)
    R, W = xyz.shape[:2]
    if valid is None:
        valid = np.isfinite(xyz).all(-1)
    rng = np.linalg.norm(xyz, axis=-1)
    valid = valid & (rng > cfg.min_range) & (rng < cfg.max_range)
    rel = np.broadcast_to(np.arange(W, dtype=np.float32)[None, :] / W, (R, W))
    return _sweep(np.where(valid[..., None], xyz, 1e6), valid, rel, device)


# ---------------------------------------------------------------------------
# IMU de-warp (ScanRegistration.cpp:89-188)
#
# The reference integrates IMU samples into a position / velocity history
# (handleIMUMessage, :89-120), interpolates the IMU state at each point's
# capture time (interpolateIMUStateFor, :171-188), and shifts every point by
# the nonlinear part of the IMU motion, its deviation from constant velocity
# over the sweep (setIMUTransformFor + transformToStartIMU, :150-169).  The
# constant-velocity part is what the odometry twist solves for.
# ---------------------------------------------------------------------------

GRAVITY = 9.81


@dataclasses.dataclass
class ImuHistory:
    """Integrated IMU state history (the reference's _imuHistory ring)."""

    stamp: torch.Tensor  # [M] seconds (sorted; invalid entries masked)
    rpy: torch.Tensor    # [M, 3] roll / pitch / yaw in the LOAM working frame
    pos: torch.Tensor    # [M, 3] integrated position
    vel: torch.Tensor    # [M, 3] integrated velocity
    mask: torch.Tensor   # [M]


def integrate_imu_history(stamp, acc_sensor, rpy, mask=None, device="cuda") -> ImuHistory:
    """Accumulate IMU position and velocity (handleIMUMessage, :89-120).

    ``acc_sensor`` is the raw accelerometer reading in sensor axis order
    (x, y, z); the reference remaps it to the LOAM frame and removes gravity
    with the IMU's own roll / pitch (:96-99), rotates it to the world with
    rotateZXY(roll, pitch, yaw) and integrates (:108-117).  The JAX package
    integrates with a sequential ``lax.scan``; here the same recurrences are
    two cumulative sums, vel_i = sum a_j d_j and pos_i = sum (vel_{j-1} d_j
    + a_j d_j^2 / 2), equal up to f32 rounding.
    """
    as_f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    stamp, acc_sensor, rpy = as_f32(stamp), as_f32(acc_sensor), as_f32(rpy)
    if mask is None:
        mask = torch.ones(stamp.shape, dtype=torch.bool, device=device)
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    roll, pitch, yaw = rpy[:, 0], rpy[:, 1], rpy[:, 2]
    # axis remap (y, z, x) and gravity removal in the tilted frame (:96-99)
    acc = torch.stack([
        acc_sensor[:, 1] - torch.sin(roll) * torch.cos(pitch) * GRAVITY,
        acc_sensor[:, 2] - torch.cos(roll) * torch.cos(pitch) * GRAVITY,
        acc_sensor[:, 0] + torch.sin(pitch) * GRAVITY,
    ], dim=-1)
    acc_w = se3.rotate_zxy(acc, roll, pitch, yaw)

    dt = torch.diff(stamp, prepend=stamp[:1])
    dt = torch.where(mask, dt, torch.zeros_like(dt))[:, None]
    vel = torch.cumsum(acc_w * dt, dim=0)
    vel_prev = torch.cat([torch.zeros_like(vel[:1]), vel[:-1]])
    pos = torch.cumsum(vel_prev * dt + 0.5 * acc_w * dt * dt, dim=0)
    return ImuHistory(stamp=stamp, rpy=rpy, pos=pos, vel=vel, mask=mask)


def _interp_state(hist: ImuHistory, t):
    """IMU state at times t [...] (interpolateIMUStateFor, :171-188)."""
    stamps = torch.where(hist.mask, hist.stamp, torch.full_like(hist.stamp, 1e30))
    last = torch.clamp(hist.mask.sum() - 1, min=0)
    # the first sample with stamp >= t (the reference's idx after its loop)
    idx = torch.searchsorted(stamps, t.contiguous(), right=False)
    idx = torch.minimum(idx, last)
    prev = torch.clamp(torch.minimum(idx - 1, last), min=0)

    t_hi, t_lo = hist.stamp[idx], hist.stamp[prev]
    # beyond the history (t > last stamp) or before it: the sample as it is
    out_of_range = (idx == 0) | (t > t_hi)
    denom = torch.where(t_hi > t_lo, t_hi - t_lo, torch.ones_like(t_hi))
    ratio = torch.where(out_of_range, torch.zeros_like(t), (t_hi - t) / denom)[..., None]

    def lerp(a):
        return a[idx] * (1.0 - ratio) + a[prev] * ratio

    rpy_hi, rpy_lo = hist.rpy[idx], hist.rpy[prev]
    # yaw wrap (IMUState::interpolate, ScanRegistration.h:157-165)
    yaw_hi, yaw_lo = rpy_hi[..., 2], rpy_lo[..., 2]
    yaw_lo = torch.where(yaw_hi - yaw_lo > np.pi, yaw_lo + 2 * np.pi, yaw_lo)
    yaw_lo = torch.where(yaw_hi - yaw_lo < -np.pi, yaw_lo - 2 * np.pi, yaw_lo)
    rpy_lo = torch.cat([rpy_lo[..., :2], yaw_lo[..., None]], dim=-1)
    rpy = rpy_hi * (1.0 - ratio) + rpy_lo * ratio
    return rpy, lerp(hist.pos), lerp(hist.vel)


def imu_dewarp(sweep: Sweep, hist: ImuHistory, scan_time: float, scan_period: float = 0.1,
               sweep_start: Optional[float] = None) -> Sweep:
    """Shift every point by the nonlinear IMU motion (transformToStartIMU).

    Each point captured at ``t = scan_time + rel_time * scan_period`` is
    rotated into the world IMU frame with its own interpolated attitude,
    shifted by ``pos(t) - pos(start) - vel(start) * relSweepTime``
    (setIMUTransformFor, :150-155), and rotated back into the sweep-start
    IMU frame (:158-169).  Returns a new Sweep in the start frame.
    """
    if sweep_start is None:
        sweep_start = scan_time
    dev = sweep.xyz.device
    t_start = torch.tensor([scan_time], dtype=torch.float32, device=dev)
    rpy_s, pos_s, vel_s = _interp_state(hist, t_start)
    roll_s, pitch_s, yaw_s = rpy_s[0, 0], rpy_s[0, 1], rpy_s[0, 2]

    t_p = scan_time + sweep.rel_time * scan_period                 # [R, W]
    rel_sweep = (scan_time - sweep_start) + sweep.rel_time * scan_period
    rpy_c, pos_c, _ = _interp_state(hist, t_p)
    shift = pos_c - pos_s[0] - vel_s[0] * rel_sweep[..., None]

    p_w = se3.rotate_zxy(sweep.xyz, rpy_c[..., 0], rpy_c[..., 1], rpy_c[..., 2])
    p_new = se3.rotate_yxz(p_w + shift, -yaw_s, -pitch_s, -roll_s)

    keep = hist.mask.any() & sweep.mask[..., None]
    return Sweep(xyz=torch.where(keep, p_new, sweep.xyz), mask=sweep.mask,
                 rel_time=sweep.rel_time)
