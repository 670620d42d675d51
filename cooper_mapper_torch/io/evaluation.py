"""Trajectory evaluation — ATE / online error monitor (a copy of
``cooper_mapper_tpu/io/evaluation.py``, which is numpy only; the port
imports nothing of the JAX package).

Replaces the reference's ``Evaluation`` node
(map_evaluation/Evaluation.cpp:27-148), which
matches each SLAM pose to the nearest-time GNSS pose and accumulates
mean/variance/max of the position error (dropping >10 m outliers as
"not initialized").  Adds the standard offline metrics: ATE (with optional
SE(3) alignment) and RPE.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ErrorStats:
    mean: float
    std: float
    maximum: float
    rmse: float
    per_axis_mean: np.ndarray
    n: int


def _stats(errs: np.ndarray, per_axis: np.ndarray) -> ErrorStats:
    if len(errs) == 0:
        return ErrorStats(np.nan, np.nan, np.nan, np.nan, np.full(3, np.nan), 0)
    return ErrorStats(
        mean=float(np.mean(errs)),
        std=float(np.std(errs)),
        maximum=float(np.max(errs)),
        rmse=float(np.sqrt(np.mean(errs**2))),
        per_axis_mean=np.mean(np.abs(per_axis), axis=0),
        n=len(errs),
    )


def online_error(est_pos, gt_pos, est_stamp=None, gt_stamp=None,
                 outlier_threshold=10.0) -> ErrorStats:
    """The Evaluation-node metric: nearest-time matching + outlier drop
    (Evaluation.cpp:53-78,133-146).

    Each estimate is paired with the GNSS sample of minimum |Δt| — the
    reference walks its GPS ring buffer backwards keeping the closest stamp
    (Evaluation.cpp:44-51).  Without stamps the arrays are paired index-wise
    (both truncated to the shorter length).
    """
    est_pos = np.asarray(est_pos)
    gt_pos = np.asarray(gt_pos)
    if est_stamp is not None and gt_stamp is not None:
        gt_t = np.asarray(gt_stamp)
        est_t = np.asarray(est_stamp)
        right = np.clip(np.searchsorted(gt_t, est_t), 0, len(gt_pos) - 1)
        left = np.clip(right - 1, 0, len(gt_pos) - 1)
        take_left = np.abs(gt_t[left] - est_t) <= np.abs(gt_t[right] - est_t)
        idx = np.where(take_left, left, right)
        gt_matched = gt_pos[idx]
    else:
        n = min(len(est_pos), len(gt_pos))
        est_pos, gt_matched = est_pos[:n], gt_pos[:n]
    diff = est_pos - gt_matched
    err = np.linalg.norm(diff, axis=-1)
    keep = err < outlier_threshold
    return _stats(err[keep], diff[keep])


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale=False):
    """Least-squares SE(3) (optionally Sim(3)) alignment est -> gt."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (E**2).sum() / len(est)
        s = np.trace(np.diag(D) @ S) / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate(est_pos, gt_pos, align=False) -> ErrorStats:
    """Absolute trajectory error over position, optional SE(3) alignment."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    diff = est - gt
    return _stats(np.linalg.norm(diff, axis=-1), diff)


def pipeline_ate(trajectory, gt_poses, align=True) -> ErrorStats:
    """ATE for a SlamPipeline trajectory against ground-truth sweep poses.

    Encodes the pipeline's pose convention so callers can't mis-index:
    ``trajectory[i]`` (a [4,4] merged pose) is the pose at the END of sweep
    i — features are end-projected (transformToEnd, LaserOdometry.cpp:156)
    and the odometry accumulates end-to-end motions — so it corresponds to
    ``gt_poses[i+1]``, expressed relative to ``gt_poses[0]``.

    ``align=True`` (default) removes the SE(3) map-frame gauge: the motion
    during sweep 0 is unobservable (the first sweep only initializes), so
    every SLAM trajectory carries a constant map-frame offset that absolute
    comparison would count at every pose.  Comparing end poses to START
    ground truth without alignment overstated the figure-eight mapping ATE
    0.066 -> 0.76 m in round 2 ("mapping amplifies odometry" was this
    artifact).
    """
    est = np.asarray(trajectory, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = min(len(est), len(gt) - 1)
    gt_end = np.stack([np.linalg.inv(gt[0]) @ g for g in gt[1:n + 1]])
    return ate(est[:n, :3, 3], gt_end[:, :3, 3], align=align)


def rpe(est_poses, gt_poses, delta: int = 1) -> ErrorStats:
    """Relative pose error over [N,4,4] pose arrays."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = min(len(est), len(gt)) - delta
    errs = []
    per_axis = []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        errs.append(np.linalg.norm(e[:3, 3]))
        per_axis.append(e[:3, 3])
    return _stats(np.asarray(errs), np.asarray(per_axis))
