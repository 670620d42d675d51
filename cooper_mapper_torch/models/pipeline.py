"""The full SLAM pipeline driver (port of ``cooper_mapper_tpu/models/pipeline.py``).

Scan registration -> laser odometry (every sweep) -> laser mapping (every
Nth sweep) -> the merged high-rate pose, with the cube map re-deduplicated
in the loop and optional IMU de-warp and UKF fusion: the reference's
launch-file topology (lidar_mapping.launch:13-44) as one program.

The host loop sequences eager PyTorch steps on ``device`` and keeps the
Python-side flags (initialization, stride counting).  Per sweep it reads
back what the JAX package reads: the poses, the mapping gate and its score.
The map and the filter stay on the device, and their gates are
``torch.where`` selects.

With ``cfg.enable_graph`` the pose-graph backend (``models/graph``) rides
the mapping output: accepted solves feed the keyframe gate, each new
keyframe looks for a loop, and a closed loop runs the LM optimization; every
result then carries the graph-corrected pose.

With ``cfg.matcher.dynamic_mode`` in "mapping" mode the cube map is
out of core (``maps/dynamic_map``): before each map solve a "paging" stage
flushes the cubes that leave the device window to
``cfg.matcher.map_directory`` and loads those that enter it, and the solve
then runs without recentring; ``save_map()`` writes the whole map there.
In the other modes ``dynamic_mode`` changes nothing, as in the JAX package.

With ``map_mesh`` (a ``parallel/mesh.Mesh``) the cube map is striped over
the mesh's ranks (``maps/sharded_map``): every rank runs the same sweeps,
holds its stripe of the map, and gathers the surround from all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..fusion import imu_queue, ukf_estimator
from ..maps import dynamic_map
from ..maps import feature_map as fm
from ..maps import local_map as lm
from ..maps import sharded_map as smap
from ..ops import features as feat_ops
from ..ops.features import Sweep
from ..utils import profiling
from . import graph as graph_mod
from . import laser_mapping, laser_odometry, scan_registration, transform_maintenance

MODES = ("mapping", "local", "localization")


def _host(t) -> np.ndarray:
    """A tensor as a numpy array of its own (never a view of the tensor)."""
    return t.detach().cpu().numpy().copy()


@dataclasses.dataclass
class SweepResult:
    odom_pose: np.ndarray       # odometry-only pose (laser_odom_to_init)
    merged_pose: np.ndarray     # mapping-corrected high-rate pose (/lidar_to_map2)
    mapped_pose: Optional[np.ndarray]  # pose after a mapping solve, if one ran
    mapping_success: Optional[bool]
    odom_matched: int
    # graph-corrected pose (/aft_graph_to_init): T_odom2graph applied to the
    # merged pose (graph.cpp:368-378); None when the graph is disabled
    graph_pose: Optional[np.ndarray] = None
    new_keyframe: bool = False
    loop_closed: bool = False


class SlamPipeline:
    """mode: "mapping" (cube-grid map), "local" (sliding window),
    "localization" (a fixed pre-built ``map_state``, never written).
    Everything is created on ``device``; the CPU runs the kernels' plain
    versions.

    ``map_mesh``: stripe the cube map over the mesh's ranks, each rank
    running this pipeline on the same sweeps; everything then lives on
    ``map_mesh.device``.  Mapping mode only, and not with
    ``matcher.dynamic_mode`` (disk paging is a single-array host path)."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), mode: str = "mapping",
                 map_state: Optional[fm.FeatureMapState] = None,
                 initial_pose: Optional[np.ndarray] = None, map_mesh=None, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if map_mesh is not None:
            if mode != "mapping":
                raise ValueError("map_mesh requires mode='mapping'")
            if cfg.matcher.dynamic_mode:
                raise ValueError("map_mesh is incompatible with matcher.dynamic_mode")
            device = map_mesh.device
        self.cfg = cfg
        self.mode = mode
        self.map_mesh = map_mesh
        self.device = torch.device(device)
        r = cfg.registration
        self.odo = laser_odometry.create(r.max_less_sharp, r.max_less_flat, device)
        self.matcher = laser_mapping.create_matcher(device)
        # the out-of-core map (the pipeline's dynamicMode switch,
        # LaserMatcher.cpp:107-118): the window is a FeatureMapState, the
        # DynamicFeatureMap adds the host paging ledger; every map step
        # updates the state in place, so map_state stays dmap.state
        self.dynamic = mode == "mapping" and cfg.matcher.dynamic_mode
        self.dmap = None
        if self.dynamic:
            self.dmap = dynamic_map.DynamicFeatureMap.create(
                cfg.feature_map, cfg.matcher.map_directory, device=device)
            self.map_state = self.dmap.state
        elif map_mesh is not None:
            self.map_state = (smap.from_single(map_state, cfg.feature_map, map_mesh)
                              if map_state is not None
                              else smap.create_sharded(cfg.feature_map, map_mesh))
        elif mode in ("mapping", "localization"):
            self.map_state = (map_state if map_state is not None
                              else fm.create(cfg.feature_map, device))
        else:
            self.map_state = lm.create(64, cfg.matcher.max_frame_corner,
                                       cfg.matcher.max_frame_surf, device)
        # the pose-graph backend riding the mapping output (graph.cpp:301-378)
        self.graph = (graph_mod.GraphSlam(cfg.keyframe, cfg.loop, cfg.pose_graph,
                                          cfg.scan_match, device)
                      if cfg.enable_graph else None)
        self.graph_trajectory: list[np.ndarray] = []
        self._mapping_count = 0
        # the reference's destructor counters (ScanMatch.cpp:35-49), kept
        # live and reported by stats()
        self._match_count = 0
        self._fail_match_count = 0
        self._total_score = 0.0
        if initial_pose is not None:
            T0 = torch.as_tensor(np.asarray(initial_pose, np.float32), device=device)
            self.matcher = laser_mapping.MatcherState(
                L_last=torch.eye(4, dtype=torch.float32, device=device), W_last=T0)
        self._initialized = False
        self._sweep_idx = 0
        self.trajectory: list[np.ndarray] = []       # merged poses per sweep
        self.odom_trajectory: list[np.ndarray] = []
        # IMU / UKF fusion (the IMUQueue of every LaserMatcher,
        # LaserMatcher.cpp:47; LaserLocalization.cpp:140-166)
        self.ukf = ukf_estimator.create(cfg.ukf, device=device)
        self.T_li = torch.eye(4, dtype=torch.float32, device=device)   # lidar -> imu
        self._last_stamp: Optional[float] = None
        self._last_fused_pos: Optional[np.ndarray] = None
        # per-stage wall clock (a span per stage with tracing on); timer.report() prints it
        self.timer = profiling.StageTimer()

    def _f32(self, v):
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def process(self, sweep: Sweep, imu: Optional[imu_queue.ImuBatch] = None,
                stamp: Optional[float] = None,
                imu_history: Optional[scan_registration.ImuHistory] = None) -> SweepResult:
        """Process one sweep; optionally fuse an IMU window ending at ``stamp``.

        With IMU data the UKF replays the window's predicts and is corrected
        by the mapping result (LaserLocalization::transformUpdate); the fused
        pose is read by ``fused_pose()`` / ``imu_rate_poses()``.
        ``imu_history`` also de-warps the sweep by the nonlinear IMU motion
        before feature extraction (ScanRegistration::transformToStartIMU).
        """
        cfg = self.cfg
        dev = self.device
        with self.timer.stage("registration", sync=dev):
            if imu_history is not None and stamp is not None:
                sweep = scan_registration.imu_dewarp(sweep, imu_history, stamp,
                                                     cfg.registration.scan_period)
            fc = feat_ops.extract_features(sweep, cfg.registration)

        if not self._initialized:
            self.odo = laser_odometry.init_step(self.odo, fc, cfg.odometry)
            self._initialized = True
            self._sweep_idx += 1
            eye = np.eye(4, dtype=np.float32)
            merged = _host(self.matcher.W_last)
            self.trajectory.append(merged)
            self.odom_trajectory.append(eye)
            return SweepResult(eye, merged, None, None, 0)

        with self.timer.stage("odometry", sync=dev):
            self.odo, odo_out = laser_odometry.step(self.odo, fc, cfg.odometry)
        L_now = odo_out.T_sum

        mapped_pose = None
        mapping_success = None
        mo = None
        if (self._sweep_idx % max(cfg.mapping_stride, 1)) == 0 or self._sweep_idx <= 2:
            with self.timer.stage(f"mapping[{self.mode}]", sync=dev):
                args = (odo_out.corner_for_map, odo_out.surf_for_map, L_now, cfg.scan_match,
                        cfg.matcher)
                if self.mode == "mapping" and self.map_mesh is not None:
                    self.matcher, self.map_state, mo = smap.mapping_step(
                        self.matcher, self.map_state, *args, cfg.feature_map, self.map_mesh)
                elif self.mode == "mapping":
                    if self.dynamic:
                        # page BEFORE the solve, at the solve's own guess:
                        # flush the leaving cubes, recentre, load the
                        # entering ones (update(), DynamicFeatureMap.h:504-677)
                        with self.timer.stage("paging", sync=dev):
                            T_guess = laser_mapping.merged_pose(self.matcher, L_now)
                            self.dmap.page(T_guess[:3, 3])
                            self.map_state = self.dmap.state
                    self.matcher, self.map_state, mo = laser_mapping.mapping_step(
                        self.matcher, self.map_state, *args, cfg.feature_map,
                        recenter=not self.dynamic)
                elif self.mode == "local":
                    self.matcher, self.map_state, mo = laser_mapping.mapping_local_step(
                        self.matcher, self.map_state, *args)
                else:
                    self.matcher, mo = laser_mapping.localization_step(
                        self.matcher, self.map_state, *args, cfg.feature_map)
            mapped_pose = _host(mo.W)
            mapping_success = bool(mo.result.success)
            self._mapping_count += 1
            if mapping_success:
                self._match_count += 1
                self._total_score += float(mo.result.score)
            else:
                self._fail_match_count += 1
            # in-loop map hygiene: re-voxelize the active cubes so long runs
            # never fill the cubes (downsizeValidCloud runs every mapping
            # pass in the reference, FeatureMap.h:289-306; the stride spreads
            # the cost)
            ds = cfg.matcher.dedup_stride
            if self.mode == "mapping" and ds > 0 and self._mapping_count % ds == 0:
                with self.timer.stage("dedup", sync=dev):
                    if self.map_mesh is not None:
                        self.map_state = smap.dedup_active(self.map_state, mo.W[:3, 3],
                                                           cfg.feature_map, self.map_mesh)
                    else:
                        self.map_state = fm.dedup_active(self.map_state, mo.W[:3, 3],
                                                         cfg.feature_map)

        merged = _host(laser_mapping.merged_pose(self.matcher, L_now))

        # the pose-graph backend (the Graph node, graph.cpp:301-378)
        graph_pose = None
        new_keyframe = False
        loop_closed = False
        if self.graph is not None:
            if mo is not None and (mapping_success or len(self.graph.keyframes) == 0):
                with self.timer.stage("graph", sync=dev):
                    kf_stamp = (stamp if stamp is not None
                                else self._sweep_idx * cfg.registration.scan_period)
                    new_keyframe = self.graph.add_frame(kf_stamp, mapped_pose, mo.corner_ds,
                                                        mo.surf_ds)
                    if new_keyframe:
                        loop_closed = self.graph.detect_and_optimize() is not None
            graph_pose = (self.graph.T_odom2graph @ merged).astype(np.float32)
            self.graph_trajectory.append(graph_pose)

        # UKF fusion: replay the IMU predicts, correct with the solve
        if imu is not None and stamp is not None:
            with self.timer.stage("ukf", sync=dev):
                if self._last_stamp is None:
                    # filter birth: anchors the predict cool-down window
                    self.ukf = dataclasses.replace(self.ukf, init_stamp=self._f32(stamp))
                t_from = self._last_stamp if self._last_stamp is not None else stamp - 0.1
                self.ukf = imu_queue.replay_predict(self.ukf, imu, self._f32(t_from),
                                                    self._f32(stamp), cfg.ukf)
                dt = max(stamp - t_from, 1e-3)
                pos = merged[:3, 3]
                vel = ((pos - self._last_fused_pos) / dt if self._last_fused_pos is not None
                       else np.zeros(3))
                # correct only after a map solve ran (the reference's correct
                # is downstream of optimizeTransform, LaserLocalization.cpp:
                # 140-166), and in mapping / local modes only from an
                # accepted one
                solve_ran = mapping_success is not None
                if solve_ran and (mapping_success or self.mode == "localization"):
                    self.ukf = imu_queue.correct_from_lidar(
                        self.ukf, self._f32(merged), self._f32(np.asarray(vel, np.float32)),
                        self.T_li, cfg.ukf)
                self._last_fused_pos = pos
                self._last_stamp = stamp

        self._sweep_idx += 1
        odom = _host(L_now)
        self.trajectory.append(merged)
        self.odom_trajectory.append(odom)
        return SweepResult(odom_pose=odom, merged_pose=merged, mapped_pose=mapped_pose,
                           mapping_success=mapping_success,
                           odom_matched=int(odo_out.n_matched), graph_pose=graph_pose,
                           new_keyframe=new_keyframe, loop_closed=loop_closed)

    def corrected_trajectory(self) -> np.ndarray:
        """The graph-corrected trajectory so far: every merged pose re-read
        through the current odom -> graph correction (what the reference's
        /aft_graph_to_init converges to after its last optimize); without
        the graph, the merged poses as they were reported."""
        if self.graph is None:
            return np.stack(self.trajectory)
        T = self.graph.T_odom2graph
        return np.stack([T @ p for p in self.trajectory]).astype(np.float32)

    def save_map(self) -> None:
        """Flush the out-of-core map to disk and wait for the files (dynamic
        mode only; otherwise nothing to do)."""
        if self.dynamic:
            self.dmap.save()

    def stats(self) -> dict:
        """Frame and solve accounting: the reference's destructor printouts
        (ScanMatch.cpp:35-49, MultiScanRegistration.cpp:14-16) as a dict,
        with the keyframe and loop counts when the graph is on."""
        out = {
            "frames": self._sweep_idx,
            "mapping_solves": self._mapping_count,
            "match_count": self._match_count,
            "fail_match_count": self._fail_match_count,
            "average_score": (self._total_score / self._match_count
                              if self._match_count else 0.0),
        }
        if self.graph is not None:
            out["keyframes"] = len(self.graph.keyframes)
            out["loop_closures"] = len(self.graph.loops)
        return out

    def single_map_state(self) -> fm.FeatureMapState:
        """The map as one FeatureMapState (the form a map file holds).  With
        ``map_mesh`` the stripes are gathered (``sharded_map.to_single``), a
        collective that every rank calls."""
        if self.map_mesh is not None:
            return smap.to_single(self.map_state, self.cfg.feature_map, self.map_mesh)
        return self.map_state

    # ---- fusion outputs ---------------------------------------------------

    def fused_pose(self) -> np.ndarray:
        """Current UKF pose in the lidar frame."""
        return _host(imu_queue.lidar_pose(self.ukf, self.T_li))

    def imu_rate_poses(self, imu: imu_queue.ImuBatch):
        """High-rate dead-reckoned pose trail from the latest merged pose
        (the TransformMaintenance counterpart).  Returns (poses [M, 4, 4],
        valid [M]) as numpy arrays."""
        anchor = self._f32(self.trajectory[-1])
        vel = ukf_estimator.velocity(self.ukf)
        stamp = self._f32(self._last_stamp if self._last_stamp is not None else 0.0)
        poses, valid = transform_maintenance.imu_rate_poses(anchor, stamp, vel, imu, self.T_li)
        return _host(poses), _host(valid)
