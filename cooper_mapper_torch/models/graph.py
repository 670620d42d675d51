"""Pose-graph backend: keyframes, loop closure, global optimization
(port of ``cooper_mapper_tpu/models/graph.py``; the ``Graph`` node family
of graph.{h,cpp}, keyframe.{h,cpp}, keyframe_updater.hpp and
loop_detector.hpp).

Distance / angle-gated keyframes, sequential SE3 edges with the
reference's hand-set information (graph.cpp:281-291), trajectory-radius loop
candidates with travelled-distance filtering (loop_detector.hpp:106-164),
coarse-to-fine loop matching (ICP, then ``scan_match_local``), loop edges
(information diagonal 2, graph.cpp:334-341), and LM optimization with the
odom -> graph correction kept afterwards (graph.cpp:368-373).

The control logic (gating, candidate selection over a handful of keyframe
positions) is host numpy, copied from the JAX package; the matching and the
LM solve run on ``device``.  Ingestion is buffered on the host and flushed
to the device in one ``pose_graph.from_arrays`` when the graph is needed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import KeyframeConfig, LoopConfig, PoseGraphConfig, ScanMatchConfig
from ..io import map_io
from ..maps import feature_map as fm
from ..ops import icp as icp_ops
from ..ops import pose_graph as pg
from ..ops import scan_match as sm
from ..utils import cloud as cloud_lib
from ..utils import se3, twist
from ..utils.cloud import Cloud


@dataclasses.dataclass
class Keyframe:
    """stamp + odometry pose + feature clouds (keyframe.h:12-45)."""

    stamp: float
    odom: np.ndarray           # [4, 4] odometry pose at creation
    corner: Cloud
    surf: Cloud
    accum_distance: float


@dataclasses.dataclass
class Loop:
    key_new: int
    key_old: int
    relative: np.ndarray       # [4, 4] pose of new in old's frame


class KeyframeUpdater:
    """Gating (keyframe_updater.hpp:12-48)."""

    def __init__(self, cfg: KeyframeConfig = KeyframeConfig()):
        self.cfg = cfg
        self.prev: Optional[np.ndarray] = None
        self.accum = 0.0

    def update(self, pose: np.ndarray) -> bool:
        if self.prev is None:
            self.prev = pose
            return True
        delta = np.linalg.inv(self.prev) @ pose
        dt = float(np.linalg.norm(delta[:3, 3]))
        da = float(np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1)))
        if dt > self.cfg.keyframe_delta_trans or da > self.cfg.keyframe_delta_angle:
            self.accum += dt
            self.prev = pose
            return True
        return False


class LoopDetector:
    """Candidate search + coarse / fine matching (loop_detector.hpp)."""

    def __init__(self, cfg: LoopConfig, sm_cfg: ScanMatchConfig):
        self.cfg = cfg
        self.sm_cfg = sm_cfg
        self.last_loop_distance = -1e9

    def find_candidates(self, keyframes: List[Keyframe], estimates: np.ndarray,
                        new_idx: int) -> List[int]:
        """Radius + travelled-distance gating (loop_detector.hpp:106-164).
        estimates: [K, 4, 4] current graph pose estimates."""
        cfg = self.cfg
        kf_new = keyframes[new_idx]
        if kf_new.accum_distance - self.last_loop_distance < cfg.min_loop_interval:
            return []
        pos_new = estimates[new_idx][:3, 3]
        cands = []
        for i in range(new_idx):
            kf = keyframes[i]
            if kf_new.accum_distance - kf.accum_distance < cfg.accum_distance_thresh:
                continue
            # plan-view (y-flattened) distance, loop_detector.hpp:92-104
            d = estimates[i][:3, 3] - pos_new
            d[1] = 0.0
            d_sq = float(d @ d)
            if d_sq > cfg.distance_thresh ** 2:
                continue
            # the reference compares the SQUARED plan-view distance against
            # estimated_distance_thresh (loop_detector.hpp:135-137)
            if d_sq >= cfg.estimated_distance_thresh:
                continue
            cands.append(i)
        if not cands:
            return []
        # cluster around the closest candidate by accumulated distance
        cands.sort(key=lambda i: np.linalg.norm(
            (estimates[i][:3, 3] - pos_new) * np.array([1.0, 0.0, 1.0])))
        anchor = cands[0]
        grouped = [i for i in cands
                   if abs(keyframes[i].accum_distance - keyframes[anchor].accum_distance)
                   < cfg.candidate_cluster_dist]
        return grouped[: cfg.max_candidates]

    def match(self, keyframes: List[Keyframe], estimates: np.ndarray, new_idx: int,
              candidates: List[int]) -> Optional[Loop]:
        """Stack the candidates' clouds in candidate[0]'s frame and match the
        new keyframe against them (matching_nearest, loop_detector.hpp:166-226):
        ICP on the surf clouds seeds the damped fine match."""
        anchor = candidates[0]
        T_anchor = estimates[anchor]
        kf_new = keyframes[new_idx]
        dev = kf_new.surf.xyz.device
        mat = lambda T: torch.from_numpy(np.asarray(T, np.float32)).to(dev)
        corner_parts, surf_parts = [], []
        for i in candidates:
            T_rel = mat(np.linalg.inv(T_anchor) @ estimates[i])
            corner_parts.append(_transform_cloud(keyframes[i].corner, T_rel))
            surf_parts.append(_transform_cloud(keyframes[i].surf, T_rel))
        ref_corner = _concat_all(corner_parts)
        ref_surf = _concat_all(surf_parts)

        T_guess = mat(np.linalg.inv(T_anchor) @ estimates[new_idx])
        # coarse point-to-point ICP (corseMatching, loop_detector.hpp:228-250)
        T_coarse, _, n_inlier = icp_ops.icp(kf_new.surf, ref_surf, T_guess,
                                            max_iterations=8, max_corr_dist=2.0)
        T_seed = torch.where(n_inlier > 50, T_coarse, T_guess)
        # Marquardt damping on the fine match (LoopConfig.fine_damping): the
        # stacked reference re-finds its 5-NN sets every iteration, and the
        # undamped GN can cycle between poses ~5 mm apart just above the
        # convergence gate
        sm_cfg = dataclasses.replace(self.sm_cfg, lm_damping=self.cfg.fine_damping)
        res = sm.scan_match_local(kf_new.corner, kf_new.surf, ref_corner, ref_surf,
                                  twist.from_mat(T_seed), sm_cfg)
        if not bool(res.success):
            return None
        self.last_loop_distance = kf_new.accum_distance
        rel = twist.to_mat(res.x).cpu().numpy()
        return Loop(key_new=new_idx, key_old=anchor, relative=rel)


def _transform_cloud(c: Cloud, T) -> Cloud:
    xyz = se3.apply(T, c.xyz)
    return Cloud(torch.where(c.mask[:, None], xyz, cloud_lib.FAR), c.mask, c.ring, c.rel_time)


def _concat_all(parts: List[Cloud]) -> Cloud:
    out = parts[0]
    for p in parts[1:]:
        out = cloud_lib.concat(out, p)
    return out


class GraphSlam:
    """The Graph node: ingest keyframes, close loops, optimize, on ``device``."""

    def __init__(self, kf_cfg: KeyframeConfig = KeyframeConfig(),
                 loop_cfg: LoopConfig = LoopConfig(),
                 pg_cfg: PoseGraphConfig = PoseGraphConfig(),
                 sm_cfg: ScanMatchConfig = ScanMatchConfig(), device="cuda"):
        self.kf_cfg = kf_cfg
        self.pg_cfg = pg_cfg
        self.device = torch.device(device)
        self.updater = KeyframeUpdater(kf_cfg)
        self.detector = LoopDetector(loop_cfg, sm_cfg)
        self.keyframes: List[Keyframe] = []
        # host buffers, flushed in one transfer when the graph is needed
        # (the reference queues keyframes too and flushes them into g2o once
        # per optimize cycle, graph.cpp:247-299)
        self._node_poses: List[np.ndarray] = []       # current estimates
        self._edges: List[tuple] = []                 # (i, j, T_rel, info)
        self._graph: Optional[pg.PoseGraph] = None
        self._dirty = True
        self.loops: List[Loop] = []
        self.accum = 0.0
        self._prev_pose: Optional[np.ndarray] = None
        self.T_odom2graph = np.eye(4, dtype=np.float32)

    @property
    def n_edges(self) -> int:
        return len(self._edges)

    @property
    def graph(self) -> pg.PoseGraph:
        """The device PoseGraph, flushed from the host buffers."""
        self._flush()
        return self._graph

    def _flush(self):
        if not self._dirty and self._graph is not None:
            return
        n = len(self._node_poses)
        poses = np.stack(self._node_poses) if n else np.zeros((0, 4, 4), np.float32)
        if self._edges:
            ei = np.array([e[0] for e in self._edges], np.int32)
            ej = np.array([e[1] for e in self._edges], np.int32)
            eT = np.stack([e[2] for e in self._edges]).astype(np.float32)
            einfo = np.stack([e[3] for e in self._edges]).astype(np.float32)
        else:
            ei = np.zeros((0,), np.int32)
            ej = np.zeros((0,), np.int32)
            eT = np.zeros((0, 4, 4), np.float32)
            einfo = np.zeros((0, 6), np.float32)
        self._graph = pg.from_arrays(poses, ei, ej, eT, einfo, max_nodes=self.pg_cfg.max_nodes,
                                     max_edges=self.pg_cfg.max_edges, device=self.device)
        self._dirty = False

    # -- ingestion ---------------------------------------------------------

    def add_frame(self, stamp: float, odom_pose: np.ndarray, corner: Cloud,
                  surf: Cloud) -> bool:
        """Keyframe-gated ingestion (graph.cpp:230-245).  Returns True when a
        keyframe was created.  Host bookkeeping only: nothing reaches the
        device until the next optimize."""
        if not self.updater.update(odom_pose):
            return False
        if self._prev_pose is not None:
            self.accum += float(np.linalg.norm(odom_pose[:3, 3] - self._prev_pose[:3, 3]))
        self._prev_pose = odom_pose
        idx = len(self.keyframes)
        if idx >= self.pg_cfg.max_nodes:
            return False
        self.keyframes.append(Keyframe(stamp, np.asarray(odom_pose), corner, surf, self.accum))
        self._node_poses.append((self.T_odom2graph @ np.asarray(odom_pose)).astype(np.float32))
        if idx > 0:
            T_rel = np.linalg.inv(self.keyframes[idx - 1].odom) @ np.asarray(odom_pose)
            info = np.array(list(self.pg_cfg.seq_info_trans) + list(self.pg_cfg.seq_info_rot),
                            np.float32)
            if len(self._edges) < self.pg_cfg.max_edges:
                self._edges.append((idx - 1, idx, T_rel.astype(np.float32), info))
        self._dirty = True
        return True

    # -- optimization cycle ------------------------------------------------

    def detect_and_optimize(self) -> Optional[Loop]:
        """One optimize-thread cycle (graph.cpp:314-378): look for a loop at
        the newest keyframe; when one is found, add its edge and run LM."""
        if len(self.keyframes) < 2:
            return None
        estimates = self.estimates()
        new_idx = len(self.keyframes) - 1
        cands = self.detector.find_candidates(self.keyframes, estimates, new_idx)
        if not cands:
            return None
        loop = self.detector.match(self.keyframes, estimates, new_idx, cands)
        if loop is None or self.n_edges >= self.pg_cfg.max_edges:
            return None
        info = np.full(6, self.pg_cfg.loop_info, np.float32)
        self._edges.append((loop.key_old, loop.key_new, np.asarray(loop.relative, np.float32),
                            info))
        self._dirty = True
        self.loops.append(loop)
        self.optimize()
        return loop

    def optimize(self):
        """LM over the graph, then the host mirror and the odom -> graph
        correction from the newest keyframe (graph.cpp:368-373), read back
        in one copy."""
        self._flush()
        self._graph, diag = pg.optimize(self._graph, self.pg_cfg)
        n = len(self.keyframes)
        if n:
            est = self._graph.poses[:n].cpu().numpy()
            self._node_poses = [p for p in est]
            self.T_odom2graph = (est[n - 1] @ np.linalg.inv(self.keyframes[n - 1].odom)
                                 ).astype(np.float32)
        return diag

    def estimates(self) -> np.ndarray:
        """Current graph pose estimates [K, 4, 4]: the host mirror, synced
        from the device after every optimize."""
        if not self._node_poses:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self._node_poses)

    # -- persistence (the /saveGraph service, graph.cpp:106-199) -----------

    def edges_list(self):
        return [(int(i), int(j), np.asarray(T), np.asarray(info)) for i, j, T, info in self._edges]

    def save(self, directory: str, map_cfg=None, rebuild_sm_cfg=None):
        """Dump .g2o before and after an optimize, the trajectory clouds and,
        with ``map_cfg``, a feature map rebuilt from the optimized keyframes
        (graph.cpp:106-199)."""
        os.makedirs(directory, exist_ok=True)
        n = len(self.keyframes)
        edges = self.edges_list()
        map_io.save_g2o(os.path.join(directory, "before.g2o"), self.estimates(), edges)
        diag = self.optimize()
        est = self.estimates()
        map_io.save_g2o(os.path.join(directory, "after.g2o"), est, edges)
        map_io.save_trajectory_pcd(os.path.join(directory, "graph_traj.pcd"), est)
        map_io.save_trajectory_pcd(
            os.path.join(directory, "odom_traj.pcd"),
            np.stack([kf.odom for kf in self.keyframes]) if n else np.zeros((0, 4, 4)))
        if map_cfg is not None:
            state = self.rebuild_map(map_cfg, rebuild_sm_cfg)
            map_io.save_feature_map(state, map_cfg, os.path.join(directory, "map"))
        return diag

    def rebuild_map(self, map_cfg, sm_cfg=None):
        """A FeatureMap rebuilt from the optimized keyframes; with ``sm_cfg``
        each keyframe is first re-registered against the growing map
        (getFinalFeatureMap, graph.cpp:149-199)."""
        state = fm.create(map_cfg, self.device)
        est = self.estimates()
        for i, kf in enumerate(self.keyframes):
            pose = torch.from_numpy(np.asarray(est[i], np.float32)).to(self.device)
            if sm_cfg is not None and i > 0:
                ref_c, ref_s = fm.get_surround(state, pose[:3, 3], map_cfg)
                res = sm.scan_match(kf.corner, kf.surf, ref_c, ref_s, twist.from_mat(pose),
                                    sm_cfg)
                pose = torch.where(res.success, twist.to_mat(res.x), pose)
            state = fm.add_feature_cloud(state, _transform_cloud(kf.corner, pose),
                                         _transform_cloud(kf.surf, pose), map_cfg)
        return state
