"""Feature-map persistence, the checkpoint system (port of
``cooper_mapper_tpu/io/map_io.py``).

``FeatureMap::saveCloudToFiles`` / ``loadCloudFromFiles``
(FeatureMap.h:378-462): one PCD per non-empty cube plus an ``index.txt``
manifest of ``(count, type, i, j, k, size)`` rows, where type 0 = corner,
1 = surf, (i, j, k) are *world* cube indices and size is the cube edge
length.  Also the ``indexConvert`` re-centring tool (indexConvert.cpp:21-33)
and g2o-text pose-graph checkpoints (solver_g2o.cpp:97-100).  The files are
the JAX package's, byte for byte where the numbers are.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..maps import feature_map as fm
from ..utils import cloud as cloud_lib
from ..utils import se3
from . import pcd

CORNER, SURF = 0, 1


def save_feature_map(state: fm.FeatureMapState, cfg: MapConfig, directory: str) -> int:
    """Dump the non-empty cubes.  Returns the number of cubes written.
    Per feature class, the non-empty cubes' slots come to the host in one
    copy."""
    os.makedirs(directory, exist_ok=True)
    rows = []
    written = 0
    # slot -> world cube index under the toroidal addressing
    slot_world = fm.slot_world_index(state.origin.cpu().numpy(), cfg.n_cubes)
    for type_id, cc in ((CORNER, state.corner), (SURF, state.surf)):
        filled = torch.nonzero(cc.count > 0)[:, 0]
        xyz = cc.xyz[filled].cpu().numpy()
        mask = cc.mask[filled].cpu().numpy()
        for k, flat in enumerate(filled.cpu().numpy()):
            wi, wj, wk = (int(v) for v in slot_world[int(flat)])
            pts = xyz[k][mask[k]]
            name = f"cube_{type_id}_{wi}_{wj}_{wk}.pcd"
            pcd.write_pcd(os.path.join(directory, name), pts)
            rows.append((len(pts), type_id, wi, wj, wk, cfg.cube_size))
            written += 1
    with open(os.path.join(directory, "index.txt"), "w") as f:
        for r in rows:
            f.write(" ".join(str(v) for v in r) + "\n")
    return written


def load_feature_map(directory: str, cfg: MapConfig, device="cuda") -> fm.FeatureMapState:
    """Rebuild a FeatureMapState on ``device`` from a cube directory
    (loadCloudFromFiles), inserting cube by cube.  Cubes outside the grid
    window, centred on the manifest's centroid, are dropped, as the
    reference's fixed grid does."""
    rows = []
    with open(os.path.join(directory, "index.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                rows.append((int(parts[0]), int(parts[1]), int(parts[2]), int(parts[3]),
                             int(parts[4]), float(parts[5])))
    state = fm.create(cfg, device)
    if not rows:
        return state
    # centre the grid on the occupied region
    centers = np.array([[r[2], r[3], r[4]] for r in rows])
    mid = np.round(centers.mean(0)).astype(np.int32)
    nx, ny, nz = cfg.n_cubes
    origin = torch.from_numpy((mid - np.array([nx // 2, ny // 2, nz // 2])).astype(np.int32))
    state = fm.FeatureMapState(state.corner, state.surf, origin.to(device))
    for count, type_id, wi, wj, wk, size in rows:
        xyz, _ = pcd.read_pcd(os.path.join(directory, f"cube_{type_id}_{wi}_{wj}_{wk}.pcd"))
        c = cloud_lib.from_points(xyz, device=device)
        empty = cloud_lib.empty(1, device)
        if type_id == CORNER:
            state = fm.add_feature_cloud(state, c, empty, cfg)
        else:
            state = fm.add_feature_cloud(state, empty, c, cfg)
    return state


def index_convert(src: str, dst: str, offset: Tuple[int, int, int]) -> None:
    """Re-centre a cube manifest by integer cube offsets (indexConvert.cpp)."""
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            p = line.split()
            if len(p) >= 6:
                p[2] = str(int(p[2]) + offset[0])
                p[3] = str(int(p[3]) + offset[1])
                p[4] = str(int(p[4]) + offset[2])
                g.write(" ".join(p) + "\n")


# ---------------------------------------------------------------------------
# g2o text checkpoints (solver_g2o.cpp:97-100; graph.cpp:113-115)
# ---------------------------------------------------------------------------


def _quat(T):
    """(w, x, y, z) of a pose's rotation, in f32 as the JAX package forms it."""
    R = torch.from_numpy(np.asarray(T, np.float32)[:3, :3].copy())
    return se3.rot_to_quat(R).numpy()


def _pose(t, q_xyzw):
    qx, qy, qz, qw = q_xyzw
    R = se3.quat_to_rot(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def save_g2o(path: str, poses: np.ndarray, edges) -> None:
    """poses: [N, 4, 4]; edges: iterable of (i, j, T_rel [4, 4], info_diag [6])."""
    with open(path, "w") as f:
        for idx, T in enumerate(poses):
            q = _quat(T)
            t = T[:3, 3]
            # g2o order: x y z qx qy qz qw
            f.write(f"VERTEX_SE3:QUAT {idx} {t[0]} {t[1]} {t[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]}\n")
        for i, j, T, info in edges:
            q = _quat(T)
            t = np.asarray(T)[:3, 3]
            # upper-triangular 6x6 information from the diagonal
            I = np.diag(np.asarray(info))
            upper = " ".join(str(I[a, b]) for a in range(6) for b in range(a, 6))
            f.write(f"EDGE_SE3:QUAT {int(i)} {int(j)} {t[0]} {t[1]} {t[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]} {upper}\n")


def load_g2o(path: str):
    """Returns (poses [N, 4, 4], edges [(i, j, T, info_diag)])."""
    poses = {}
    edges = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "VERTEX_SE3:QUAT":
                poses[int(p[1])] = _pose(np.array(p[2:5], np.float64),
                                         np.array(p[5:9], np.float64))
            elif p[0] == "EDGE_SE3:QUAT":
                T = _pose(np.array(p[3:6], np.float64), np.array(p[6:10], np.float64))
                upper = np.array(p[10:31], np.float64)
                I = np.zeros((6, 6))
                c = 0
                for a in range(6):
                    for b in range(a, 6):
                        I[a, b] = I[b, a] = upper[c]
                        c += 1
                edges.append((int(p[1]), int(p[2]), T, np.diag(I).astype(np.float32)))
    n = max(poses) + 1 if poses else 0
    arr = np.stack([poses[i] for i in range(n)]) if n else np.zeros((0, 4, 4))
    return arr, edges


def save_trajectory_pcd(path: str, poses: np.ndarray) -> None:
    """The trajectory as a cloud of positions with the index in intensity
    (generateGraphTrajectoryCloud, graph.h:60-93)."""
    poses = np.asarray(poses)
    pcd.write_pcd(path, poses[:, :3, 3], np.arange(len(poses), dtype=np.float32))
