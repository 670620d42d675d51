"""Out-of-core cube map with host-side disk paging (port of
``cooper_mapper_tpu/maps/dynamic_map.py``).

Re-design of ``DynamicFeatureMap<PointT>`` (DynamicFeatureMap.h): a fixed
window of cubes on the device rides with the sensor; on cube crossings,
cubes leaving the window are flushed to per-cube PCD files and cubes
entering it are loaded from disk (setupPCDFileName / update, :129-161,
:504-677).  The reference's ``_indexMap`` indirection table becomes the
device grid of ``maps/feature_map`` plus a host ledger of which world cubes
are backed on disk (``index2.txt``).

The device window IS a ``FeatureMapState`` on ``device``: recentring,
insertion, the surround gather and the scan match reuse its code.  Paging
is an explicit host step (``page``) that the pipeline calls before each map
solve.  With the native engine (``io/native_pager``, built from
``native/cube_pager.cpp``) the flushes are write-behind on a C++ thread
pool and the entering cubes' reads overlap.

Card and host agree on the window by construction: the shift comes from
``feature_map.window_shift`` (the function ``recenter`` uses) and every
slot index from ``feature_map._grid_index`` / ``slot_world_index``, so the
cubes flushed are exactly the cubes ``recenter`` clears.  ``recenter``
clears them in place, so their points are copied to the host first, and
only theirs: the leaving slots are gathered on the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..io import native_pager, pcd
from ..utils import cloud as cloud_lib
from . import feature_map as fm

Key = Tuple[int, int, int]


@dataclasses.dataclass
class DynamicFeatureMap:
    cfg: MapConfig
    directory: str
    state: fm.FeatureMapState
    on_disk: Dict[Key, bool] = dataclasses.field(default_factory=dict)
    prev_center: Optional[np.ndarray] = None
    pager: Optional[native_pager.CubePager] = None
    # lifetime paging counters (the reference's destructor-report accounting)
    n_flushed: int = 0
    n_loaded: int = 0

    @classmethod
    def create(cls, cfg: MapConfig, directory: str, use_native_pager: Optional[bool] = None,
               device="cuda") -> "DynamicFeatureMap":
        """An empty window on ``device`` backed by ``directory`` (its
        ``index2.txt`` is read if present).  ``use_native_pager=None`` takes
        the native pager when ``COOPER_NATIVE_PAGER`` is "1" (the default)
        and the pager builds."""
        os.makedirs(directory, exist_ok=True)
        if use_native_pager is None:
            use_native_pager = (os.environ.get("COOPER_NATIVE_PAGER", "1") == "1"
                                and native_pager.CubePager.available())
        pager = native_pager.CubePager(directory) if use_native_pager else None
        dmap = cls(cfg=cfg, directory=directory, state=fm.create(cfg, device), pager=pager)
        dmap._load_manifest()
        return dmap

    @property
    def device(self) -> torch.device:
        return self.state.origin.device

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "index2.txt")

    def _load_manifest(self) -> None:
        path = self._manifest_path()
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                p = line.split()
                if len(p) >= 5:
                    self.on_disk[(int(p[2]), int(p[3]), int(p[4]))] = True

    def _save_manifest(self) -> None:
        with open(self._manifest_path(), "w") as f:
            for (i, j, k) in sorted(self.on_disk):
                f.write(f"0 0 {i} {j} {k} {self.cfg.cube_size}\n")

    def _cube_file(self, key: Key, type_id: int) -> str:
        return os.path.join(self.directory, f"cube_{type_id}_{key[0]}_{key[1]}_{key[2]}.pcd")

    # -- paging ------------------------------------------------------------

    def _position(self, sensor_pos) -> torch.Tensor:
        return torch.as_tensor(sensor_pos, dtype=torch.float32).to(self.device)

    def page(self, sensor_pos) -> None:
        """Flush the cubes leaving the window, recentre it, load the cubes
        entering it.  ``sensor_pos`` [3]: a tensor or an array.  Call before
        each map solve (the reference pages inside update(),
        DynamicFeatureMap.h:504-677); without a cube crossing it does
        nothing."""
        cfg = self.cfg
        pos = self._position(sensor_pos)
        center = fm.world_to_cube(pos, cfg).cpu().numpy()
        if self.prev_center is not None and np.all(center == self.prev_center):
            return
        self.prev_center = center

        shift = fm.window_shift(self.state.origin, pos, cfg).cpu().numpy()
        if not np.any(shift != 0):
            return
        # flush BEFORE recentring: recenter mask-clears the leaving slots in
        # place (and the entering world cubes reuse them at once)
        self._flush_keys(self._leaving_keys(shift))
        self.state = fm.recenter(self.state, pos, cfg)
        self._load_entering()

    def _occupied_keys(self) -> List[Tuple[Key, int, int]]:
        """All (world key, type_id, flat slot) with stored points, corners
        first, each class by ascending slot."""
        slot_world = fm.slot_world_index(self.state.origin.cpu().numpy(), self.cfg.n_cubes)
        counts = torch.stack([self.state.corner.count, self.state.surf.count]).cpu().numpy()
        return [(tuple(int(v) for v in slot_world[flat]), type_id, int(flat))
                for type_id in (0, 1) for flat in np.nonzero(counts[type_id] > 0)[0]]

    def _leaving_keys(self, shift: np.ndarray) -> List[Tuple[Key, int, int]]:
        """Occupied cubes whose slots roll out of the window under ``shift``."""
        dims = np.array(self.cfg.n_cubes, np.int64)
        origin = self.state.origin.cpu().numpy().astype(np.int64)
        leaving = []
        for key, type_id, flat in self._occupied_keys():
            local = np.array(key, np.int64) - origin - shift
            if np.any(local < 0) or np.any(local >= dims):
                leaving.append((key, type_id, flat))
        return leaving

    def _flush_keys(self, items: List[Tuple[Key, int, int]]) -> None:
        """Write the cubes ``items`` to disk: their slots are gathered on the
        device and only those come to the host."""
        if not items:
            return
        host = {}
        for type_id, cc in ((0, self.state.corner), (1, self.state.surf)):
            flats = [flat for _, t, flat in items if t == type_id]
            if flats:
                idx = torch.tensor(flats, dtype=torch.long, device=self.device)
                host[type_id] = (dict(zip(flats, range(len(flats)))),
                                 cc.xyz.index_select(0, idx).cpu().numpy(),
                                 cc.mask.index_select(0, idx).cpu().numpy())
        for key, type_id, flat in items:
            row_of, xyz, mask = host[type_id]
            row = row_of[flat]
            pts = xyz[row][mask[row]]
            if self.pager is not None:
                self.pager.flush(type_id, key, pts)  # write-behind
            else:
                pcd.write_pcd(self._cube_file(key, type_id), pts)
            self.on_disk[key] = True
            self.n_flushed += 1
        self._save_manifest()

    def _entering_keys(self) -> List[Key]:
        """Disk-backed cubes inside the (recentred) window whose slot is empty
        (never insert twice over resident points)."""
        keys = list(self.on_disk)
        if not keys:
            return []
        origin = self.state.origin.cpu()
        flat, inside = fm._grid_index(torch.tensor(keys, dtype=torch.int32), origin, self.cfg)
        nc = int(np.prod(self.cfg.n_cubes))
        counts = torch.stack([self.state.corner.count, self.state.surf.count]).cpu()
        occupied = (counts > 0).any(0)
        empty = inside & ~occupied[flat.clamp(max=nc - 1).long()]
        return [key for key, e in zip(keys, empty.tolist()) if e]

    def _load_entering(self) -> None:
        cfg = self.cfg
        keys = self._entering_keys()
        if not keys:
            return
        caps = {0: cfg.corner_cube_capacity, 1: cfg.surf_cube_capacity}
        if self.pager is not None:
            # barrier first: a cube may re-enter while its write-behind flush
            # is still queued; the reads must not race those writes
            self.pager.sync()
            # overlap all cube reads across the native thread pool
            tickets = [(key, t, self.pager.prefetch(t, key)) for key in keys for t in (0, 1)]
            loaded = {(key, t): self.pager.fetch(tk, caps[t]) for key, t, tk in tickets}
        else:
            loaded = {}
            for key in keys:
                for t in (0, 1):
                    path = self._cube_file(key, t)
                    loaded[(key, t)] = (pcd.read_pcd(path)[0][:caps[t]] if os.path.exists(path)
                                        else np.zeros((0, 3), np.float32))
        self._insert_loaded([loaded[(key, 0)] for key in keys],
                            [loaded[(key, 1)] for key in keys])
        self.n_loaded += len(keys)

    def _insert_loaded(self, corner_xyz: List[np.ndarray], surf_xyz: List[np.ndarray]) -> None:
        """Insert the loaded cubes' points (each already cut to its cube's
        capacity, as the JAX package's ``xyz[:cap]``) in one insert: each
        point goes to its own cube, in file order, as one insert per cube
        would put it."""
        def cloud(parts):
            pts = np.concatenate(parts).astype(np.float32, copy=False)
            return (cloud_lib.from_points(pts, device=self.device) if len(pts)
                    else cloud_lib.empty(1, self.device))

        self.state = fm.add_feature_cloud(self.state, cloud(corner_xyz), cloud(surf_xyz),
                                          self.cfg)

    # -- delegation --------------------------------------------------------

    def add_feature_cloud(self, corner_world, surf_world) -> None:
        self.state = fm.add_feature_cloud(self.state, corner_world, surf_world, self.cfg)

    def get_surround(self, sensor_pos):
        return fm.get_surround(self.state, self._position(sensor_pos), self.cfg)

    def save(self) -> None:
        """Flush every occupied cube and wait until the files are on disk."""
        self._flush_keys(self._occupied_keys())
        if self.pager is not None:
            self.pager.sync()  # write-behind barrier
