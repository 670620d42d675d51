"""Device-resident cube-grid feature map
(port of ``cooper_mapper_tpu/maps/feature_map.py``; FeatureMap.h:52-691).

A 3D grid of fixed-capacity point cubes holding separate corner and surface
clouds, with world-to-cube indexing (worldToCube, FeatureMap.h:475-487),
toroidal recentring (slot = world cube index mod the grid dims: the window
origin moves and departing cubes are mask-cleared, no data moves;
update/shift, :232-254), the active-area surround gather
(getSurroundFeature, :256-352), scatter insertion (addFeatureCloud,
:219-230) and the voxel re-deduplication of the active cubes
(downsizeValidCloud, :289-306).

The JAX package's steps donate the map (``models/fused.py``) so XLA updates
it in place; here ``add_feature_cloud``, ``recenter`` and ``dedup_active`` write
the state's tensors in place (``index_put_``, ``masked_fill_``) and return the same
object.  At the default ``MapConfig`` the map holds 4851 cubes x
(4096 + 8192) slots, ~0.78 GB of xyz and masks on the card: a functional
copy per insert or recenter would double that.

Each ``CubeCloud`` keeps its slots as rows of one flat buffer with a guard
row at the end; points dropped by an insert (invalid, outside the window or
over a cube's capacity) are written to the guard row, so every scatter
index is in range and the only duplicate index is the guard's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import MapConfig
from ..ops.voxel import divide, filter_sorted
from ..utils import cloud as cloud_lib


@dataclasses.dataclass
class CubeCloud:
    """One feature class across all cubes.  ``rows`` [NC*cap + 1, 3] and
    ``row_mask`` [NC*cap + 1] are the slots plus the guard row; ``xyz``
    [NC, cap, 3] and ``mask`` [NC, cap] are views of the slots.  ``count``
    [NC] int32: valid points per cube, packed to the front."""

    rows: torch.Tensor
    row_mask: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return (self.rows.shape[0] - 1) // self.count.shape[0]

    @property
    def xyz(self):
        return self.rows[:-1].view(self.count.shape[0], self.capacity, 3)

    @property
    def mask(self):
        return self.row_mask[:-1].view(self.count.shape[0], self.capacity)

    @classmethod
    def from_dense(cls, xyz, mask, count) -> "CubeCloud":
        """From [NC, cap, 3] / [NC, cap] / [NC] tensors (copied)."""
        guard = lambda t, fill: torch.cat([t.reshape((-1,) + t.shape[2:]),
                                           torch.full((1,) + t.shape[2:], fill, dtype=t.dtype,
                                                      device=t.device)])
        return cls(guard(xyz, cloud_lib.FAR), guard(mask, False), count.clone())


@dataclasses.dataclass
class FeatureMapState:
    corner: CubeCloud
    surf: CubeCloud
    origin: torch.Tensor  # [3] int32: world cube index of grid slot (0, 0, 0)


def _empty_cube_cloud(nc: int, cap: int, device) -> CubeCloud:
    return CubeCloud(
        rows=torch.full((nc * cap + 1, 3), cloud_lib.FAR, dtype=torch.float32, device=device),
        row_mask=torch.zeros(nc * cap + 1, dtype=torch.bool, device=device),
        count=torch.zeros(nc, dtype=torch.int32, device=device),
    )


def create(cfg: MapConfig, device="cuda") -> FeatureMapState:
    nx, ny, nz = cfg.n_cubes
    nc = nx * ny * nz
    return FeatureMapState(
        corner=_empty_cube_cloud(nc, cfg.corner_cube_capacity, device),
        surf=_empty_cube_cloud(nc, cfg.surf_cube_capacity, device),
        # the grid centred on the world origin
        origin=-torch.tensor([nx // 2, ny // 2, nz // 2], dtype=torch.int32, device=device),
    )


def world_to_cube(xyz, cfg: MapConfig):
    """World coords -> int32 world-cube indices: cube i covers
    [(i - 0.5) * size, (i + 0.5) * size) (FeatureMap.h:475-487)."""
    return torch.floor(divide(xyz, cfg.cube_size) + 0.5).to(torch.int32)


def _grid_index(cube_idx, origin, cfg: MapConfig):
    """World cube index [.., 3] -> (flat grid slot, in-window mask).
    Toroidal: the slot is the world index mod the grid dims; out-of-window
    cubes get slot NC."""
    nx, ny, nz = cfg.n_cubes
    local = cube_idx - origin
    in_grid = ((local[..., 0] >= 0) & (local[..., 0] < nx)
               & (local[..., 1] >= 0) & (local[..., 1] < ny)
               & (local[..., 2] >= 0) & (local[..., 2] < nz))
    flat = ((torch.remainder(cube_idx[..., 0], nx) * ny + torch.remainder(cube_idx[..., 1], ny))
            * nz + torch.remainder(cube_idx[..., 2], nz))
    return torch.where(in_grid, flat, nx * ny * nz), in_grid


def slot_world_index(origin, n_cubes):
    """Per-slot world cube index [NC, 3] (numpy) under the window at
    ``origin``: the inverse of the toroidal slot map.  Slot coordinate s on
    an axis of length n holds the world index origin + ((s - origin) mod n),
    the one inside [origin, origin + n).  Host-side numpy (map_io names the
    cube files by world index)."""
    nx, ny, nz = (int(v) for v in n_cubes)
    s = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
                 axis=-1).reshape(-1, 3)
    o = np.asarray(origin).reshape(1, 3)
    return o + np.mod(s - o, np.array([nx, ny, nz]))


def _insert(cc: CubeCloud, xyz, mask, cube_flat, nc: int) -> CubeCloud:
    """Scatter points into their cubes behind the existing counts, in place.
    Within a cube, points keep their input order (a stable sort by cube);
    those past the cube's capacity are dropped."""
    cap = cc.capacity
    n = xyz.shape[0]
    key = torch.where(mask, cube_flat, nc)        # invalid -> overflow bucket
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    xyz_s = xyz[order]
    ok_s = key_s < nc

    new_seg = torch.ones(n, dtype=torch.bool, device=xyz.device)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    # rank within segment = index - index of the segment's start
    idx = torch.arange(n, device=xyz.device)
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), dim=0).values
    rank = idx - seg_start

    cube = key_s.clamp(0, nc - 1).long()
    slot = cc.count[cube] + rank
    keep = ok_s & (slot < cap)
    flat_pos = torch.where(keep, cube * cap + slot, nc * cap)   # nc * cap: the guard row
    cc.rows.index_put_((flat_pos,), xyz_s)
    cc.row_mask.index_put_((flat_pos,), keep)
    added = torch.zeros(nc + 1, dtype=torch.int32, device=xyz.device)
    added.index_add_(0, key_s.clamp(0, nc).long(), keep.to(torch.int32))
    cc.count += added[:nc]
    return cc


def add_feature_cloud(state: FeatureMapState, corner_world: cloud_lib.Cloud,
                      surf_world: cloud_lib.Cloud, cfg: MapConfig) -> FeatureMapState:
    """Insert registered (world-frame) feature clouds (addFeatureCloud).
    Updates ``state`` in place and returns it."""
    nx, ny, nz = cfg.n_cubes
    nc = nx * ny * nz
    for cc, c in ((state.corner, corner_world), (state.surf, surf_world)):
        flat, ok = _grid_index(world_to_cube(c.xyz, cfg), state.origin, cfg)
        _insert(cc, c.xyz, c.mask & ok, flat, nc)
    return state


def _clear_slots(cc: CubeCloud, keep) -> CubeCloud:
    """Mask-clear the cubes where ``keep`` [NC] is False, in place."""
    drop = ~keep
    cc.xyz.masked_fill_(drop[:, None, None], cloud_lib.FAR)
    cc.mask.masked_fill_(drop[:, None], False)
    cc.count.masked_fill_(drop, 0)
    return cc


def window_shift(origin, sensor_pos, cfg: MapConfig):
    """Cubes to move the window by so the sensor stays >= margin inside
    (the shift loop of FeatureMap::update, FeatureMap.h:232-254)."""
    dims = torch.tensor(cfg.n_cubes, dtype=torch.int32, device=origin.device)
    m = cfg.margin_cubes
    local = world_to_cube(sensor_pos, cfg) - origin
    lo = torch.clamp(local - m, max=0)              # how far below the margin
    hi = torch.clamp(local - (dims - 1 - m), min=0)  # how far above
    return lo + hi


def keep_mask_for_window(origin, new_origin, cfg: MapConfig):
    """Per-slot keep mask [NC]: True iff the slot's world cube under the old
    window also lies inside the new one.  Slots that leave are cleared and
    re-addressed by the entering world cubes (the same slots, mod the dims)."""
    nx, ny, nz = cfg.n_cubes

    def axis(n_ax, o, no):
        s = torch.arange(n_ax, dtype=torch.int32, device=origin.device)
        w = o + torch.remainder(s - o, n_ax)        # world index per slot coord
        return (w >= no) & (w < no + n_ax)

    kx = axis(nx, origin[0], new_origin[0])
    ky = axis(ny, origin[1], new_origin[1])
    kz = axis(nz, origin[2], new_origin[2])
    return (kx[:, None, None] & ky[None, :, None] & kz[None, None, :]).reshape(-1)


def recenter(state: FeatureMapState, sensor_pos, cfg: MapConfig) -> FeatureMapState:
    """Keep the sensor >= margin cubes inside the grid (update/shift).
    Toroidal: only the origin moves, departing cubes are cleared.  Updates
    ``state`` in place and returns it."""
    new_origin = state.origin + window_shift(state.origin, sensor_pos, cfg)
    keep = keep_mask_for_window(state.origin, new_origin, cfg)
    _clear_slots(state.corner, keep)
    _clear_slots(state.surf, keep)
    state.origin.copy_(new_origin)
    return state


@functools.lru_cache(maxsize=None)
def _surround_offsets(cfg: MapConfig):
    """Static neighbourhood of cube offsets gathered as the surround [A, 3]."""
    r = int(np.ceil(cfg.valid_distance / cfg.cube_size))
    nx, ny, nz = cfg.n_cubes
    rx, ry, rz = min(r, nx // 2), min(r, ny // 2), min(r, nz // 2)
    offs = [
        (dx, dy, dz)
        for dx in range(-rx, rx + 1)
        for dy in range(-ry, ry + 1)
        for dz in range(-rz, rz + 1)
        if (dx * dx + dz * dz) * cfg.cube_size**2 <= (cfg.valid_distance + cfg.cube_size) ** 2
    ]
    return np.array(offs, np.int32)


def _vfov_mask(offs, sensor_pos, cfg: MapConfig):
    """Vertical-FOV cube cull (InVerticalFov, DynamicFeatureMap.h:748-777):
    a cube is out when all 8 of its corners lie above +up or all below
    -down, in elevation seen from the sensor's position within its own cube
    (cube-index units).  The sensor's own cube is always kept (:795)."""
    center = world_to_cube(sensor_pos, cfg)
    frac = sensor_pos / cfg.cube_size - center.to(torch.float32)       # [3]
    d = torch.tensor([-0.5, 0.5], dtype=torch.float32, device=offs.device)
    corners = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), -1).reshape(8, 3)
    v = offs.to(torch.float32)[:, None, :] + corners[None] - frac      # [A, 8, 3]
    elev = torch.rad2deg(torch.arcsin(v[..., 1] / torch.linalg.vector_norm(v, dim=-1)))
    up_all = torch.all(elev >= cfg.vfov_up_deg, dim=-1)
    down_all = torch.all(elev <= -cfg.vfov_down_deg, dim=-1)
    own = torch.all(offs == 0, dim=-1)
    return own | ~(up_all | down_all)


def _active_cube_slots(state: FeatureMapState, sensor_pos, cfg: MapConfig):
    """(flat slot [A], active mask [A]) of the surround neighbourhood: the
    static offsets, the in-window check and the optional vertical-FOV cull
    (computeActiveAera, FeatureMap.h:308-352)."""
    offs = torch.from_numpy(_surround_offsets(cfg)).to(state.origin.device)
    center = world_to_cube(sensor_pos, cfg)
    flat, ok = _grid_index(center[None, :] + offs, state.origin, cfg)
    if cfg.vfov_up_deg > 0.0 or cfg.vfov_down_deg > 0.0:
        ok = ok & _vfov_mask(offs, sensor_pos, cfg)
    return flat, ok


def get_surround(state: FeatureMapState, sensor_pos, cfg: MapConfig):
    """The active cubes around the sensor as (corner, surf) Clouds of the
    surround capacities; out-of-window and culled cubes contribute nothing.
    Reads the map, writes nothing."""
    flat, ok = _active_cube_slots(state, sensor_pos, cfg)
    flat = torch.where(ok, flat, 0).long()         # every gather index in range

    def gather(cc: CubeCloud, capacity):
        xyz = cc.xyz[flat]                           # [A, cap, 3]
        mask = cc.mask[flat] & ok[:, None]
        c = cloud_lib.make(torch.where(mask[..., None], xyz, cloud_lib.FAR).reshape(-1, 3),
                           mask.reshape(-1))
        return cloud_lib.compact(c, capacity)

    return (gather(state.corner, cfg.surround_corner_capacity),
            gather(state.surf, cfg.surround_surf_capacity))


def _dedup_cubes(cc: CubeCloud, flat, ok, leaf: float, keep_first: bool, nc: int):
    """Voxel-filter the cubes ``flat`` [A] (where ``ok``) in one pass and
    write them back in place.  The cube's position in ``flat`` leads the sort
    keys, so each cube comes out as its own filter would give it; the
    cubes' rows are then compacted, valid points first, by one more stable
    sort.  Rows of cubes that are not ``ok`` all point at the guard row and
    carry invalid FAR points, so the duplicate writes there agree."""
    cap = cc.capacity
    A = flat.shape[0]
    dev = flat.device
    slot = torch.arange(cap, device=dev)
    rows = torch.where(ok[:, None], flat[:, None] * cap + slot, nc * cap).reshape(-1)
    cube = torch.arange(A, device=dev).repeat_interleave(cap)
    xyz = cc.rows[rows]
    mask = cc.row_mask[rows] & ok[cube]
    order, out_xyz, out_mask = filter_sorted(xyz, mask, leaf, keep_first, group=cube)
    # groups come out in ascending order, cap rows each: a stable sort by
    # (cube, invalid) packs each cube's points to the front of its own rows
    packed = torch.argsort(cube[order] * 2 + (~out_mask).to(torch.int64), stable=True)
    cc.rows.index_put_((rows,), out_xyz[packed])
    cc.row_mask.index_put_((rows,), out_mask[packed])
    cc.count.copy_(cc.mask.sum(-1, dtype=torch.int32))
    return cc


def dedup_active(state: FeatureMapState, sensor_pos, cfg: MapConfig) -> FeatureMapState:
    """Voxel re-deduplicate the cubes around the sensor (downsizeValidCloud,
    FeatureMap.h:289-306 / DynamicFeatureMap.h:718-735), in place.

    ``cfg.dedup_policy == "anchor"`` keeps each voxel's oldest point instead
    of its centroid: inserts append behind existing points, and both the
    voxel sort and the compaction are stable, so every pass keeps the first
    observation of each voxel.  "centroid" is the reference's
    pcl::VoxelGrid semantics.

    The JAX package maps the voxel filter over the active cubes; here every
    active cube of a feature class goes through one sort (``_dedup_cubes``),
    not a filter per cube.
    """
    nx, ny, nz = cfg.n_cubes
    nc = nx * ny * nz
    flat, ok = _active_cube_slots(state, sensor_pos, cfg)
    flat = torch.where(ok, flat, nc).long()
    keep_first = cfg.dedup_policy == "anchor"
    _dedup_cubes(state.corner, flat, ok, cfg.corner_leaf, keep_first, nc)
    _dedup_cubes(state.surf, flat, ok, cfg.surf_leaf, keep_first, nc)
    return state
