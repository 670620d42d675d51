"""The striped cube map over a mesh of ranks (port of ``cooper_mapper_tpu/maps/sharded_map.py``).

The cube arrays dominate the map's memory, so the flat cube axis is split
over the mesh and the map's capacity grows with the number of cards.  The
cube map's toroidal slot addressing never moves a slot, so a cube's owner is
fixed for the map's lifetime:

* **Striped ownership.**  Flat slot ``s`` lives on rank ``s % ndev`` at
  local position ``s // ndev``; each rank holds only its stripe, a
  ``feature_map.CubeCloud`` of ``nc_pad / ndev`` cubes with its own guard
  row (``nc_pad``: the cube count rounded up to a multiple of ``ndev``).
  The grid's innermost axis (z) strides the stripe, so a surround's cubes
  spread nearly evenly over the ranks.
* **Insert: no communication.**  Every rank gets the whole registered frame
  and scatters the points whose cubes it owns (``feature_map._insert`` on
  its stripe).
* **Surround: one all-gather.**  Each rank compacts the active cubes it owns
  to ``ceil(capacity / ndev)`` points; one all-gather gives every rank the
  surround cloud of ``ndev * ceil(capacity / ndev)`` points.
* **Recenter and dedup: local.**  The window's keep mask and the per-cube
  voxel filter touch only a rank's own cubes.

Every operation writes the stripe in place and returns the state, as
``maps/feature_map`` does.  On a mesh of one rank the stripe is the whole
map in the single-device layout, and every operation is the single-device
one (the JAX package's bypass).

One deviation: ``to_single`` takes the mesh where the JAX package takes the
number of devices, and is collective, because no process holds the whole
map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MapConfig
from ..parallel import mesh as mesh_lib
from ..utils import cloud as cloud_lib
from ..utils.cloud import Cloud
from . import feature_map as fm


@dataclasses.dataclass
class ShardedMapState:
    """This rank's stripe of the map: ``corner`` / ``surf`` hold the slots
    ``s`` with ``s % ndev == rank`` (local cube ``p`` is slot ``p * ndev +
    rank``); ``origin`` [3] int32 is the same on every rank."""

    corner: fm.CubeCloud
    surf: fm.CubeCloud
    origin: torch.Tensor


def _nc(cfg: MapConfig) -> int:
    nx, ny, nz = cfg.n_cubes
    return nx * ny * nz


def _padded_nc(cfg: MapConfig, ndev: int) -> int:
    return -(-_nc(cfg) // ndev) * ndev


def _stripe_perm(nc_pad: int, ndev: int):
    """Storage index k -> flat slot s of the gathered stripes
    (k = d * S + p  <->  s = p * ndev + d, S = nc_pad / ndev)."""
    k = np.arange(nc_pad)
    return (k % (nc_pad // ndev)) * ndev + k // (nc_pad // ndev)


def create_sharded(cfg: MapConfig, mesh) -> ShardedMapState:
    """An empty map: this rank allocates its stripe only."""
    nc_local = _padded_nc(cfg, mesh.size) // mesh.size
    nx, ny, nz = cfg.n_cubes
    return ShardedMapState(
        corner=fm._empty_cube_cloud(nc_local, cfg.corner_cube_capacity, mesh.device),
        surf=fm._empty_cube_cloud(nc_local, cfg.surf_cube_capacity, mesh.device),
        origin=-torch.tensor([nx // 2, ny // 2, nz // 2], dtype=torch.int32,
                             device=mesh.device),
    )


def _my_slots(nc_local: int, mesh, device):
    """The flat slots of this rank's local cubes [nc_local] (padding slots
    are >= nc)."""
    return torch.arange(nc_local, device=device) * mesh.size + mesh.rank


def from_single(state: fm.FeatureMapState, cfg: MapConfig, mesh) -> ShardedMapState:
    """This rank's stripe of a single-device map (copied to ``mesh.device``)."""
    nc = _nc(cfg)
    nc_local = _padded_nc(cfg, mesh.size) // mesh.size
    slots = _my_slots(nc_local, mesh, state.origin.device)
    real = slots < nc
    take = slots.clamp(max=nc - 1)

    def stripe(cc: fm.CubeCloud) -> fm.CubeCloud:
        xyz = torch.where(real[:, None, None], cc.xyz[take], cloud_lib.FAR)
        return fm.CubeCloud.from_dense(xyz.to(mesh.device),
                                       (cc.mask[take] & real[:, None]).to(mesh.device),
                                       torch.where(real, cc.count[take], 0).to(mesh.device))

    return ShardedMapState(stripe(state.corner), stripe(state.surf),
                           state.origin.to(mesh.device, copy=True))


def _single_view(state: ShardedMapState) -> fm.FeatureMapState:
    """The stripe of a one-rank mesh as a FeatureMapState sharing its
    tensors: there the stripe is the whole map in the single-device layout."""
    return fm.FeatureMapState(corner=state.corner, surf=state.surf, origin=state.origin)


def to_single(state: ShardedMapState, cfg: MapConfig, mesh) -> fm.FeatureMapState:
    """The whole map as a single-device FeatureMapState on every rank: the
    stripes all-gathered and put back in slot order (collective: every rank
    calls it).  On a mesh of one rank, the state itself as one (no copy)."""
    if mesh.size == 1:
        return _single_view(state)
    nc = _nc(cfg)
    inv = torch.from_numpy(np.argsort(_stripe_perm(_padded_nc(cfg, mesh.size), mesh.size))
                           [:nc]).to(state.origin.device)

    def unstripe(cc: fm.CubeCloud) -> fm.CubeCloud:
        return fm.CubeCloud.from_dense(*(mesh_lib.all_gather(t, mesh)[inv]
                                         for t in (cc.xyz, cc.mask, cc.count)))

    return fm.FeatureMapState(unstripe(state.corner), unstripe(state.surf),
                              state.origin.clone())


def _pos(sensor_pos, mesh):
    return torch.as_tensor(sensor_pos, dtype=torch.float32, device=mesh.device)


def add_feature_cloud(state: ShardedMapState, corner_world: Cloud, surf_world: Cloud,
                      cfg: MapConfig, mesh) -> ShardedMapState:
    """Insert registered (world-frame) clouds: each rank scatters the points
    of the cubes it owns into its stripe.  In place; returns ``state``."""
    if mesh.size == 1:
        fm.add_feature_cloud(_single_view(state), corner_world, surf_world, cfg)
        return state
    nc_local = state.corner.count.shape[0]
    for cc, c in ((state.corner, corner_world), (state.surf, surf_world)):
        flat, ok = fm._grid_index(fm.world_to_cube(c.xyz, cfg), state.origin, cfg)
        mine = ok & c.mask & (flat % mesh.size == mesh.rank)
        fm._insert(cc, c.xyz, mine, torch.where(mine, flat // mesh.size, nc_local), nc_local)
    return state


def recenter(state: ShardedMapState, sensor_pos, cfg: MapConfig, mesh) -> ShardedMapState:
    """Keep the sensor inside the window (``feature_map.recenter``): each
    rank clears its own departing cubes.  In place; returns ``state``."""
    pos = _pos(sensor_pos, mesh)
    if mesh.size == 1:
        fm.recenter(_single_view(state), pos, cfg)
        return state
    nc = _nc(cfg)
    new_origin = state.origin + fm.window_shift(state.origin, pos, cfg)
    keep_full = fm.keep_mask_for_window(state.origin, new_origin, cfg)
    slots = _my_slots(state.corner.count.shape[0], mesh, pos.device)
    keep = torch.where(slots < nc, keep_full[slots.clamp(max=nc - 1)], False)
    fm._clear_slots(state.corner, keep)
    fm._clear_slots(state.surf, keep)
    state.origin.copy_(new_origin)
    return state


def _owned_active(state: ShardedMapState, pos, cfg: MapConfig, mesh):
    """(local cube [A], owned mask [A]) of the surround neighbourhood: the
    active cubes (``feature_map._active_cube_slots``) this rank holds."""
    flat, ok = fm._active_cube_slots(state, pos, cfg)
    own = ok & (flat % mesh.size == mesh.rank)
    return flat // mesh.size, own


def get_surround(state: ShardedMapState, sensor_pos, cfg: MapConfig, mesh):
    """The surround as (corner, surf) Clouds, the same on every rank.

    Each rank compacts its own active cubes to ``ceil(capacity / ndev)``
    points and one all-gather joins them, so the clouds hold ``ndev *
    ceil(capacity / ndev)`` slots, and a rank that owns more active points
    than its share drops the rest even where the single-device gather
    (which compacts all of them to ``capacity``) would keep them.  The
    stripe spreads a surround nearly evenly; a capacity of at least ``ndev``
    cube capacities keeps one full cube from ever being cut."""
    pos = _pos(sensor_pos, mesh)
    if mesh.size == 1:
        return fm.get_surround(_single_view(state), pos, cfg)
    local, own = _owned_active(state, pos, cfg, mesh)
    local = torch.where(own, local, 0).long()

    def gather(cc: fm.CubeCloud, capacity: int):
        mask = cc.mask[local] & own[:, None]
        c = cloud_lib.make(torch.where(mask[..., None], cc.xyz[local], cloud_lib.FAR)
                           .reshape(-1, 3), mask.reshape(-1))
        c = cloud_lib.compact(c, -(-capacity // mesh.size))
        return cloud_lib.make(mesh_lib.all_gather(c.xyz, mesh), mesh_lib.all_gather(c.mask, mesh))

    return (gather(state.corner, cfg.surround_corner_capacity),
            gather(state.surf, cfg.surround_surf_capacity))


def dedup_active(state: ShardedMapState, sensor_pos, cfg: MapConfig, mesh) -> ShardedMapState:
    """Voxel re-deduplicate the active cubes (``feature_map.dedup_active``):
    each rank filters the ones it owns, in one sort per feature class.  In
    place; returns ``state``."""
    pos = _pos(sensor_pos, mesh)
    if mesh.size == 1:
        fm.dedup_active(_single_view(state), pos, cfg)
        return state
    nc_local = state.corner.count.shape[0]
    local, own = _owned_active(state, pos, cfg, mesh)
    local = torch.where(own, local, nc_local).long()
    keep_first = cfg.dedup_policy == "anchor"
    fm._dedup_cubes(state.corner, local, own, cfg.corner_leaf, keep_first, nc_local)
    fm._dedup_cubes(state.surf, local, own, cfg.surf_leaf, keep_first, nc_local)
    return state


def mapping_step(matcher, map_state: ShardedMapState, corner: Cloud, surf: Cloud, L_now,
                 sm_cfg, matcher_cfg, map_cfg: MapConfig, mesh):
    """``models/laser_mapping.mapping_step`` against the striped map: merge
    guess, recenter, the surround gathered over the ranks, the scan match
    (replicated: every rank solves the same small problem), the commit
    policy, and the striped insert.  Returns (matcher', map_state,
    MappingOutput); the map is updated in place."""
    from ..models import laser_mapping as lm_mod
    from ..ops import scan_match as sm
    from ..utils import se3, twist

    if mesh.size == 1:
        matcher, _, out = lm_mod.mapping_step(matcher, _single_view(map_state), corner, surf,
                                              L_now, sm_cfg, matcher_cfg, map_cfg)
        return matcher, map_state, out

    T_guess = se3.transform_associate(matcher.L_last, L_now, matcher.W_last)
    corner_ds, surf_ds = lm_mod.prepare_frame(corner, surf, matcher_cfg)
    sensor_pos = T_guess[:3, 3]
    recenter(map_state, sensor_pos, map_cfg, mesh)
    ref_corner, ref_surf = get_surround(map_state, sensor_pos, map_cfg, mesh)
    res = sm.scan_match(corner_ds, surf_ds, ref_corner, ref_surf, twist.from_mat(T_guess),
                        sm_cfg)
    W_new = lm_mod._committed_pose(res, T_guess, matcher_cfg)
    add_feature_cloud(map_state, lm_mod._to_world(corner_ds, W_new),
                      lm_mod._to_world(surf_ds, W_new), map_cfg, mesh)
    return (lm_mod.MatcherState(L_last=L_now, W_last=W_new), map_state,
            lm_mod.MappingOutput(W=W_new, result=res, corner_ds=corner_ds, surf_ds=surf_ds))
