"""Fixed-shape voxel-grid downsampling (port of ``cooper_mapper_tpu/ops/voxel.py``).

pcl::VoxelGrid semantics: one output point per occupied voxel, at the
centroid of the valid points inside it, or, with ``keep_first``, the first
valid point of the voxel in input order (the map's "anchor" dedup policy).
The lexicographic sort of the JAX package (``jnp.lexsort((z, y, x,
~mask))``) is rebuilt from stable sorts, least-significant key first;
stability decides which point leads each voxel and so which point, ring
and rel_time the voxel keeps.

``filter_sorted`` also filters many clouds in one pass: a group key in
front of the sort keys keeps each group's points together and in the order
its own filter would give them (``maps/feature_map.dedup_active`` filters
every active cube of the map this way).
"""

from __future__ import annotations

import torch

from ..utils import cloud as cloud_lib
from ..utils.cloud import Cloud


def divide(xyz, size: float):
    """``xyz / size`` rounded as the CPU rounds it, on every device.  On the
    card PyTorch turns a division by a Python number into a product with its
    f32 reciprocal, which rounds differently for some points that lie on a
    cell boundary (x = 4.2 m, 0.2 m leaf), and a floor then puts them in the
    neighbouring cell; a tensor divisor keeps the division."""
    return xyz / torch.tensor(size, dtype=xyz.dtype, device=xyz.device)


def voxel_coords(xyz, leaf):
    """Signed int32 voxel cell coordinates."""
    return torch.floor(divide(xyz, leaf)).to(torch.int32)


def _lexsort(keys):
    """Indices that sort by ``keys`` with the LAST key primary (numpy's
    lexsort order), ties kept in index order."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def filter_sorted(xyz, mask, leaf: float, keep_first: bool = False, group=None):
    """The voxel filter of [n] points before compaction.  Returns (order,
    out_xyz, out_mask): the sort order, and in that order one valid output
    point at the first point of each voxel (FAR elsewhere).  With ``group``
    ([n] int, non-negative) each group is filtered on its own and the groups
    come out in ascending order."""
    n = xyz.shape[0]
    ijk = voxel_coords(xyz, leaf)
    # invalid points go to one dedicated far cell so they form one segment
    ijk = torch.where(mask[:, None], ijk, torch.full_like(ijk, 2**20))
    lead = (~mask).to(torch.int32)
    if group is not None:
        lead = group.to(torch.int32) * 2 + lead
    order = _lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0], lead))
    ijk_s = ijk[order]
    xyz_s = xyz[order]
    mask_s = mask[order]

    new_seg = torch.ones(n, dtype=torch.bool, device=xyz.device)
    new_seg[1:] = torch.any(ijk_s[1:] != ijk_s[:-1], dim=-1)
    if group is not None:
        g_s = group[order]
        new_seg[1:] |= g_s[1:] != g_s[:-1]

    # one output per voxel: the first sorted point carries the metadata
    out_mask = new_seg & mask_s
    far = torch.full_like(xyz_s, cloud_lib.FAR)
    if keep_first:
        return order, torch.where(out_mask[:, None], xyz_s, far), out_mask
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    w = mask_s.to(torch.float32)
    # segment_reduce adds each voxel's points one after another in index
    # order on both devices, so the f32 sums equal the JAX package's
    # segment_sum and repeat bit for bit (index_add_ on the card adds with
    # atomics in no fixed order)
    lengths = torch.bincount(seg_id, minlength=n)
    sums = torch.segment_reduce(xyz_s * w[:, None], "sum", lengths=lengths)
    cnts = torch.segment_reduce(w, "sum", lengths=lengths)
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    return order, torch.where(out_mask[:, None], centroids[seg_id], far), out_mask


def voxel_downsample(c: Cloud, leaf: float, capacity: int | None = None,
                     keep_first: bool = False) -> Cloud:
    """Voxel filter of an unbatched cloud; invalid points never contribute.
    The output is each voxel's centroid, or with ``keep_first`` its first
    valid point (the sort is stable, so "first" is the lowest input index).
    Output capacity defaults to the input capacity."""
    order, out_xyz, out_mask = filter_sorted(c.xyz, c.mask, leaf, keep_first)
    out = cloud_lib.make(out_xyz, out_mask, c.ring[order], c.rel_time[order])
    return cloud_lib.compact(out, capacity or c.capacity)
