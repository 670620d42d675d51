"""Fixed-shape voxel-grid downsampling (port of ``cooper_mapper_tpu/ops/voxel.py``).

pcl::VoxelGrid semantics: one output point per occupied voxel, at the
centroid of the valid points inside it.  The lexicographic sort of the JAX
package (``jnp.lexsort((z, y, x, ~mask))``) is rebuilt from stable sorts,
least-significant key first; stability decides which point leads each voxel
and so which ring and rel_time the voxel keeps.
"""

from __future__ import annotations

import torch

from ..utils import cloud as cloud_lib
from ..utils.cloud import Cloud


def voxel_coords(xyz, leaf):
    """Signed int32 voxel cell coordinates."""
    return torch.floor(xyz / leaf).to(torch.int32)


def _lexsort(keys):
    """Indices that sort by ``keys`` with the LAST key primary (numpy's
    lexsort order), ties kept in index order."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def voxel_downsample(c: Cloud, leaf: float, capacity: int | None = None) -> Cloud:
    """Centroid voxel filter of an unbatched cloud; invalid points never
    contribute.  Output capacity defaults to the input capacity."""
    n = c.capacity
    capacity = capacity or n
    ijk = voxel_coords(c.xyz, leaf)
    # invalid points go to one dedicated far cell so they form one segment
    ijk = torch.where(c.mask[:, None], ijk, torch.full_like(ijk, 2**20))
    order = _lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0], (~c.mask).to(torch.int8)))
    ijk_s = ijk[order]
    xyz_s = c.xyz[order]
    mask_s = c.mask[order]

    new_seg = torch.cat([
        torch.ones(1, dtype=torch.bool, device=ijk.device),
        torch.any(ijk_s[1:] != ijk_s[:-1], dim=-1),
    ])
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1

    # one output per voxel: the first sorted point carries the metadata
    out_mask = new_seg & mask_s
    w = mask_s.to(torch.float32)
    # segment_reduce adds each voxel's points one after another in index
    # order on both devices, so the f32 sums equal the JAX package's
    # segment_sum and repeat bit for bit (index_add_ on the card adds with
    # atomics in no fixed order)
    lengths = torch.bincount(seg_id, minlength=n)
    sums = torch.segment_reduce(xyz_s * w[:, None], "sum", lengths=lengths)
    cnts = torch.segment_reduce(w, "sum", lengths=lengths)
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    out_xyz = torch.where(out_mask[:, None], centroids[seg_id],
                          torch.full_like(xyz_s, cloud_lib.FAR))
    out = cloud_lib.make(out_xyz, out_mask, c.ring[order], c.rel_time[order])
    return cloud_lib.compact(out, capacity)
