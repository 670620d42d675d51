"""LaserMapping front end (start of the port of
``cooper_mapper_tpu/models/laser_mapping.py``).

Only the frame preparation is ported: ``prepare_frame`` voxel-downsamples the
incoming feature stacks and ``_to_world`` registers a cloud into the world
frame.  The mapping step and the cube map come with the next slice.
"""

from __future__ import annotations

import torch

from ..config import MatcherConfig
from ..ops.voxel import voxel_downsample
from ..utils import cloud as cloud_lib
from ..utils import se3
from ..utils.cloud import Cloud


def prepare_frame(corner: Cloud, surf: Cloud, cfg: MatcherConfig):
    """Voxel-downsample the incoming end-projected feature stacks
    (prepareFeatureFrame, LaserMatcher.cpp:288-301)."""
    return (
        voxel_downsample(corner, cfg.corner_leaf, cfg.max_frame_corner),
        voxel_downsample(surf, cfg.surf_leaf, cfg.max_frame_surf),
    )


def _to_world(c: Cloud, T) -> Cloud:
    """``c`` moved by the [4, 4] pose T; invalid points stay at FAR."""
    xyz = se3.apply(T, c.xyz)
    return Cloud(torch.where(c.mask[:, None], xyz, cloud_lib.FAR), c.mask, c.ring,
                 c.rel_time)
