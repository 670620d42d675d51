"""numpy <-> port state: builds the port's ``Cloud``, ``Sweep``,
``FeatureClouds`` and the single-stream states (``OdometryState``,
``MatcherState``, ``FeatureMapState``, ``FusedState``) and the
``PoseGraph`` from numpy arrays whose field names are the JAX package's,
and turns results back into numpy.

There are no weights in this system; what crosses between the packages is
state (clouds in, results out).  ``cloud``, ``sweep`` and
``feature_clouds`` take any object with the right attributes (a JAX
``Cloud``/``Sweep``/``FeatureClouds`` or a namespace of numpy arrays) and
copy each field through ``np.array``, so the caller never hands a JAX array
to torch.  ``to_numpy`` reads a result dataclass of either package (e.g.
``ScanMatchResult``) field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .maps.feature_map import CubeCloud, FeatureMapState
from .models.fused import FusedState
from .models.laser_mapping import MatcherState
from .models.laser_odometry import OdometryState
from .ops.pose_graph import PoseGraph
from .ops.features import FeatureClouds, Sweep
from .utils.cloud import Cloud

_DTYPES = {
    "xyz": torch.float32, "rel_time": torch.float32,
    "mask": torch.bool, "ring": torch.int32,
}


def _tensor(a, field, device):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=_DTYPES[field])


def cloud(c, device="cuda") -> Cloud:
    return Cloud(*(_tensor(getattr(c, f), f, device)
                   for f in ("xyz", "mask", "ring", "rel_time")))


def sweep(s, device="cuda") -> Sweep:
    return Sweep(*(_tensor(getattr(s, f), f, device)
                   for f in ("xyz", "mask", "rel_time")))


def feature_clouds(fc, device="cuda") -> FeatureClouds:
    return FeatureClouds(*(cloud(getattr(fc, f), device)
                           for f in ("sharp", "less_sharp", "flat", "less_flat")))


def _array(a, dtype, device):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def odometry_state(s, device="cuda") -> OdometryState:
    return OdometryState(cloud(s.last_corner, device), cloud(s.last_surf, device),
                         _array(s.x_prev, torch.float32, device),
                         _array(s.T_sum, torch.float32, device))


def matcher_state(s, device="cuda") -> MatcherState:
    return MatcherState(_array(s.L_last, torch.float32, device),
                        _array(s.W_last, torch.float32, device))


def feature_map_state(s, device="cuda") -> FeatureMapState:
    cube = lambda cc: CubeCloud.from_dense(_array(cc.xyz, torch.float32, device),
                                           _array(cc.mask, torch.bool, device),
                                           _array(cc.count, torch.int32, device))
    return FeatureMapState(cube(s.corner), cube(s.surf), _array(s.origin, torch.int32, device))


def fused_state(s, device="cuda") -> FusedState:
    return FusedState(odometry_state(s.odo, device), matcher_state(s.matcher, device),
                      feature_map_state(s.map, device))


def pose_graph(g, device="cuda") -> PoseGraph:
    """A JAX ``PoseGraph`` (or any object with its fields) as the port's."""
    return PoseGraph(*(_array(getattr(g, f.name), dt, device) for f, dt in zip(
        dataclasses.fields(PoseGraph),
        (torch.float32, torch.bool, torch.int32, torch.int32, torch.float32, torch.float32,
         torch.bool))))


def to_numpy(result) -> dict:
    """Every field of a result dataclass, the port's or the JAX package's,
    as a numpy array keyed by field name."""
    out = {}
    for f in dataclasses.fields(result):
        v = getattr(result, f.name)
        out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out
