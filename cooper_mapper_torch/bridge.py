"""numpy -> port state: builds the port's ``Cloud``, ``Sweep`` and
``FeatureClouds`` from numpy arrays whose field names are the JAX package's.

There are no weights in this system; what crosses between the packages is
state.  ``from_numpy`` takes any object with the right attributes (a JAX
``Cloud``/``Sweep``/``FeatureClouds`` or a namespace of numpy arrays) and
copies each field through ``np.asarray``, so the caller never hands a JAX
array to torch.
"""

from __future__ import annotations

import numpy as np
import torch

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
