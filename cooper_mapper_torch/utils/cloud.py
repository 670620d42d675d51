"""Fixed-capacity masked point clouds (port of ``cooper_mapper_tpu/utils/cloud.py``).

A ``Cloud`` is a struct of tensors with a static capacity N and a validity
mask; any number of leading batch dimensions is allowed.  Invalid entries
hold the FAR sentinel so they lose every nearest-neighbour race.
"""

from __future__ import annotations

import dataclasses

import torch

# Far-away sentinel for invalid points: far outside the 150 m valid distance,
# so a sentinel never passes a squared-distance gate.
FAR = 1.0e6


@dataclasses.dataclass
class Cloud:
    """xyz [..., N, 3] f32, mask [..., N] bool, ring [..., N] i32,
    rel_time [..., N] f32 (in-sweep time fraction)."""

    xyz: torch.Tensor
    mask: torch.Tensor
    ring: torch.Tensor
    rel_time: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self):
        return torch.sum(self.mask.to(torch.int32), dim=-1, dtype=torch.int32)

    def masked_xyz(self, fill: float = FAR):
        """xyz with invalid points pushed to a far sentinel (so they lose any
        nearest-neighbour race without branching)."""
        return self.xyz.masked_fill(~self.mask[..., None], fill)


def make(xyz, mask, ring=None, rel_time=None) -> Cloud:
    n = xyz.shape[:-1]
    if ring is None:
        ring = torch.zeros(n, dtype=torch.int32, device=xyz.device)
    if rel_time is None:
        rel_time = torch.zeros(n, dtype=torch.float32, device=xyz.device)
    return Cloud(xyz, mask, ring, rel_time)


def from_points(xyz, capacity: int | None = None, ring=None, rel_time=None,
                device="cuda") -> Cloud:
    """A Cloud from a dense [n, 3] array (numpy or tensor), padded with
    invalid FAR points to ``capacity``."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    n = xyz.shape[0]
    cap = capacity or n
    pad = cap - n
    if pad < 0:
        raise ValueError(f"capacity {cap} < number of points {n}")
    mask = torch.cat([torch.ones(n, dtype=torch.bool, device=device),
                      torch.zeros(pad, dtype=torch.bool, device=device)])
    xyz = torch.cat([xyz, torch.full((pad, 3), FAR, dtype=torch.float32, device=device)])
    if ring is not None:
        ring = torch.cat([torch.as_tensor(ring, dtype=torch.int32, device=device),
                          torch.zeros(pad, dtype=torch.int32, device=device)])
    if rel_time is not None:
        rel_time = torch.cat([torch.as_tensor(rel_time, dtype=torch.float32, device=device),
                              torch.zeros(pad, dtype=torch.float32, device=device)])
    return make(xyz, mask, ring, rel_time)


def empty(capacity: int, device=None) -> Cloud:
    return make(torch.full((capacity, 3), FAR, dtype=torch.float32, device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device))


def concat(a: Cloud, b: Cloud) -> Cloud:
    """``b``'s points after ``a``'s (along the point axis)."""
    return Cloud(torch.cat([a.xyz, b.xyz], dim=-2), torch.cat([a.mask, b.mask], dim=-1),
                 torch.cat([a.ring, b.ring], dim=-1),
                 torch.cat([a.rel_time, b.rel_time], dim=-1))


def compact(c: Cloud, capacity: int | None = None) -> Cloud:
    """Stable-sort valid points to the front of an unbatched cloud, then keep
    the first ``capacity`` entries."""
    cap = capacity or c.capacity
    order = torch.argsort((~c.mask).to(torch.int8), stable=True)[:cap]
    return Cloud(c.xyz[order], c.mask[order], c.ring[order], c.rel_time[order])
