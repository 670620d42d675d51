"""The device mesh and its layout helpers (port of ``cooper_mapper_tpu/parallel/mesh.py``).

The JAX package scales SPMD over a ``jax.sharding.Mesh``: the batch of
independent solves shards over its ``batch`` axis, and the pose-graph normal
equations reduce per-edge contributions with ``psum`` over the same mesh.
Here the mesh is a ``torch.distributed`` process group with one process per
card: each rank holds its own block of a sharded batch on ``mesh.device``,
and the reductions are explicit collectives on plain tensors (NCCL on the
card, gloo on the CPU).  There is no ``DTensor``: the CUDA kernels take
plain tensors.

The layouts: ``shard_batch`` gives this rank's contiguous block of the
leading dimension (the layout of ``P("batch")``), ``replicated`` puts a whole
copy on every rank (``P()``), and ``gather_batch`` all-gathers the blocks
back into the whole batch on every rank (what reading a global ``jax.Array``
gives).  A "tree" is a tensor, a tuple, list or dict of trees, a dataclass
of trees (``Cloud``, ``GNState``, ``ScanMatchResult``), or None.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one of its ranks: ``size`` ranks, this one
    ``rank``, its tensors on ``device``."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis_names: tuple = (BATCH_AXIS,)


def make_mesh(n_devices: int | None = None, axis: str = BATCH_AXIS, device=None):
    """The mesh over the first ``n_devices`` ranks of the initialized default
    group (all of them by default).  ``new_group`` is collective, so every
    rank of the default group calls this; a rank outside the first
    ``n_devices`` gets None.  ``device`` defaults to this process's card
    under NCCL and to the CPU under gloo (a gloo group over CUDA tensors,
    as two ranks on one card need, passes ``device="cuda"``)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return Mesh(group, n, rank, torch.device(device), (axis,))


def tree_map(fn, tree):
    """``fn`` applied to every tensor of ``tree``; the structure is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _block(t, mesh: Mesh):
    b = t.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not divide over {mesh.size} ranks")
    per = b // mesh.size
    return t[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous block of every tensor's leading dimension, on
    ``mesh.device``.  Raises if a batch does not divide over the ranks."""
    return tree_map(lambda t: _block(t, mesh), tree)


def replicated(tree, mesh: Mesh):
    """Every tensor of ``tree`` whole on ``mesh.device``."""
    return tree_map(lambda t: t.to(mesh.device), tree)


def _staged(mesh: Mesh, t):
    """gloo over a CUDA tensor goes through a host copy (gloo's collectives
    are the CPU's); NCCL and CPU tensors go as they are."""
    return t.cpu() if t.is_cuda and dist.get_backend(mesh.group) == "gloo" else t


def all_reduce(t, mesh: Mesh):
    """Sum ``t`` over the mesh in place and return it: every rank gets the
    sum.  Over one rank the sum is ``t`` itself, bit for bit."""
    s = _staged(mesh, t.contiguous())
    dist.all_reduce(s, group=mesh.group)
    if s.data_ptr() != t.data_ptr():
        t.copy_(s)
    return t


def all_gather(t, mesh: Mesh):
    """Every rank's ``t`` (same shape on each), concatenated along dim 0 in
    rank order, on every rank."""
    s = _staged(mesh, t.contiguous())
    parts = [torch.empty_like(s) for _ in range(mesh.size)]
    dist.all_gather(parts, s, group=mesh.group)
    return torch.cat(parts).to(t.device)


def gather_batch(tree, mesh: Mesh):
    """The whole batch on every rank from each rank's block (the inverse of
    ``shard_batch``)."""
    return tree_map(lambda t: all_gather(t, mesh), tree)
