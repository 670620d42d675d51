"""Multi-process glue (port of ``cooper_mapper_tpu/parallel/distributed.py``).

The JAX package joins N hosts into one ``jax.distributed`` process group
whose global mesh spans every host's devices.  PyTorch runs one process per
card, so here the group's ranks are the cards: ``initialize`` forms the
``torch.distributed`` group (NCCL on the card, gloo on the CPU), and
``parallel/mesh.make_mesh`` builds the mesh over it.  The sharded solvers of
``parallel/batch.py`` and the striped map of ``maps/sharded_map.py`` then
run the same code on one rank, one host or several.

Typical launch, one process per card (``torchrun --nproc-per-node=4
script.py`` sets the environment this reads):

    from cooper_mapper_torch.parallel import batch, distributed, mesh
    distributed.initialize()        # or coordinator="tcp://host0:1234", ...
    m = mesh.make_mesh()            # every rank of every host
    batch.sharded_odometry_solve(..., m)   # the batch divides over the ranks
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def _from_env():
    """torchrun's environment: (init method, world size, rank, local rank)."""
    env = os.environ
    return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
            int(env["RANK"]), int(env.get("LOCAL_RANK", env["RANK"])))


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda", backend: str | None = None,
               timeout: float = 600.0) -> torch.device:
    """``init_process_group`` over ``num_processes`` processes, this one
    ``process_id``, rendezvousing at ``coordinator`` (``"host:port"`` or a
    ``tcp://`` / ``file://`` URL).  With no arguments it reads torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``: the counterpart of JAX's cluster auto-detection.

    On ``device="cuda"`` it selects the card ``LOCAL_RANK`` (the process id
    modulo the cards where the variable is unset) and uses NCCL; on the CPU,
    gloo.  ``backend="gloo"`` with ``device="cuda"`` runs gloo over CUDA
    tensors (staged through the host), as ranks that share one card need:
    NCCL refuses two ranks on one card.  ``timeout`` (seconds) bounds every
    collective, so a rank that never arrives fails the others.  Returns the
    device this process's tensors go on."""
    if coordinator is None:
        init, world, rank, local = _from_env()
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = num_processes, process_id
        local = int(os.environ.get("LOCAL_RANK", -1))
    device = torch.device(device)
    if device.type == "cuda":
        if local < 0:
            local = rank % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return device


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world():
    return (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a sharded batch that this process owns."""
    n, i = _world()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def is_multihost() -> bool:
    """More than one process in the group (one process per card here)."""
    return _world()[0] > 1
