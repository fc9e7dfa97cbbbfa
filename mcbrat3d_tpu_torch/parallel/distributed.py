"""Processes across cards: one rank per card under ``torch.distributed``.

Counterpart of ``mcbrat3d_tpu.parallel.distributed`` (reference:
src/multipleProcesses_mpi.f95:29-52). The JAX package drives every device
of a host from one process and joins hosts with ``jax.distributed``;
PyTorch's idiom is one process per card, started by ``torchrun`` (which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
``MASTER_ADDR``/``MASTER_PORT``) or by ``parallel.launch.spawn``, with
NCCL between cards and gloo on the CPU. A single process needs none of
this: ``initialize()`` is then a no-op and the helpers below act as for one
rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mcbrat3d_tpu_torch.core.device import resolve

# The device this process joined its group with (``initialize``); None
# while no group is formed.
_DEVICE: Optional[torch.device] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               device=None) -> Optional[torch.device]:
    """Join the process group (initializeProcesses equivalent) and return
    this rank's device.

    A single process (no ``init_method``, ``world_size`` or ``rank`` and no
    ``RANK`` in the environment) forms no group and returns None. Otherwise
    the missing arguments come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``init_method`` "env://" over ``MASTER_ADDR`` and
    ``MASTER_PORT``). The device is ``device`` when it names one, else
    ``cuda:{LOCAL_RANK}`` (a bare "cuda" is the rank's card too); the
    backend is ``backend``, else "nccl" for a CUDA device and "gloo" for
    the CPU. NCCL takes one card a rank: more ranks on this host
    (``LOCAL_WORLD_SIZE``) than cards raises ``ValueError`` before the
    group forms, and a CUDA device without a card raises in
    ``core.device.resolve``. Called again in a process that has joined, it
    returns the device it joined with."""
    global _DEVICE
    env = os.environ
    if is_initialized():
        if device is not None and not _bare_cuda(device) \
                and torch.device(device) != _DEVICE:
            raise ValueError(f"this process joined its group on {_DEVICE}, "
                             f"not {device}")
        return _DEVICE
    if init_method is None and world_size is None and rank is None \
            and "RANK" not in env:
        return None
    local_rank = int(env.get("LOCAL_RANK", 0))
    if device is None or _bare_cuda(device):
        device = f"cuda:{local_rank}"
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        local_ranks = int(env.get("LOCAL_WORLD_SIZE", 1))
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"NCCL takes one card a rank, but {local_ranks} ranks run on "
                f"this host and it has {cards} CUDA cards")
    dev = resolve(dev)
    if dev.type == "cuda":
        if dev.index is None or dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} is not one of this host's "
                             f"{torch.cuda.device_count()} CUDA cards")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=int(env["WORLD_SIZE"]) if world_size is None
        else world_size,
        rank=int(env["RANK"]) if rank is None else rank)
    _DEVICE = dev
    return dev


def _bare_cuda(device) -> bool:
    return torch.device(device) == torch.device("cuda")


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def device() -> Optional[torch.device]:
    """The device ``initialize`` joined with (None without a group)."""
    return _DEVICE


def is_master() -> bool:
    """MasterProc equivalent: rank 0, or the only process."""
    return rank() == 0


def synchronize() -> None:
    """Barrier across ranks (synchronizeProcesses equivalent); a no-op for
    one process."""
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (finalizeProcesses equivalent); a no-op
    without one."""
    global _DEVICE
    if is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
