"""Photon data-parallel batches over the ranks of a process group.

Counterpart of ``mcbrat3d_tpu.parallel.mesh`` (reference:
src/multipleProcesses_mpi.f95 and the master-worker scheduler of
Drivers/monteCarloDriver.f95:665-880). The JAX package runs one global
batch under ``shard_map`` over a device mesh and ``psum``s the tallies;
here each rank of a ``torch.distributed`` group (one process, one card)
runs its sub-batch through ``run_batch`` and the tallies are summed by
``all_reduce``, so every rank holds the global batch's tallies. The
schedule is static and deterministic, as the JAX package's: rank ``d`` of
``n`` traces sub-batch stream ``global_batch * n + d``, so an n-rank run
equals the sum of the n correspondingly numbered serial sub-batches (the
reference's (iseed, rank) stream reproducibility;
Drivers/monteCarloDriver.f95:901).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.parallel import distributed
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig, Tallies,
                                                      run_batch)
from mcbrat3d_tpu_torch.transport.local_estimate import IntensityConfig

# The tally tensors a batch sums over the ranks (those that are not None),
# and its counts.
TALLY_FIELDS = ("flux_up", "flux_down", "flux_absorbed", "volume_absorption",
                "intensity", "absorption_profile", "flux_up_by_order",
                "flux_down_by_order")
COUNT_FIELDS = ("n_photons", "n_bad", "n_steps", "n_cut", "n_lane_steps",
                "n_passes", "n_real", "n_le_events", "n_walk",
                "n_atm_births")


@dataclasses.dataclass(frozen=True)
class PhotonGroup:
    """The ranks of the default process group a global photon batch is
    spread over (where the JAX package holds a ``Mesh``): this process's
    rank, the group's size and the device this rank runs on."""

    rank: int
    size: int
    device: torch.device


def make_mesh() -> PhotonGroup:
    """The ``PhotonGroup`` of every rank for this process, which must have
    joined the group (``distributed.initialize``)."""
    if not distributed.is_initialized():
        raise ValueError("make_mesh needs a process group: call "
                         "parallel.distributed.initialize first")
    return PhotonGroup(rank=dist.get_rank(), size=dist.get_world_size(),
                       device=distributed.device())


def resolve_mesh(mesh) -> Optional[PhotonGroup]:
    """None | PhotonGroup | "auto" -> PhotonGroup or None. "auto" is the
    default group when it is formed with more than one rank."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be None, a PhotonGroup or 'auto', "
                             f"got {mesh!r}")
        return make_mesh() if distributed.world_size() > 1 else None
    return mesh


def run_batch_sharded(domain: OpticalDomain,
                      surface: Surface,
                      source: illumination.Source,
                      seed: int,
                      global_batch: int,
                      config: KernelConfig,
                      mesh: Optional[PhotonGroup],
                      intensity_config: Optional[IntensityConfig] = None,
                      intensity_dirs: Optional[torch.Tensor] = None,
                      n_photons: Optional[int] = None) -> Tallies:
    """One global photon batch over the ranks of ``mesh``; every rank
    calls it and gets the global tallies. Without a mesh it is the serial
    batch: one rank, stream ``global_batch``, no all-reduce.

    Rank ``d`` of ``n`` runs ``run_batch`` on sub-batch stream
    ``global_batch * n + d`` (kernel seed ``rng.batch_seed``, the wave
    kernel's ``rng.batch_key``) with ``config.photons_per_batch`` photons,
    or its share of ``n_photons`` (``n_photons // n``, one more on the
    first ``n_photons % n`` ranks); then the tally tensors (one flat
    buffer) and the counts (one int64 vector) are summed over the ranks.
    Direction grids past ``MAX_KERNEL_DIRS`` are chunked by the rank's
    ``run_batch`` before the sum, which equals the JAX package's chunked
    sharded passes. ``n_photons`` above ``n * config.photons_per_batch``
    raises ``ValueError`` before any transport, as radiance on a domain
    without forward phase tables does in ``run_batch``."""
    n, d = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if n_photons is not None and n_photons > n * config.photons_per_batch:
        raise ValueError(
            f"n_photons={n_photons} exceeds the group's capacity "
            f"{n} * {config.photons_per_batch}; raise photons_per_lane or "
            "split into more batches")
    if mesh is not None and domain.device != mesh.device:
        raise ValueError(f"the domain is on {domain.device} but this rank "
                         f"runs on {mesh.device}")
    n_local = None
    if n_photons is not None:
        n_local = n_photons // n + int(d < n_photons % n)
    stream = global_batch * n + d
    t = run_batch(domain, surface, source, rng.batch_seed(seed, stream),
                  config, n_photons=n_local,
                  intensity_config=intensity_config,
                  intensity_dirs=intensity_dirs,
                  key=rng.batch_key(seed, stream))
    return t if mesh is None else _all_reduce(t)


def _all_reduce(t: Tallies) -> Tallies:
    """``t`` summed over the ranks of the group: one all-reduce of the
    tally tensors, flattened into one buffer, and one of the counts. Gloo
    sums host tensors, so there the buffers go through the host."""
    names = [k for k in TALLY_FIELDS if getattr(t, k) is not None]
    parts = [getattr(t, k) for k in names]
    flat = torch.cat([p.reshape(-1) for p in parts])
    counts = torch.tensor([int(getattr(t, k)) for k in COUNT_FIELDS],
                          dtype=torch.int64, device=flat.device)
    host = dist.get_backend() == "gloo"
    bufs = [b.cpu() if host else b for b in (flat, counts)]
    for b in bufs:
        dist.all_reduce(b, op=dist.ReduceOp.SUM)
    flat, counts = (b.to(flat.device) for b in bufs)
    summed, lo = {}, 0
    for k, p in zip(names, parts):
        summed[k] = flat[lo:lo + p.numel()].view(p.shape).to(p.dtype)
        lo += p.numel()
    summed.update(zip(COUNT_FIELDS, counts.tolist()))
    return dataclasses.replace(t, **summed)
