"""Batch-loop driver: runs batches, accumulates moments, finalizes results.

PyTorch counterpart of ``mcbrat3d_tpu.driver.run`` (reference:
Drivers/monteCarloDriver.f95:889-1228): per batch the
per-photon-normalized tallies are accumulated as photon-weighted first and
second moments on the domain's device (``DeviceMomentAccumulator``, the
layout the broadband loop uses too; one host fetch at the end); the mean
is scaled by the incident flux and the standard error is
sqrt(max(0, E[x^2] - E[x]^2)/(nBatches - 1)). Batch b runs with the kernel
seed ``rng.batch_seed(iseed, b)`` and the wave kernel's threefry key
``rng.batch_key(iseed, b)`` (the JAX package's, so a deck with usePallas =
'off' follows its paths). With a ``parallel.mesh.PhotonGroup`` of n
ranks batch b is one global batch over them: rank d runs sub-batch stream
b * n + d (``parallel.mesh.run_batch_sharded``), as the JAX package's
mesh does. Decks with radiance directions also
accumulate the top-of-domain radiance image and its
per-direction domain mean, decks with numRecScatOrd the boundary fluxes by
scattering order. A resumed run passes the checkpoint's moments and its
next batch (``driver.checkpoint``) and goes on from there; every
``checkpointEveryBatches`` batches ``checkpoint_cb`` saves the state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from mcbrat3d_tpu_torch.core.accumulate import (DeviceMomentAccumulator,
                                                MomentAccumulator)
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.driver.checkpoint import check_resume
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.parallel.mesh import (resolve_mesh,
                                              run_batch_sharded)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig
from mcbrat3d_tpu_torch.transport.local_estimate import (
    IntensityConfig, make_intensity_directions)


@dataclasses.dataclass
class Results:
    """Finalized means and standard errors (float64, host)."""

    mean: dict
    stderr: dict
    total_photons: int
    n_batches: int
    solar_flux: float
    elapsed_seconds: float
    config: Optional[SimulationConfig] = None
    grid: object = None
    n_bad: int = 0  # photons cut by the step cap, summed over batches
    n_passes: int = 0  # tiled-kernel passes, summed over batches
    setup_seconds: float = 0.0  # before the first transport (broadband)
    # host seconds building the later bins' domains and sources (broadband)
    build_seconds: float = 0.0

    def __getitem__(self, name):
        return self.mean[name]


def kernel_config_from(cfg: SimulationConfig,
                       n_devices: int = 1) -> KernelConfig:
    """Kernel config of one rank: numPhotonsPerBatch is the global batch,
    split over ``n_devices`` ranks. Capacity is rounded up at both splits
    and the exact n_photons clamp honors numPhotonsPerBatch when it is not
    a multiple of n_devices * the lane count."""
    per_dev = max(1, -(-cfg.num_photons_per_batch // max(1, n_devices)))
    n_lanes = min(cfg.n_lanes, per_dev)
    ppl = max(1, -(-per_dev // n_lanes))
    return KernelConfig(
        n_lanes=n_lanes,
        photons_per_lane=ppl,
        max_steps=cfg.max_steps,
        use_ray_tracing=cfg.use_ray_tracing,
        use_russian_roulette=cfg.use_russian_roulette,
        lw_mode=cfg.is_longwave,
        record_scattering_orders=(cfg.num_rec_scat_ord
                                  if cfg.rec_scat_ord else 0),
        need_volume_absorption=(cfg.report_volume_absorption
                                or bool(cfg.output_abs_volume_file)),
        need_absorption_profile=(cfg.report_absorption_profile
                                 or bool(cfg.output_abs_prof_file)),
        use_pallas=cfg.use_pallas,
    )


def run_simulation(domain: OpticalDomain,
                   surface: Surface,
                   source: illumination.Source,
                   cfg: SimulationConfig,
                   solar_flux: float = 1.0,
                   mesh=None,
                   accumulator: Optional[MomentAccumulator] = None,
                   start_batch: int = 0,
                   checkpoint_cb=None,
                   resume_chunk_size: Optional[int] = None,
                   resume_ranks: Optional[int] = None) -> Results:
    """Run batches ``start_batch`` .. cfg.num_batches - 1 on the domain's
    device and return finalized statistics. ``solar_flux`` scales all
    outputs (reference: Drivers/monteCarloDriver.f95:1188-1228).
    ``mesh`` (None, a ``parallel.mesh.PhotonGroup`` or "auto": the default
    process group when it has more than one rank) spreads each batch over
    its ranks; every rank calls this and gets the same results.
    ``accumulator`` holds the moments of the batches before
    ``start_batch`` (a checkpoint's), ``resume_chunk_size`` and
    ``resume_ranks`` the photons a batch (photons_per_batch x ranks) and
    the ranks of the run that wrote it, where recorded: a resume under
    another chunk size or rank count raises
    (``driver.checkpoint.check_resume``); ``checkpoint_cb(next_batch,
    acc, chunk_size)`` is called every cfg.checkpoint_every_batches
    batches.
    ``n_bad`` and ``n_passes`` count the batches this call runs."""
    mesh = resolve_mesh(mesh)
    n_dev = 1 if mesh is None else mesh.size
    kcfg = kernel_config_from(cfg, n_devices=n_dev)
    chunk_size = kcfg.photons_per_batch * n_dev
    if start_batch > 0:
        check_resume(chunk_size, n_dev, resume_chunk_size, resume_ranks)
    icfg = idirs = None
    if cfg.compute_intensity:
        mus, phis = cfg.radiance_directions()
        idirs = make_intensity_directions(mus, phis, device=domain.device)
        icfg = IntensityConfig(
            n_dirs=int(mus.size),
            use_russian_roulette=cfg.use_russian_roulette_intensity,
            zeta_min=cfg.zeta_min,
            use_hybrid_phase=cfg.use_hybrid_phase_funs,
            n_orders_orig_phase=cfg.num_orders_orig_phase,
            limit_contributions=cfg.limit_intensity_contributions,
            max_contribution=cfg.max_intensity_contribution,
        )
    dacc = DeviceMomentAccumulator(base=accumulator)
    n_bad = n_passes = 0
    t0 = time.time()
    for b in range(start_batch, cfg.num_batches):
        t = run_batch_sharded(domain, surface, source, cfg.iseed, b, kcfg,
                              mesh, icfg, idirs,
                              n_photons=cfg.num_photons_per_batch)
        n_bad += int(t.n_bad)
        n_passes += int(t.n_passes)
        dacc.add_tallies(t, domain.grid)
        if checkpoint_cb is not None and cfg.checkpoint_every_batches > 0 \
                and (b + 1) % cfg.checkpoint_every_batches == 0:
            checkpoint_cb(b + 1, dacc, chunk_size)
    acc = dacc.finalize()

    elapsed = time.time() - t0
    mean = {k: solar_flux * acc.mean(k) for k in acc._sum_wx}
    stderr = {k: solar_flux * acc.stderr(k) for k in acc._sum_wx}
    return Results(mean=mean, stderr=stderr,
                   total_photons=int(acc.total_weight),
                   n_batches=acc.n_batches,
                   solar_flux=solar_flux,
                   elapsed_seconds=elapsed,
                   config=cfg, n_bad=n_bad, n_passes=n_passes)
