"""Batch-loop driver: runs batches, accumulates moments, finalizes results.

PyTorch counterpart of ``mcbrat3d_tpu.driver.run`` for one device
(reference: Drivers/monteCarloDriver.f95:889-1228): per batch the
per-photon-normalized tallies are accumulated as photon-weighted first and
second moments on the domain's device (``DeviceMomentAccumulator``, the
layout the broadband loop uses too; one host fetch at the end); the mean
is scaled by the incident flux and the standard error is
sqrt(max(0, E[x^2] - E[x]^2)/(nBatches - 1)). Batch b runs with the kernel
seed ``rng.batch_seed(iseed, b)`` and the wave kernel's threefry key
``rng.batch_key(iseed, b)`` (the JAX package's, so a deck with usePallas =
'off' follows its paths). Decks with radiance directions also
accumulate the top-of-domain radiance image and its
per-direction domain mean, decks with numRecScatOrd the boundary fluxes by
scattering order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.accumulate import DeviceMomentAccumulator
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch
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


def kernel_config_from(cfg: SimulationConfig) -> KernelConfig:
    """Kernel config for one device; the exact n_photons clamp honors
    numPhotonsPerBatch when it is not a multiple of the lane count."""
    per_dev = max(1, cfg.num_photons_per_batch)
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
                   solar_flux: float = 1.0) -> Results:
    """Run cfg.num_batches batches on the domain's device and return
    finalized statistics. ``solar_flux`` scales all outputs (reference:
    Drivers/monteCarloDriver.f95:1188-1228)."""
    kcfg = kernel_config_from(cfg)
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
    dacc = DeviceMomentAccumulator()
    n_bad = n_passes = 0
    t0 = time.time()
    for b in range(cfg.num_batches):
        t = run_batch(domain, surface, source, rng.batch_seed(cfg.iseed, b),
                      kcfg, n_photons=cfg.num_photons_per_batch,
                      intensity_config=icfg, intensity_dirs=idirs,
                      key=rng.batch_key(cfg.iseed, b))
        n_bad += int(t.n_bad)
        n_passes += int(t.n_passes)
        dacc.add_tallies(t, domain.grid)
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
