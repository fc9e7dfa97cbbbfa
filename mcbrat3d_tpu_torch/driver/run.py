"""Batch-loop driver: runs batches, accumulates moments, finalizes results.

PyTorch counterpart of ``mcbrat3d_tpu.driver.run`` for one device
(reference: Drivers/monteCarloDriver.f95:889-1228): per batch the
per-photon-normalized tallies are accumulated as photon-weighted first and
second moments; the mean is scaled by the incident flux and the standard
error is sqrt(max(0, E[x^2] - E[x]^2)/(nBatches - 1)). Batch b runs with
the kernel seed ``rng.batch_seed(iseed, b)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.accumulate import MomentAccumulator
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch


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
    )


def run_simulation(domain: OpticalDomain,
                   surface: Surface,
                   source: illumination.Source,
                   cfg: SimulationConfig,
                   solar_flux: float = 1.0) -> Results:
    """Run cfg.num_batches batches on the domain's device and return
    finalized statistics. ``solar_flux`` scales all outputs (reference:
    Drivers/monteCarloDriver.f95:1188-1228)."""
    if cfg.compute_intensity:
        raise NotImplementedError(
            "radiance (intensity directions) is not in the PyTorch port yet")
    kcfg = kernel_config_from(cfg)
    acc = MomentAccumulator()
    n_bad = 0
    t0 = time.time()
    for b in range(cfg.num_batches):
        t = run_batch(domain, surface, source, rng.batch_seed(cfg.iseed, b),
                      kcfg, n_photons=cfg.num_photons_per_batch)
        n_bad += int(t.n_bad)
        t = t.normalized(domain.grid)
        arrays = {
            "flux_up": t.flux_up.cpu().numpy(),
            "flux_down": t.flux_down.cpu().numpy(),
            "flux_absorbed": t.flux_absorbed.cpu().numpy(),
        }
        if t.volume_absorption is not None:
            arrays["volume_absorption"] = t.volume_absorption.cpu().numpy()
        # domain means + horizontally averaged absorption profile
        # (reference: Integrators/monteCarloRadiativeTransfer.f95:845-1042)
        arrays["mean_flux_up"] = arrays["flux_up"].mean()
        arrays["mean_flux_down"] = arrays["flux_down"].mean()
        arrays["mean_flux_absorbed"] = arrays["flux_absorbed"].mean()
        if t.volume_absorption is not None:
            arrays["absorption_profile"] = arrays[
                "volume_absorption"].mean(axis=(0, 1))
        acc.add(float(t.n_photons), arrays)

    elapsed = time.time() - t0
    mean = {k: solar_flux * acc.mean(k) for k in acc._sum_wx}
    stderr = {k: solar_flux * acc.stderr(k) for k in acc._sum_wx}
    return Results(mean=mean, stderr=stderr,
                   total_photons=int(acc.total_weight),
                   n_batches=acc.n_batches,
                   solar_flux=solar_flux,
                   elapsed_seconds=elapsed,
                   config=cfg, n_bad=n_bad)
