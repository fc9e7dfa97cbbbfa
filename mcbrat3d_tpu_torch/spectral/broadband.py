"""Broadband longwave simulation driver (PyTorch port).

Counterpart of ``mcbrat3d_tpu.spectral.broadband.run_broadband`` for the
longwave path whose bins are separable (reference:
Drivers/monteCarloDriver.f95:289-505 setup, :889-1129 worker loop):

  LW: the lambda-independent factorization of the physical fields
      (``domain.sep_plan``), the per-bin emitted flux through it ->
      spectral flux CDF over bins -> a seeded multinomial photon schedule
      -> per bin an O(nz) compact domain rebuild, the separable emission
      source and transport through the separable kernel (K4) in chunks of
      ``numPhotonsPerBatch``, moments accumulated on the device.

Batch b of the run (counted over all bins) runs with the kernel seed
``rng.batch_seed(iseed, b)``, the counterpart of the JAX package's
``rng.batch_key(iseed, b)``. Not ported yet, each raising
NotImplementedError: the shortwave path (``solar_weighting``,
``spectral/solar.py``), bins without a separable plan (they need the record
kernel's emission envelope or the XLA wave kernel), an instrument response
file, the device mesh and checkpoints.
"""

from __future__ import annotations

import time

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.accumulate import (DeviceMomentAccumulator,
                                                kahan_cumsum)
from mcbrat3d_tpu_torch.domain.common import read_common
from mcbrat3d_tpu_torch.domain.sep_plan import (build_domain_from_plan,
                                                make_separable_bin_plan)
from mcbrat3d_tpu_torch.domain.ssp import read_ssp_table
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.driver.run import Results, kernel_config_from
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral.weights import (frequency_distribution,
                                                 lambda_widths,
                                                 lw_setup_fluxes)
from mcbrat3d_tpu_torch.transport.integrator import run_batch
from mcbrat3d_tpu_torch.transport.local_estimate import (
    IntensityConfig, make_intensity_directions)

_NON_PLAN = ("the generic per-bin build with a per-voxel emission source, "
             "which runs on the record kernel's emission envelope (K1) or "
             "the XLA wave kernel, neither ported yet")


def _bin_surface(cfg: SimulationConfig, albedo: float) -> Surface:
    return Surface.lambertian(albedo, temperature=cfg.surface_temp,
                              emissivity=1.0 - albedo)


def _plan_is_separable(plan, grid, ssp_tables, freq, cfg, kcfg, icfg):
    """The plan probe (broadband.py:218-253 of the JAX package): does the
    first bin with photons, built from the plan, run on the separable
    kernel? The port takes the plan path at any cell count: its record
    kernel has no emission source."""
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk

    li0 = next((int(li) for li in range(freq.size) if freq[li] > 0), None)
    if li0 is None:
        return True
    d0 = build_domain_from_plan(
        grid, plan, li0, float(ssp_tables[0].lambdas_um[li0]),
        n_cdf_steps=cfg.n_phase_intervals,
        compute_intensity_tables=cfg.compute_intensity,
        hybrid_width_deg=(cfg.hybrid_phase_fun_width
                          if cfg.use_hybrid_phase_funs else 0.0))
    if d0 is None:
        return False
    alb0 = float(ssp_tables[0].surface_albedo[li0])
    try:
        src0 = illumination.emission_separable(d0, cfg.surface_temp,
                                               1.0 - alb0)
    except ValueError:  # no emission tables (non-uniform temps)
        return False
    return not sk.sep_ineligibility_reasons(
        d0, _bin_surface(cfg, alb0), src0, lw_mode=kcfg.lw_mode,
        compute_intensity=icfg is not None,
        record_scattering_orders=kcfg.record_scattering_orders,
        use_ray_tracing=kcfg.use_ray_tracing,
        need_volume_absorption=kcfg.need_volume_absorption)


def run_broadband(cfg: SimulationConfig, device, common=None,
                  ssp_tables=None) -> Results:
    """Broadband longwave run on ``device``; ``common`` and ``ssp_tables``
    default to the namelist's files. Returns the finalized ``Results``
    (means scaled by the total emitted flux), with ``grid``, ``n_bad`` and
    the seconds spent before the first bin's transport
    (``setup_seconds``)."""
    t_start = time.time()
    if not cfg.is_longwave:
        raise NotImplementedError(
            "shortwave broadband runs (solar_weighting, spectral/solar.py) "
            "are not in the PyTorch port yet")
    if cfg.instr_response_file:
        raise NotImplementedError(
            "an instrument response file (spectral/solar.py) is not in the "
            "PyTorch port yet")
    if common is None:
        common = read_common(cfg.phys_domain_file, device=device)
    if ssp_tables is None:
        ssp_tables = [read_ssp_table(f) for f in cfg.ssp_file_names if f]
    if not ssp_tables:
        raise ValueError("broadband runs need at least one SSP table")
    grid = common.grid
    lambdas = ssp_tables[0].lambdas_um
    n_lambda = cfg.num_lambda or lambdas.size
    if n_lambda != lambdas.size:
        raise ValueError(f"namelist numLambda={n_lambda} but SSP tables have "
                         f"{lambdas.size} wavelengths")
    d_lambda = lambda_widths(lambdas)

    # lambda-independent factorization of the physical fields: per-bin
    # rebuilds are O(nz) and the setup Planck sweep factorizes too
    plan = make_separable_bin_plan(common, ssp_tables, cfg.calc_rayleigh,
                                   cfg.macro_factor)
    if plan is None:
        raise NotImplementedError(
            "this broadband deck has no separable per-bin plan (rank-1 "
            "massConc, one Reff cell, horizontally uniform gas and temps, "
            "no Rayleigh); its bins need " + _NON_PLAN)

    # setup pass: per-lambda total emitted flux (atmosphere + surface)
    # (reference: Drivers/monteCarloDriver.f95:304-450)
    fluxes = lw_setup_fluxes(common, ssp_tables, d_lambda, cfg.surface_temp,
                             plan=plan)
    cdf = kahan_cumsum(fluxes)
    total_flux = float(cdf[-1])
    cdf = cdf / total_flux

    # static photon schedule
    total_photons = cfg.num_photons_per_batch * cfg.num_batches
    freq = frequency_distribution(cdf, total_photons, seed=cfg.iseed)

    kcfg = kernel_config_from(cfg)
    chunk_size = kcfg.photons_per_batch
    icfg = idirs = None
    if cfg.compute_intensity:
        mus, phis = cfg.radiance_directions()
        idirs = make_intensity_directions(mus, phis, device=device)
        icfg = IntensityConfig(
            n_dirs=int(mus.size),
            use_russian_roulette=cfg.use_russian_roulette_intensity,
            zeta_min=cfg.zeta_min,
            use_hybrid_phase=cfg.use_hybrid_phase_funs,
            n_orders_orig_phase=cfg.num_orders_orig_phase,
            limit_contributions=cfg.limit_intensity_contributions,
            max_contribution=cfg.max_intensity_contribution)
    if not _plan_is_separable(plan, grid, ssp_tables, freq, cfg, kcfg, icfg):
        raise NotImplementedError(
            "the separable kernel does not take this deck's plan-built bins "
            "(see sep_kernel.sep_ineligibility_reasons); they need "
            + _NON_PLAN)

    hybrid_width = (cfg.hybrid_phase_fun_width
                    if cfg.use_hybrid_phase_funs else 0.0)
    acc = DeviceMomentAccumulator()
    global_batch = n_bad = 0
    setup_seconds = None
    for li in range(n_lambda):
        if freq[li] <= 0:
            continue
        lam_um = float(ssp_tables[0].lambdas_um[li])
        albedo = float(ssp_tables[0].surface_albedo[li])
        domain = build_domain_from_plan(
            grid, plan, li, lam_um, n_cdf_steps=cfg.n_phase_intervals,
            compute_intensity_tables=cfg.compute_intensity,
            hybrid_width_deg=hybrid_width)
        if domain is None:
            raise NotImplementedError(
                f"bin {li} ({lam_um:.4g} um) is a vacuum slab; it needs "
                + _NON_PLAN)
        surface = _bin_surface(cfg, albedo)
        source = illumination.emission_separable(domain, cfg.surface_temp,
                                                 1.0 - albedo)
        if setup_seconds is None:
            setup_seconds = time.time() - t_start
        remaining = int(freq[li])
        while remaining > 0:
            n = min(remaining, chunk_size)
            t = run_batch(domain, surface, source,
                          rng.batch_seed(cfg.iseed, global_batch), kcfg,
                          n_photons=n, intensity_config=icfg,
                          intensity_dirs=idirs)
            n_bad += int(t.n_bad)
            acc.add_tallies(t, grid)
            remaining -= n
            global_batch += 1

    moments = acc.finalize()  # the loop's only fetch of the moments
    mean = {k: total_flux * moments.mean(k) for k in moments._sum_wx}
    stderr = {k: total_flux * moments.stderr(k) for k in moments._sum_wx}
    return Results(mean=mean, stderr=stderr,
                   total_photons=int(round(moments.total_weight)),
                   n_batches=moments.n_batches, solar_flux=total_flux,
                   elapsed_seconds=time.time() - t_start, config=cfg,
                   grid=grid, n_bad=n_bad,
                   setup_seconds=(setup_seconds or 0.0))
