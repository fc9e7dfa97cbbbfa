"""Broadband simulation driver (PyTorch port).

Counterpart of ``mcbrat3d_tpu.spectral.broadband.run_broadband``
(reference: Drivers/monteCarloDriver.f95:289-505 setup, :889-1129 worker
loop):

  SW: the solar spectral CDF (``solar_weighting`` of the namelist's solar
      source file) -> a seeded multinomial photon schedule over bins -> per
      bin a domain and the directional solar beam;
  LW: the per-bin emitted flux -> spectral flux CDF over bins -> the same
      schedule -> per bin a domain and the thermal emission source with the
      lw_mode pre-credits;

an instrument response file (SRF) weights either CDF. Each bin runs in
chunks of ``numPhotonsPerBatch``, moments accumulated on the device. Per
bin, as the JAX package decides:

  * past the record kernel's ``MAX_CELLS``, when the lambda-independent
    factorization of the physical fields (``domain.sep_plan``) exists and
    its first bin runs on the separable kernel (K4): O(nz) compact
    rebuilds from the plan (and, LW, the separable emission source);
  * otherwise the generic build (``components_from_ssp``,
    ``build_domain(temps=...)`` and, LW, ``absorption_coefficient``,
    ``emission_weighting`` and the per-voxel emission source), which the
    record kernel (K1) runs within its envelope and the wave kernel
    beyond every kernel's; once a bin is seen to run on K4 the later bins
    switch to compact builds. A vacuum bin of a plan falls back to the
    generic build for that bin only.

With ``usePallas = 'off'`` there is no plan and every bin runs on the wave
kernel, as in the JAX package. Batch b of the run (counted over all bins)
runs with the kernel seed ``rng.batch_seed(iseed, b)`` and the wave
kernel's key ``rng.batch_key(iseed, b)``, the JAX package's. Not ported
yet: the device mesh; a deck with checkpoints raises in
``driver.simulate.simulate_from_config`` before it gets here.
"""

from __future__ import annotations

import time

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.accumulate import (DeviceMomentAccumulator,
                                                kahan_cumsum)
from mcbrat3d_tpu_torch.domain.common import read_common
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.domain.sep_plan import (build_domain_from_plan,
                                                make_separable_bin_plan)
from mcbrat3d_tpu_torch.domain.ssp import components_from_ssp, read_ssp_table
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.driver.run import Results, kernel_config_from
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import solar as solar_io
from mcbrat3d_tpu_torch.spectral.weights import (absorption_coefficient,
                                                 emission_weighting,
                                                 frequency_distribution,
                                                 lambda_widths,
                                                 lw_setup_fluxes,
                                                 solar_weighting)
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport import sep_kernel as sk
from mcbrat3d_tpu_torch.transport.integrator import (run_batch,
                                                      select_kernel)
from mcbrat3d_tpu_torch.transport.local_estimate import (
    IntensityConfig, make_intensity_directions)


def _bin_surface(cfg: SimulationConfig, albedo: float) -> Surface:
    return Surface.lambertian(albedo, temperature=cfg.surface_temp,
                              emissivity=1.0 - albedo)


def _plan_is_separable(plan, grid, ssp_tables, freq, cfg, kcfg, icfg):
    """The plan probe (broadband.py:218-253 of the JAX package), run only
    past the record kernel's ``MAX_CELLS``: does the first bin with
    photons, built from the plan, run on the separable kernel (with the
    separable emission source, or the solar beam)? Then every bin is built
    compact from the plan, skipping the full-domain build and the
    per-voxel emission weighting."""
    nx, ny, nz = grid.shape
    li0 = next((int(li) for li in range(freq.size) if freq[li] > 0), None)
    if plan is None or nx * ny * nz <= rk.MAX_CELLS or li0 is None:
        return False
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
        src0 = (illumination.emission_separable(d0, cfg.surface_temp,
                                                1.0 - alb0)
                if cfg.is_longwave else
                illumination.directional(cfg.solar_mu, cfg.solar_azimuth))
    except ValueError:  # no emission tables (non-uniform temps)
        return False
    return not sk.sep_ineligibility_reasons(
        d0, _bin_surface(cfg, alb0), src0,
        need_volume_absorption=kcfg.need_volume_absorption,
        lw_mode=kcfg.lw_mode, compute_intensity=icfg is not None,
        record_scattering_orders=kcfg.record_scattering_orders,
        use_ray_tracing=kcfg.use_ray_tracing)


def run_broadband(cfg: SimulationConfig, device, common=None,
                  ssp_tables=None) -> Results:
    """Broadband run on ``device``, shortwave or longwave as the namelist
    says; ``common`` and ``ssp_tables`` default to the namelist's files.
    Returns the finalized ``Results`` (means scaled by the total incident
    or emitted flux), with ``grid``, ``n_bad``, the seconds spent before
    the first bin's transport (``setup_seconds``) and those spent building
    the later bins' domains and sources on the host
    (``build_seconds``)."""
    t_start = time.time()
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
    srf = None
    if cfg.instr_response_file:
        srf = solar_io.read_spectral_response(cfg.instr_response_file,
                                              n_lambda)

    # lambda-independent factorization of the physical fields (None on
    # structures the separable kernel cannot carry, and with usePallas =
    # 'off'): with it, per-bin rebuilds are O(nz) and the setup Planck
    # sweep factorizes too
    plan = None
    if cfg.use_pallas != "off":
        plan = make_separable_bin_plan(common, ssp_tables,
                                       cfg.calc_rayleigh, cfg.macro_factor)

    if cfg.is_longwave:
        # setup pass: per-lambda total emitted flux (atmosphere + surface)
        # (reference: Drivers/monteCarloDriver.f95:304-450)
        fluxes = lw_setup_fluxes(common, ssp_tables, d_lambda,
                                 cfg.surface_temp, plan=plan)
        if srf is not None:
            fluxes = fluxes * srf
        cdf = kahan_cumsum(fluxes)
        total_flux = float(cdf[-1])
        cdf = cdf / total_flux
    else:
        lam_file, solar = solar_io.read_solar_source(cfg.solar_source_file,
                                                     n_lambda)
        cdf, total_flux = solar_weighting(lam_file, solar, cfg.solar_mu,
                                          srf=srf)

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
    # bins start generic; compact once the separable kernel is known to
    # run them (the plan probe past MAX_CELLS, or a bin that dispatched)
    compact = _plan_is_separable(plan, grid, ssp_tables, freq, cfg, kcfg,
                                 icfg)

    hybrid_width = (cfg.hybrid_phase_fun_width
                    if cfg.use_hybrid_phase_funs else 0.0)
    acc = DeviceMomentAccumulator()
    global_batch = n_bad = 0
    setup_seconds = None
    build_seconds = 0.0
    for li in range(n_lambda):
        if freq[li] <= 0:
            continue
        t_bin = time.time()
        lam_um = float(ssp_tables[0].lambdas_um[li])
        albedo = float(ssp_tables[0].surface_albedo[li])
        domain = None
        bin_compact = compact
        if compact and plan is not None:
            domain = build_domain_from_plan(
                grid, plan, li, lam_um, n_cdf_steps=cfg.n_phase_intervals,
                compute_intensity_tables=cfg.compute_intensity,
                hybrid_width_deg=hybrid_width)
            # a vacuum slab: the generic build for this bin only
            bin_compact = domain is not None
        if domain is None:
            comps, albedo, lam_um = components_from_ssp(
                common, ssp_tables, li, setup=False,
                calc_rayleigh=cfg.calc_rayleigh)
            build = dict(n_cdf_steps=cfg.n_phase_intervals,
                         compute_intensity_tables=cfg.compute_intensity,
                         hybrid_width_deg=hybrid_width, temps=common.temps,
                         macro_factor=cfg.macro_factor, lambda_um=lam_um)
            if bin_compact:
                try:
                    domain = build_domain(grid, comps,
                                          device_fields="compact", **build)
                except ValueError:  # this bin broke the separable structure
                    bin_compact = False
                    if plan is None:
                        compact = False
            if domain is None:
                domain = build_domain(grid, comps, **build)
        surface = _bin_surface(cfg, albedo)
        if not cfg.is_longwave:
            source = illumination.directional(cfg.solar_mu,
                                              cfg.solar_azimuth)
        elif bin_compact:
            source = illumination.emission_separable(domain, cfg.surface_temp,
                                                     1.0 - albedo)
        else:
            w = emission_weighting(grid, common.temps,
                                   absorption_coefficient(comps, grid),
                                   cfg.surface_temp, 1.0 - albedo, lam_um)
            source = illumination.emission(w.voxel_cdf, w.frac_atms_power,
                                           grid.shape, device=device)
        if not compact and kcfg.use_pallas != "off":
            # this bin runs on the separable kernel: so will the later ones
            # (broadband.py:66-94 of the JAX package)
            compact = select_kernel(domain, surface, source, kcfg, icfg,
                                    idirs)[0] == "sep"
        if setup_seconds is None:
            setup_seconds = time.time() - t_start
        else:
            build_seconds += time.time() - t_bin
        remaining = int(freq[li])
        while remaining > 0:
            n = min(remaining, chunk_size)
            t = run_batch(domain, surface, source,
                          rng.batch_seed(cfg.iseed, global_batch), kcfg,
                          n_photons=n, intensity_config=icfg,
                          intensity_dirs=idirs,
                          key=rng.batch_key(cfg.iseed, global_batch))
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
                   setup_seconds=(setup_seconds or 0.0),
                   build_seconds=build_seconds)
