"""High-level simulation assembly: config -> domain -> run -> outputs.

PyTorch counterpart of ``mcbrat3d_tpu.driver.simulate``: the
monochromatic path (read domain, directional solar source, batches) and
the broadband path through ``spectral.broadband.run_broadband`` (shortwave
and longwave decks; reference: Drivers/monteCarloDriver.f95:289-505).
"""

from __future__ import annotations

from typing import List, Tuple

from mcbrat3d_tpu_torch.domain import io_netcdf
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.driver import output as output_mod
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.driver.run import Results, run_simulation
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination


def simulate_from_config(cfg: SimulationConfig,
                         device) -> Tuple[Results, List[str]]:
    if cfg.checkpoint_file:
        # JAX saves and resumes here (mcbrat3d_tpu/driver/simulate.py
        # :25-47); a deck that asks for it must not run without it
        raise NotImplementedError(
            f"checkpointFile = {cfg.checkpoint_file!r}: checkpoints (save "
            "and resume) are not in the PyTorch port yet (ROADMAP Queue 1 "
            "item 8)")
    if cfg.num_lambda > 1 or cfg.is_longwave:
        from mcbrat3d_tpu_torch.spectral.broadband import run_broadband
        results = run_broadband(cfg, device)
        written = output_mod.write_all(results, results.grid)
        return results, written
    if not cfg.domain_file:
        raise ValueError("monochromatic runs need domainFileName")
    grid, components, temps, attrs = io_netcdf.read_domain(cfg.domain_file,
                                                           device=device)
    domain = build_domain(
        grid, components,
        n_cdf_steps=cfg.n_phase_intervals,
        compute_intensity_tables=cfg.compute_intensity,
        hybrid_width_deg=(cfg.hybrid_phase_fun_width
                          if cfg.use_hybrid_phase_funs else 0.0),
        temps=temps,
        macro_factor=cfg.macro_factor,
        lambda_um=attrs.get("lambda_um", 0.0))
    surface = Surface.lambertian(attrs.get("surface_albedo", 0.0))
    source = illumination.directional(cfg.solar_mu, cfg.solar_azimuth)
    # monochromatic runs take solarFlux from the namelist, default 1.0
    # (reference: Drivers/OLDmonteCarloDriver.f95:56,98)
    results = run_simulation(domain, surface, source, cfg,
                             solar_flux=cfg.solar_flux)
    results.grid = grid
    written = output_mod.write_all(results, grid)
    return results, written
