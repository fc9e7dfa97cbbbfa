"""High-level simulation assembly: config -> domain -> run -> outputs.

PyTorch counterpart of ``mcbrat3d_tpu.driver.simulate``: the
monochromatic path (read domain, directional solar source, batches) and
the broadband path through ``spectral.broadband.run_broadband`` (shortwave
and longwave decks; reference: Drivers/monteCarloDriver.f95:289-505),
both resumed from and saved to the deck's checkpointFile. Under a process
group of more than one rank (``parallel.distributed``) each batch is spread
over the ranks (``mesh="auto"``, as the JAX package passes); rank 0 alone
writes the output files and the checkpoints, and the other ranks wait for
it (reference: MasterProc writes the outputs,
Drivers/monteCarloDriver.f95:1245-1301).
"""

from __future__ import annotations

import os
from typing import List, Tuple

from mcbrat3d_tpu_torch.domain import io_netcdf
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.driver import checkpoint as ckpt
from mcbrat3d_tpu_torch.driver import output as output_mod
from mcbrat3d_tpu_torch.driver.config import SimulationConfig
from mcbrat3d_tpu_torch.driver.run import Results, run_simulation
from mcbrat3d_tpu_torch.parallel import distributed
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination


def _checkpoint_hooks(cfg: SimulationConfig) -> dict:
    """The resume and periodic-save arguments of the run functions, from
    the namelist's checkpointFile and checkpointEveryBatches (the
    checkpoints the reference designed but disabled; reference:
    Drivers/monteCarloDriver.f95:127-134,753-801): an existing file is
    resumed from, and with checkpointEveryBatches > 0 the file is
    rewritten every that many batches."""
    if not cfg.checkpoint_file:
        return {}
    out: dict = {}
    if os.path.exists(cfg.checkpoint_file):
        next_batch, acc, chunk = ckpt.load_checkpoint(cfg.checkpoint_file,
                                                      with_meta=True)
        out["accumulator"] = acc
        out["start_batch"] = next_batch
        out["resume_chunk_size"] = chunk or None
        out["resume_ranks"] = ckpt.load_ranks(cfg.checkpoint_file) or None
    if cfg.checkpoint_every_batches > 0 and distributed.is_master():
        # mesh "auto": a batch is spread over every rank of the group
        out["checkpoint_cb"] = (
            lambda b, acc, chunk: ckpt.save_checkpoint(
                cfg.checkpoint_file, b, acc, chunk,
                n_ranks=distributed.world_size()))
    return out


def simulate_from_config(cfg: SimulationConfig,
                         device) -> Tuple[Results, List[str]]:
    if cfg.num_lambda > 1 or cfg.is_longwave:
        from mcbrat3d_tpu_torch.spectral.broadband import run_broadband
        results = run_broadband(cfg, device, mesh="auto",
                                **_checkpoint_hooks(cfg))
        return results, _write_outputs(results, results.grid)
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
                             solar_flux=cfg.solar_flux, mesh="auto",
                             **_checkpoint_hooks(cfg))
    results.grid = grid
    return results, _write_outputs(results, grid)


def _write_outputs(results: Results, grid) -> List[str]:
    """The output files, written by rank 0 alone (every rank holds the
    same results); the others wait until they are written."""
    written = (output_mod.write_all(results, grid)
               if distributed.is_master() else [])
    distributed.synchronize()
    return written
