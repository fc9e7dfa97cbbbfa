"""Command-line driver of the PyTorch port.

    python -m mcbrat3d_tpu_torch.driver.cli mkdomain step_cloud Step.dom ssa=0.99
    python -m mcbrat3d_tpu_torch.driver.cli run deck.nml [--device cuda]
    torchrun --nproc-per-node N -m mcbrat3d_tpu_torch.driver.cli run deck
    python -m mcbrat3d_tpu_torch.driver.cli mie|mkssp|physprops table.nml
    python -m mcbrat3d_tpu_torch.driver.cli optprops shdom.txt out.dom
    python -m mcbrat3d_tpu_torch.driver.cli rayleightrans common.nc
    python -m mcbrat3d_tpu_torch.driver.cli analyze results.nc

Counterpart of ``mcbrat3d_tpu.driver.cli`` (reference:
Drivers/monteCarloDriver.f95:103-121,230-238) with its subcommands: ``run``
a deck (``--device`` defaults to ``cuda`` and fails when no CUDA device is
present; pass ``cpu`` to run the plain PyTorch path; the deck's
``usePallas`` ('auto', 'on', 'off') chooses between the hand-written
kernels and the wave kernel, its ``checkpointFile`` resumes and saves;
under torchrun each rank joins one process group on its own card,
``cuda:LOCAL_RANK``, and every batch is spread over the ranks, rank 0
writing the files and the JSON line),
``mkdomain`` any scene of ``tools/scene_cli.py``, and the offline tool
suite of the reference's Tools/ executables: Mie tables, SSP tables,
physical- and optical-properties converters, the Rayleigh transmission
spectrum and the results summary.
"""

from __future__ import annotations

import argparse
import json
import sys

from mcbrat3d_tpu_torch.core.device import resolve


def _launches() -> dict:
    """Kernel launches of this process, per kernel, and the batches run on
    the wave kernel (plain PyTorch, ``KernelConfig.use_pallas``)."""
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import integrator
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk
    from mcbrat3d_tpu_torch.transport import tile_kernel as tk
    return {"record_kernel": rk.LAUNCHES,
            "record_kernel_radiance": rk.RADIANCE_LAUNCHES,
            "record_kernel_lw": rk.LW_LAUNCHES,
            "col_kernel": ck.COL_LAUNCHES,
            "col_kernel_radiance": ck.COL_LE_LAUNCHES,
            "sep_kernel": sk.SEP_LAUNCHES,
            "tile_kernel": tk.TILE_LAUNCHES,
            "wave_kernel_batches": integrator.WAVE_BATCHES}


def _cmd_run(args) -> int:
    from mcbrat3d_tpu_torch.driver.config import load_config
    from mcbrat3d_tpu_torch.driver.simulate import simulate_from_config
    from mcbrat3d_tpu_torch.parallel import distributed

    joined = distributed.is_initialized()
    try:
        device = (distributed.initialize(device=args.device)
                  or resolve(args.device))
        rank, world_size = distributed.rank(), distributed.world_size()
        cfg = load_config(args.namelist)
        results, written = simulate_from_config(cfg, device)
    finally:
        if not joined:  # leave only a group this command formed
            distributed.shutdown()
    if rank != 0:
        return 0
    radiance = {}
    for name in ("mean_intensity", "mean_flux_up_by_order",
                 "mean_flux_down_by_order"):
        if name in results.mean:
            radiance[name] = results.mean[name].tolist()
            radiance[name + "_stderr"] = results.stderr[name].tolist()
    print(json.dumps({
        "total_photons": results.total_photons,
        "n_batches": results.n_batches,
        "n_bad": results.n_bad,
        "mean_flux_up": float(results.mean["mean_flux_up"]),
        "mean_flux_down": float(results.mean["mean_flux_down"]),
        "mean_flux_absorbed": float(results.mean["mean_flux_absorbed"]),
        **radiance,
        "elapsed_seconds": round(results.elapsed_seconds, 3),
        "setup_seconds": round(results.setup_seconds, 3),
        "build_seconds": round(results.build_seconds, 3),
        "launches": _launches(),
        "tile_passes": results.n_passes,
        "device": str(device),
        "world_size": world_size,
        "outputs": written,
    }))
    return 0


def _cmd_mkdomain(args) -> int:
    from mcbrat3d_tpu_torch.tools import scene_cli
    return scene_cli.main(args.scene, args.output, args.params)


def _cmd_mie(args) -> int:
    from mcbrat3d_tpu_torch.tools import mie_table
    return mie_table.main(args.namelist)


def _cmd_mkssp(args) -> int:
    from mcbrat3d_tpu_torch.tools import ssp_create
    return ssp_create.main(args.namelist)


def _cmd_rayleightrans(args) -> int:
    from mcbrat3d_tpu_torch.tools import molec_scatt_trans
    molec_scatt_trans.main(args.common_domain, args.output,
                           lambda_start_um=args.lambda_start,
                           lambda_stop_um=args.lambda_stop,
                           n_lambda=args.n_lambda)
    print(f"wrote {args.output}")
    return 0


def _cmd_optprops(args) -> int:
    from mcbrat3d_tpu_torch.tools import optical_to_domain
    optical_to_domain.convert(args.input, args.output,
                              surface_albedo=args.surface_albedo)
    print(f"wrote {args.output}")
    return 0


def _cmd_physprops(args) -> int:
    from mcbrat3d_tpu_torch.driver.config import parse_namelist
    from mcbrat3d_tpu_torch.tools import physical_to_domain

    with open(args.namelist) as f:
        groups = parse_namelist(f.read())
    nml = {}
    for g in groups.values():
        nml.update(g)
    scat = nml.get("scattablefiles", [])
    if isinstance(scat, dict):
        scat = [scat[k] for k in sorted(scat)]
    if isinstance(scat, str):
        scat = [scat]
    physical_to_domain.convert(
        particle_file=nml["particlefilename"],
        scat_table_files=scat,
        output_file=nml.get("outputfilename", "domain.dom"),
        molec_abs_file=nml.get("molecabsfilename", ""),
        rayleigh_wavelen=nml.get("rayleighwavelength", 0.0),
        drop_num_conc=nml.get("dropnumconc", 100.0),
    )
    print(f"wrote {nml.get('outputfilename', 'domain.dom')}")
    return 0


def _cmd_analyze(args) -> int:
    from mcbrat3d_tpu_torch.tools.analyze_results import summarize
    for f in args.files:
        print(summarize(f))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mcbrat3d_tpu_torch",
        description="Monte Carlo radiative transfer (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run a simulation from a namelist file")
    p_run.add_argument("namelist")
    p_run.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda)")
    p_run.set_defaults(fn=_cmd_run)

    p_dom = sub.add_parser("mkdomain", help="generate a scene domain file")
    p_dom.add_argument("scene", help="step_cloud | plane_parallel | ...")
    p_dom.add_argument("output")
    p_dom.add_argument("params", nargs="*", help="key=value overrides")
    p_dom.set_defaults(fn=_cmd_mkdomain)

    p_mie = sub.add_parser("mie", help="build a Mie phase-function table")
    p_mie.add_argument("namelist")
    p_mie.set_defaults(fn=_cmd_mie)

    p_ssp = sub.add_parser("mkssp",
                           help="build a multi-wavelength SSP table")
    p_ssp.add_argument("namelist")
    p_ssp.set_defaults(fn=_cmd_mkssp)

    p_pp = sub.add_parser(
        "physprops",
        help="convert ASCII physical particle properties to a domain file")
    p_pp.add_argument("namelist")
    p_pp.set_defaults(fn=_cmd_physprops)

    p_mst = sub.add_parser(
        "rayleightrans",
        help="Rayleigh transmission spectrum from a common domain "
             "(molecScattTrans equivalent)")
    p_mst.add_argument("common_domain")
    p_mst.add_argument("-o", "--output", default="RayleighTrans.txt")
    p_mst.add_argument("--lambda-start", type=float, default=0.201)
    p_mst.add_argument("--lambda-stop", type=float, default=1.2)
    p_mst.add_argument("--n-lambda", type=int, default=1000)
    p_mst.set_defaults(fn=_cmd_rayleightrans)

    p_od = sub.add_parser(
        "optprops",
        help="convert SHDOM-style ASCII optical properties to a domain file")
    p_od.add_argument("input")
    p_od.add_argument("output")
    p_od.add_argument("--surface-albedo", type=float, default=0.0)
    p_od.set_defaults(fn=_cmd_optprops)

    p_an = sub.add_parser(
        "analyze",
        help="summarize results netCDF files (analysis-deck equivalent)")
    p_an.add_argument("files", nargs="+")
    p_an.set_defaults(fn=_cmd_analyze)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
