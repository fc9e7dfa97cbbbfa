"""Command-line driver of the PyTorch port.

    python -m mcbrat3d_tpu_torch.driver.cli mkdomain step_cloud Step.dom ssa=0.99
    python -m mcbrat3d_tpu_torch.driver.cli run deck.nml [--device cuda]

Counterpart of ``mcbrat3d_tpu.driver.cli`` (reference:
Drivers/monteCarloDriver.f95:103-121,230-238) with the ``run`` and
``mkdomain step_cloud`` subcommands. ``--device`` defaults to ``cuda`` and
fails when no CUDA device is present; pass ``cpu`` to run the plain
PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def _resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available (pass --device cpu for the CPU path)")
    return dev


def _cmd_run(args) -> int:
    from mcbrat3d_tpu_torch.driver.config import load_config
    from mcbrat3d_tpu_torch.driver.simulate import simulate_from_config

    device = _resolve_device(args.device)
    cfg = load_config(args.namelist)
    results, written = simulate_from_config(cfg, device)
    print(json.dumps({
        "total_photons": results.total_photons,
        "n_batches": results.n_batches,
        "n_bad": results.n_bad,
        "mean_flux_up": float(results.mean["mean_flux_up"]),
        "mean_flux_down": float(results.mean["mean_flux_down"]),
        "mean_flux_absorbed": float(results.mean["mean_flux_absorbed"]),
        "elapsed_seconds": round(results.elapsed_seconds, 3),
        "device": str(device),
        "outputs": written,
    }))
    return 0


def _parse_params(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def _cmd_mkdomain(args) -> int:
    from mcbrat3d_tpu_torch.domain import io_netcdf
    from mcbrat3d_tpu_torch.scenes.step_cloud import step_cloud_scene

    scenes = {"step_cloud": step_cloud_scene}
    if args.scene not in scenes:
        print(f"unknown scene {args.scene!r}; available: {sorted(scenes)}")
        return 2
    grid, components, temps = scenes[args.scene](
        **_parse_params(args.params))
    io_netcdf.write_domain(args.output, grid, components, temps=temps)
    print(f"wrote {args.output}")
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
    p_dom.add_argument("scene", help="step_cloud")
    p_dom.add_argument("output")
    p_dom.add_argument("params", nargs="*", help="key=value overrides")
    p_dom.set_defaults(fn=_cmd_mkdomain)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
