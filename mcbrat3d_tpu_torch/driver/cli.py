"""Command-line driver of the PyTorch port.

    python -m mcbrat3d_tpu_torch.driver.cli mkdomain step_cloud Step.dom ssa=0.99
    python -m mcbrat3d_tpu_torch.driver.cli mkdomain broken_cloud BrokenCloud.dom
    python -m mcbrat3d_tpu_torch.driver.cli run deck.nml [--device cuda]

Counterpart of ``mcbrat3d_tpu.driver.cli`` (reference:
Drivers/monteCarloDriver.f95:103-121,230-238) with the ``run`` and
``mkdomain step_cloud|broken_cloud`` subcommands. ``--device`` defaults to ``cuda`` and
fails when no CUDA device is present; pass ``cpu`` to run the plain
PyTorch path. The deck's ``usePallas`` ('auto', 'on', 'off') chooses
between the hand-written kernels and the wave kernel.
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

    device = resolve(args.device)
    cfg = load_config(args.namelist)
    results, written = simulate_from_config(cfg, device)
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
    from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene
    from mcbrat3d_tpu_torch.scenes.step_cloud import step_cloud_scene

    scenes = {"step_cloud": step_cloud_scene,
              "broken_cloud": broken_cloud_scene}
    if args.scene not in scenes:
        print(f"unknown scene {args.scene!r}; available: {sorted(scenes)}")
        return 2
    # the scene is only written to the file: build it on the host
    grid, components, temps = scenes[args.scene](
        **{"device": "cpu", **_parse_params(args.params)})
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
    p_dom.add_argument("scene", help="step_cloud or broken_cloud")
    p_dom.add_argument("output")
    p_dom.add_argument("params", nargs="*", help="key=value overrides")
    p_dom.set_defaults(fn=_cmd_mkdomain)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
