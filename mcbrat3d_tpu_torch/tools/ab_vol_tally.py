#!/usr/bin/env python3
"""A/B of the record kernel's 3D-tally launches between two checkouts, on
one card, in turns: A, B, B, A.

    python3 mcbrat3d_tpu_torch/tools/ab_vol_tally.py A_ROOT B_ROOT

Each turn runs in its own process from that checkout's root, imports that
checkout's package (so each builds its own record kernel into its own
``build/torch_kernels/``) and times, with the phase functions of the
``chip_smoke.py`` beside this script (the same measurement code for both
checkouts): the LW emission headline (bench.py:173-218, K1-c with the 3D
tally, chip_smoke 4g), radar_scale with the 3D tally (bench.py:269-303),
the 3-component headline (bench.py:150-170, the 3D tally on the 1,024-cell
step cloud, chip_smoke 4f) and the flux headline (the column tally,
chip_smoke 4), the control, each on the refill schedule (so both
checkouts' record kernels take ``run_batch_record_tallies(rcfg=)``).
Prints
one line per turn and, last, a JSON object with the card (nvidia-smi name
and power limit) and every turn's numbers. Exits non-zero if a turn fails.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve()
SMOKE = HERE.parents[2] / "chip_smoke.py"


def measure(root: Path) -> dict:
    """One turn, in this process: the checkout at ``root``'s package timed
    by this repository's chip_smoke phase functions."""
    sys.path.insert(0, str(root))
    from mcbrat3d_tpu_torch.core import planck, rng
    from mcbrat3d_tpu_torch.core.grid import Grid
    from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent,
                                                  build_domain)
    from mcbrat3d_tpu_torch.physics.phase_function import (
        PhaseFunction, PhaseFunctionTable)
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.scenes.step_cloud import (make_step_cloud,
                                                      make_step_cloud_multi)
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.spectral import weights
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

    if not Path(rk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {rk.__file__}, not {root}'s package")
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m = types.SimpleNamespace(
        Grid=Grid, OpticalComponent=OpticalComponent,
        PhaseFunction=PhaseFunction, PhaseFunctionTable=PhaseFunctionTable,
        build_domain=build_domain, weights=weights,
        illumination=illumination, Surface=Surface, planck=planck,
        make_step_cloud=make_step_cloud)
    runs = dict(
        lw_emission=cs.phase_lw_headline(rk, m, KernelConfig, rng),
        radar_scale=cs.phase_radar_headline(rk, m, KernelConfig, rng),
        multi3=cs.phase_multi_headline(rk, make_step_cloud_multi, Surface,
                                       illumination, KernelConfig, rng),
        flux=cs.phase_headline(rk, make_step_cloud, Surface, illumination,
                               KernelConfig, rng))
    out = {name: dict(ms_per_launch=r["kernel_ms_per_launch"],
                      photons_per_s=r["photons_per_s"], busy=r["busy"],
                      launches=r["launches_per_batch"])
           for name, r in runs.items()}
    out["occupancy"] = cs.vol_tally_occupancy(rk, m)
    return out


def turn(root: Path) -> dict:
    proc = subprocess.run([sys.executable, str(HERE), "--turn", str(root)],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: turn failed:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a_root", type=Path, nargs="?")
    ap.add_argument("b_root", type=Path, nargs="?")
    ap.add_argument("--turn", type=Path,
                    help="run one turn in this process for this checkout")
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(measure(args.turn.resolve())))
        return 0
    if args.a_root is None or args.b_root is None:
        ap.error("give A_ROOT and B_ROOT")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    turns = []
    for label, root in (("A", args.a_root), ("B", args.b_root),
                        ("B", args.b_root), ("A", args.a_root)):
        res = turn(root.resolve())
        turns.append(dict(label=label, root=str(root), **res))
        print(f"{label} {root}: LW emission "
              f"{res['lw_emission']['ms_per_launch']:.4f} ms/launch, "
              f"radar_scale {res['radar_scale']['ms_per_launch']:.4f} "
              f"ms/launch, 3-component "
              f"{res['multi3']['ms_per_launch']:.4f} ms/launch, flux "
              f"{res['flux']['ms_per_launch']:.4f} "
              f"ms/launch", flush=True)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
