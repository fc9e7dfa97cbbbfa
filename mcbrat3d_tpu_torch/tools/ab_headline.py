#!/usr/bin/env python3
"""A/B of the record kernel's flux headline between two checkouts, on one
card, in turns: A, B, B, A.

    python3 mcbrat3d_tpu_torch/tools/ab_headline.py A_ROOT B_ROOT

Each turn runs ``python3 chip_smoke.py --only 4`` from that checkout's root
in its own process (so each builds its own kernels into its own
``build/torch_kernels/``) and reads the ``headline kernel:`` line (a
batch of 2^26 photons through run_batch_record_tallies) and the
``headline plain first launch:`` line (the plain twin's first launch of
the refill schedule). Prints one line per turn and, last, a JSON object
with the card (nvidia-smi name and power limit) and every turn's
photons/s and ms per launch. Exits non-zero if a turn fails, and refuses
a checkout whose chip_smoke.py prints the older ``headline plain:`` line
(the plain batch on JAX's geometry, not the same quantity).
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

LINE = re.compile(r"headline (kernel|plain first launch): (\d+) photons in "
                  r"([\d.]+) s = ([\d.e+]+) photons/s, (\d+) launches, "
                  r"([\d.]+) ms/launch")
OLD_PLAIN = re.compile(r"^headline plain: ", re.M)


def turn(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--only", "4"],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: chip_smoke.py --only 4 failed:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    if OLD_PLAIN.search(proc.stdout):
        raise RuntimeError(f"{root}: its headline plain line is the plain "
                           "batch on JAX's geometry, not comparable")
    out = {}
    for m in LINE.finditer(proc.stdout):
        out[m.group(1).split()[0]] = dict(
            photons_per_s=float(m.group(4)), ms_per_launch=float(m.group(6)),
            launches=int(m.group(5)))
    if set(out) != {"kernel", "plain"}:
        raise RuntimeError(f"{root}: no headline lines in\n{proc.stdout}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a_root", type=Path)
    ap.add_argument("b_root", type=Path)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    turns = []
    for label, root in (("A", args.a_root), ("B", args.b_root),
                        ("B", args.b_root), ("A", args.a_root)):
        res = turn(root.resolve())
        turns.append(dict(label=label, root=str(root), **res))
        print(f"{label} {root}: kernel "
              f"{res['kernel']['photons_per_s']:.6g} photons/s "
              f"({res['kernel']['ms_per_launch']:.4f} ms/launch), plain "
              f"{res['plain']['ms_per_launch']:.1f} ms/launch", flush=True)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
