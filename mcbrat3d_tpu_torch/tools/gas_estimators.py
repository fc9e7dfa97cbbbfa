#!/usr/bin/env python3
"""The full-width gas template's radiance at mu 0.4 through the port's two
estimators, in one process on one card: the column kernel's local
estimate (K3-d, the JAX package's column kernel photon for photon) and the
wave kernel's (the JAX package's XLA estimator, path for path), with the
same photons each.

    python3 -m mcbrat3d_tpu_torch.tools.gas_estimators [--seconds 420]
        [--photons 131072] [--device cuda] [--out PATH] [--resume FILE]
    python3 -m mcbrat3d_tpu_torch.tools.gas_estimators --summarize FILE

The scene is chip_smoke.py 3i's at full width: ``broken_cloud_scene()``
(128 x 128 x 64)
plus a horizontally uniform pure absorber q(z) = 2.5e-4 m^-1 exp(-z /
2000 m), albedo 0.2, the beam at mu 0.5, Iwabuchi roulette and the hybrid
phase switch as in 3i's radiance run (an all-HG domain without tables,
so both estimators take the analytic phase value), and one detector
direction: mu 0.4, phi 330 degrees (3i's directions 7 and 15). Batches of
``--photons`` photons run in turns, column kernel then wave kernel, the
column kernel on 3i's geometry (8,192 lanes) and the wave kernel on
131,072 lanes, both with max_steps 400,000, until the wave kernel has
spent ``--seconds`` (at least one pair, and two in all). Prints a JSON
line per batch (the domain-mean radiance, R/T/A, n_bad, steps and
seconds) and, last, the summary: each estimator's mean and standard error
over its batches, the gap in combined sigma, the card (nvidia-smi name
and power limit) and the seconds; the batch lines and the summary also go
to ``--out`` (default build/gas_estimators.jsonl). With a few batches the
standard errors are themselves uncertain, so each gap (K3 - wave, and
each estimator against the JAX package's XLA value, ``JAX_XLA``) also
comes as Welch's t: the statistic, its Welch-Satterthwaite degrees of
freedom, the two-sided p and the 95% interval of the gap. ``--resume
FILE`` takes the batch lines of an earlier run (of the same batch size)
into the summary and goes on with the next batch numbers, so a long
comparison can be spread over calls; ``--summarize FILE`` prints the
summary of FILE's batch lines and runs nothing. Exits non-zero if a batch
leaves the kernel it was sent to.
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

MU, PHI = 0.4, 330.0
N = 128  # columns a side: the template's full width
# The JAX package's XLA estimator at (MU, PHI) on this scene: mean,
# standard error over batches and batches (chip_smoke.py's JAX_GAS_RAD
# direction 7: tools/landsat_radiance_reference.py gas, 28 batches of
# 8,192 photons on the CPU)
JAX_XLA = (0.182901901, 0.00113775, 28)


def gas_template(device, n=N):
    """chip_smoke.py 3i's gas template at width n (its _gas_broken_cloud
    without tables)."""
    import numpy as np

    from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent,
                                                  build_domain)
    from mcbrat3d_tpu_torch.physics.phase_function import (
        PhaseFunction, PhaseFunctionTable)
    from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene

    grid, comps, _ = broken_cloud_scene(nx=n, ny=n, device=device)
    nz = grid.nz
    q = (2.5e-4 * np.exp(-(np.arange(nz) + 0.5) * 20.0 / 2000.0)).reshape(
        1, 1, nz)
    gas = OpticalComponent(
        "gas absorber", q, np.zeros_like(q), np.zeros(q.shape, np.int32),
        PhaseFunctionTable([PhaseFunction.isotropic()], key=[1.0]))
    dom = build_domain(grid, [comps[0], gas], macro_factor=8,
                       n_cdf_steps=201)
    assert dom.col_template and dom.col_qz is not None
    return dom


def mean_se(xs):
    m = sum(xs) / len(xs)
    var = sum((x - m) ** 2 for x in xs) / (len(xs) - 1)
    return m, math.sqrt(var / len(xs))


def welch(a, b):
    """Welch's t for the gap between two means, each (mean, standard
    error, batches): the gap, t, the Welch-Satterthwaite degrees of
    freedom, the two-sided p and the 95% interval of the gap."""
    from scipy import stats

    (ma, sa, na), (mb, sb, nb) = a, b
    gap, se = ma - mb, math.hypot(sa, sb)
    dof = se ** 4 / (sa ** 4 / (na - 1) + sb ** 4 / (nb - 1))
    half = float(stats.t.ppf(0.975, dof)) * se
    return dict(gap=gap, t=gap / se, dof=dof,
                p=2.0 * float(stats.t.sf(abs(gap) / se, dof)),
                interval95=[gap - half, gap + half])


def summarize(rows, card, photons, seconds):
    """The summary line of the batch lines ``rows`` (per estimator)."""
    n_batches = len(rows["wave"])
    summary = {"card": card, "scene": f"{N} x {N} x 64",
               "direction": [MU, PHI], "batches": n_batches,
               "photons_each": n_batches * photons, "seconds": seconds}
    for name, rs in rows.items():
        m, se = mean_se([r["radiance"] for r in rs])
        summary[name] = dict(radiance=m, se=se, batches=len(rs),
                             seconds=sum(r["seconds"] for r in rs),
                             n_bad=sum(r["n_bad"] for r in rs))
    k3, wave = ((summary[k]["radiance"], summary[k]["se"], len(rows[k]))
                for k in ("k3", "wave"))
    summary["gap_sigma"] = (k3[0] - wave[0]) / math.hypot(k3[1], wave[1])
    summary["k3_minus_wave"] = welch(k3, wave)
    summary["wave_minus_jax_xla"] = welch(wave, JAX_XLA)
    summary["k3_minus_jax_xla"] = welch(k3, JAX_XLA)
    return summary


def read_rows(path, photons=None):
    """The batch lines of an earlier run, per estimator, and the card its
    summary line names (None without one)."""
    rows, card = {"k3": [], "wave": []}, None
    with open(path) as f:
        for row in map(json.loads, f):
            if "estimator" in row:
                assert photons is None or row["photons"] == photons, row
                rows[row["estimator"]].append(row)
            else:
                card = row.get("card", card)
    return rows, card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=420.0,
                    help="wave-kernel seconds to spend")
    ap.add_argument("--photons", type=int, default=1 << 17,
                    help="photons a batch (a multiple of 131,072 past it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/gas_estimators.jsonl")
    ap.add_argument("--resume", default=None,
                    help="batch lines of an earlier run to go on from")
    ap.add_argument("--summarize", default=None,
                    help="print the summary of these batch lines only")
    opts = ap.parse_args(argv)
    if opts.summarize:
        rows, card = read_rows(opts.summarize)
        print(json.dumps(summarize(rows, card, rows["wave"][0]["photons"],
                                   None)), flush=True)
        return 0

    from mcbrat3d_tpu_torch.core import rng
    from mcbrat3d_tpu_torch.core.device import resolve
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import integrator
    from mcbrat3d_tpu_torch.transport import local_estimate as le
    from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig,
                                                          run_batch)

    device = resolve(opts.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    dom = gas_template(device)
    sfc = Surface.lambertian(0.2)
    src = illumination.directional(0.5, 0.0)
    icfg = le.IntensityConfig(n_dirs=1, use_russian_roulette=True,
                              use_hybrid_phase=True, pallas_min_mu=0.4)
    dirs = le.make_intensity_directions([MU], [PHI], device=device)
    col_lanes, wave_lanes = min(1 << 13, opts.photons), min(1 << 17,
                                                           opts.photons)
    configs = {
        "k3": KernelConfig(n_lanes=col_lanes,
                           photons_per_lane=opts.photons // col_lanes,
                           max_steps=400_000, need_volume_absorption=False),
        "wave": KernelConfig(n_lanes=wave_lanes,
                             photons_per_lane=opts.photons // wave_lanes,
                             max_steps=400_000, need_volume_absorption=False,
                             use_pallas="off")}
    for cfg in configs.values():
        assert cfg.photons_per_batch == opts.photons, cfg
    out_path = Path(opts.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    rows = {"k3": [], "wave": []}
    if opts.resume:
        rows, _ = read_rows(opts.resume, opts.photons)
    spent = {"k3": 0.0, "wave": 0.0}
    t_start = time.perf_counter()
    with open(out_path, "w") as out:
        for row in rows["k3"] + rows["wave"]:
            out.write(json.dumps(row) + "\n")
        b = 1 + max([r["batch"] for r in rows["wave"]], default=-1)
        while True:
            for name, cfg in configs.items():
                launches = (ck.COL_LE_LAUNCHES, integrator.WAVE_BATCHES)
                t0 = time.perf_counter()
                t = run_batch(dom, sfc, src, rng.batch_seed(11, b), cfg,
                              intensity_config=icfg, intensity_dirs=dirs,
                              key=rng.batch_key(11, b))
                n = t.n_photons
                rad = float(t.intensity.double().sum()) / n
                secs = time.perf_counter() - t0
                ran = (ck.COL_LE_LAUNCHES - launches[0],
                       integrator.WAVE_BATCHES - launches[1])
                if (name == "wave") != (ran[1] == 1) or \
                        (name == "k3" and device.type == "cuda"
                         and ran[0] == 0):
                    print(f"batch {b} on {name} ran {ran} (column kernel "
                          "radiance launches, wave batches)", file=sys.stderr)
                    return 1
                row = dict(estimator=name, batch=b, photons=n,
                           radiance=rad, n_bad=int(t.n_bad),
                           steps=int(t.n_steps), seconds=secs,
                           rta=[float(a.double().sum()) / n for a in
                                (t.flux_up, t.flux_down, t.flux_absorbed)])
                rows[name].append(row)
                spent[name] += secs
                line = json.dumps(row)
                print(line, flush=True)
                out.write(line + "\n")
                out.flush()
            b += 1
            if spent["wave"] >= opts.seconds and len(rows["wave"]) >= 2:
                break
        summary = summarize(rows, card, opts.photons,
                            time.perf_counter() - t_start)
        line = json.dumps(summary)
        out.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
