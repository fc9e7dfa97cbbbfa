"""Reference values of the step cloud over a uniform RPV surface and over a
per-pixel albedo mosaic, from the JAX package on the CPU (independent of
the PyTorch port's kernels).

The scene is ``run/step_cloud_mono.nml``'s: ``make_step_cloud(ssa=0.99)``
(32 x 1 x 32, HG 0.85, analytic), a beam of mu0 0.5 and azimuth 0, flux
and column absorption tallies, Russian roulette on. The surfaces:

* ``rpv``: ``Surface.rpv(0.25, k=0.8, theta=-0.15)`` (the parameters of
  the JAX package's TestRPVSurface); seed 13.
* ``px``: an 8 x 1 grid of Lambertian albedos alternating 0.05 and 0.65,
  4 columns a pixel (TestPerPixelSurface._checker(8)); seed 14.
* ``px_radiance``: the same mosaic under ``run/step_cloud_radiance.nml``'s
  6 directions (mu 1, 0.866, 0.5 x phi 0, 90), on the step cloud built
  with its intensity tables and the deck's 7-degree hybrid forward row,
  with the deck's Iwabuchi roulette (zetaMin 0.3); seed 15.

All run on the XLA path (``use_pallas="off"``). A batch's values are the
domain means of the normalized up, down and absorbed fluxes, then the 32
columns of the normalized up flux (``rpv``, ``px``) or the 6 domain-mean
radiances (``px_radiance``). A batch's line holds its photons and its
values; ``stats`` turns the lines into means and standard errors over the
batches. Batches are independent, so a long run can be split over
processes (the XLA path runs ~5,000 flux photons a second on one core):

    JAX_PLATFORMS=cpu python tools/record_surface_reference.py rpv \\
        --photons 262144 --batches 0:11 > rpv_0.jsonl   # ... 55:64
    JAX_PLATFORMS=cpu python tools/record_surface_reference.py px \\
        --photons 262144 --batches 0:11 > px_0.jsonl    # ... 55:64
    JAX_PLATFORMS=cpu python tools/record_surface_reference.py \\
        px_radiance --photons 65536 --batches 0:8 > pxr_0.jsonl  # ... 24:32
    python tools/record_surface_reference.py stats rpv_*.jsonl px*.jsonl
"""

import argparse
import json
import sys

import numpy as np

CASES = {"rpv": 13, "px": 14, "px_radiance": 15}


def checker(nxs=8, lo=0.05, hi=0.65):
    """The per-pixel albedo mosaic: nxs x 1 x 1 float32, alternating lo
    and hi from lo."""
    return np.where(np.arange(nxs) % 2 == 0, lo, hi).astype(
        np.float32).reshape(nxs, 1, 1)


def deck_directions():
    """(mus, phis) of run/step_cloud_radiance.nml, from the JAX package's
    namelist reader."""
    from pathlib import Path

    from mcbrat3d_tpu.driver.config import load_config

    deck = Path(__file__).resolve().parents[1] / "run" / \
        "step_cloud_radiance.nml"
    return load_config(str(deck)).radiance_directions()


def case(run):
    """(domain, surface, source, intensity config, directions) of a run."""
    import jax.numpy as jnp

    from mcbrat3d_tpu.physics.surface import Surface
    from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud
    from mcbrat3d_tpu.sources import illumination
    from mcbrat3d_tpu.transport.local_estimate import (
        IntensityConfig, make_intensity_directions)

    src = illumination.directional(0.5, 0.0)
    if run == "rpv":
        return (make_step_cloud(ssa=0.99),
                Surface.rpv(0.25, k=0.8, theta=-0.15), src, None, None)
    sfc = Surface(params=jnp.asarray(checker()), brdf_name="Lambertian")
    if run == "px":
        return make_step_cloud(ssa=0.99), sfc, src, None, None
    mus, phis = deck_directions()
    icfg = IntensityConfig(n_dirs=int(len(mus)), use_russian_roulette=True,
                           zeta_min=0.3, use_hybrid_phase=True)
    dom = make_step_cloud(ssa=0.99, compute_intensity_tables=True,
                          hybrid_width_deg=7.0)
    return dom, sfc, src, icfg, make_intensity_directions(mus, phis)


def batches(run, photons, batch_ids):
    from mcbrat3d_tpu.core import rng
    from mcbrat3d_tpu.transport.integrator import KernelConfig, run_batch

    dom, sfc, src, icfg, dirs = case(run)
    lanes = min(photons, 1 << 16)
    cfg = KernelConfig(n_lanes=lanes, photons_per_lane=-(-photons // lanes),
                       max_steps=100_000, use_pallas="off",
                       need_volume_absorption=False)
    for b in batch_ids:
        t = run_batch(dom, sfc, src, rng.batch_key(CASES[run], b), cfg,
                      intensity_config=icfg, intensity_dirs=dirs,
                      n_photons=photons)
        assert int(t.n_bad) == 0, int(t.n_bad)
        tn = t.normalized(dom.grid)
        row = [float(np.mean(np.asarray(a)))
               for a in (tn.flux_up, tn.flux_down, tn.flux_absorbed)]
        if icfg is None:
            row += np.asarray(tn.flux_up, np.float64).reshape(-1).tolist()
        else:
            row += np.asarray(tn.intensity, np.float64).mean(
                axis=(0, 1)).tolist()
        yield b, int(t.n_photons), row


def stats(paths):
    runs = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.startswith("{"):
                    r = json.loads(line)
                    runs.setdefault(r["run"], {})[r["batch"]] = r
    out = {}
    for run, rows in sorted(runs.items()):
        a = np.asarray([rows[b]["values"] for b in sorted(rows)])
        out[run] = {"batches": len(rows),
                    "photons": sum(rows[b]["n"] for b in rows),
                    "mean": a.mean(axis=0).tolist(),
                    "stderr": (a.std(axis=0, ddof=1)
                               / np.sqrt(len(rows))).tolist()}
    print(json.dumps(out))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", choices=(*CASES, "stats"))
    ap.add_argument("paths", nargs="*", help="the batch files (stats)")
    ap.add_argument("--photons", type=int, default=262144)
    ap.add_argument("--batches", default="0:16", help="first:last+1")
    args = ap.parse_args(argv)
    if args.run == "stats":
        return stats(args.paths)
    import jax
    jax.config.update("jax_platforms", "cpu")
    lo, hi = (int(v) for v in args.batches.split(":"))
    for b, n, values in batches(args.run, args.photons, range(lo, hi)):
        print(json.dumps({"run": args.run, "batch": b, "n": n,
                          "values": values}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
