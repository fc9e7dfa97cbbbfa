"""Reference values of the broadband-SW deck and of three step-cloud runs of
the XLA wave kernel, from the JAX package on the CPU (its XLA wave kernel
and XLA local estimator, ``use_pallas="off"``, independent of the PyTorch
port's code).

* ``sw``: ``run/broadband_sw.nml`` on the inputs of the port's
  ``mcbrat3d_tpu_torch/tools/sw_inputs.py`` (bench.py:576-650's scene: 16
  bins, 32 x 32 x 32 cells, cloud water and Rayleigh, 9,001 CDF steps,
  solar mu 0.5), one unchanged run of the deck a "batch": numBatches 1,
  numPhotonsPerBatch cut to ``--photons``, nLanes 2,048, iseed 100 + b.
  Values: the domain-mean up, down and absorbed flux [W m^-2 um^-1 of
  the solar source] and the incident flux that scales them.
* ``step``: ``run/step_cloud_mono.nml`` on the file of ``mkdomain
  step_cloud StepCloud.dom ssa=0.99 n_legendre=512`` (the deck's 10,001
  CDF steps, macro factor 8), seed 16: R, T, A.
* ``rt``: the same with ``useRayTracing`` and ``numRecScatOrd = 3``, seed
  17: R, T, A, then the domain-mean up and down fluxes of orders 0-2 and
  the overflow.
* ``rad``: ``run/step_cloud_radiance.nml`` on that file with its one
  direction moved to mu 0.1 (azimuth 0), seed 18: R, T, A and the
  domain-mean radiance.

The step-cloud runs build the domain as the command line does
(``driver.simulate``) and run one ``run_batch`` a batch at
``rng.batch_key(seed, b)``; a batch's values are its normalized domain
means. A batch's line holds its photons and its values; ``stats`` turns
the lines into means and standard errors over the batches. Batches are
independent, so a run can be split over processes:

    JAX_PLATFORMS=cpu python tools/wave_reference.py sw --photons 16384 \\
        --batches 0:8 > sw_0.jsonl          # ... 8:16
    JAX_PLATFORMS=cpu python tools/wave_reference.py step \\
        --photons 16384 --batches 0:16 > step_0.jsonl    # ... 16:32
    JAX_PLATFORMS=cpu python tools/wave_reference.py rt --photons 8192 \\
        --batches 0:16 > rt_0.jsonl
    JAX_PLATFORMS=cpu python tools/wave_reference.py rad --photons 4096 \\
        --batches 0:16 > rad_0.jsonl
    python tools/wave_reference.py stats sw_*.jsonl step_*.jsonl ...
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEEDS = {"step": 16, "rt": 17, "rad": 18}
SW_ISEED0 = 100
RAD_MU = 0.1


def _deck(name, photons, extra=""):
    """The deck ``run/<name>`` as a config of the JAX package's reader,
    numPhotonsPerBatch cut to ``photons``, with ``extra`` namelist lines
    added to &algorithms."""
    from mcbrat3d_tpu.driver.config import load_config

    text = (ROOT / "run" / name).read_text()
    for line in text.splitlines():
        if "numPhotonsPerBatch" in line:
            text = text.replace(line, f"  numPhotonsPerBatch = {photons}")
    text = text.replace("&algorithms", "&algorithms\n" + extra, 1)
    with tempfile.NamedTemporaryFile("w", suffix=".nml", delete=False) as f:
        f.write(text)
    try:
        return load_config(f.name)
    finally:
        os.unlink(f.name)


def sw_batches(photons, batch_ids):
    from mcbrat3d_tpu.spectral.broadband import run_broadband
    from mcbrat3d_tpu_torch.tools.sw_inputs import write_sw_broadband_inputs

    work = tempfile.mkdtemp()
    common, ssp, solar = write_sw_broadband_inputs(work)
    cfg = _deck("broadband_sw.nml", photons, "  nLanes = 2048\n")
    cfg = dataclasses.replace(cfg, phys_domain_file=common,
                              ssp_file_names=[ssp], solar_source_file=solar,
                              num_batches=1, use_pallas="off")
    for b in batch_ids:
        res = run_broadband(dataclasses.replace(cfg, iseed=SW_ISEED0 + b))
        yield b, res.total_photons, [
            float(res.mean[k]) for k in ("mean_flux_up", "mean_flux_down",
                                         "mean_flux_absorbed")] + [
            float(res.solar_flux)]


def step_batches(run, photons, batch_ids):
    from mcbrat3d_tpu.core import rng
    from mcbrat3d_tpu.domain import io_netcdf
    from mcbrat3d_tpu.domain.domain import build_domain
    from mcbrat3d_tpu.driver.run import kernel_config_from
    from mcbrat3d_tpu.physics.surface import Surface
    from mcbrat3d_tpu.sources import illumination
    from mcbrat3d_tpu.tools import scene_cli
    from mcbrat3d_tpu.transport.integrator import run_batch
    from mcbrat3d_tpu.transport.local_estimate import (
        IntensityConfig, make_intensity_directions)

    if run == "rad":
        cfg = _deck("step_cloud_radiance.nml", photons)
        cfg = dataclasses.replace(cfg, angle_fill=False,
                                  intensity_mus=[RAD_MU],
                                  intensity_phis=[0.0])
    else:
        cfg = _deck("step_cloud_mono.nml", photons,
                    "  useRayTracing = .true.\n" if run == "rt" else "")
        if run == "rt":
            cfg = dataclasses.replace(cfg, rec_scat_ord=True,
                                      num_rec_scat_ord=3)
    cfg = dataclasses.replace(cfg, use_pallas="off")
    path = os.path.join(tempfile.mkdtemp(), "StepCloud.dom")
    assert scene_cli.main("step_cloud", path,
                          ["ssa=0.99", "n_legendre=512"]) == 0
    grid, comps, temps, attrs = io_netcdf.read_domain(path)
    dom = build_domain(
        grid, comps, n_cdf_steps=cfg.n_phase_intervals,
        compute_intensity_tables=cfg.compute_intensity,
        hybrid_width_deg=(cfg.hybrid_phase_fun_width
                          if cfg.use_hybrid_phase_funs else 0.0),
        temps=temps, macro_factor=cfg.macro_factor)
    sfc = Surface.lambertian(attrs.get("surface_albedo", 0.0))
    src = illumination.directional(cfg.solar_mu, cfg.solar_azimuth)
    icfg = dirs = None
    if cfg.compute_intensity:
        mus, phis = cfg.radiance_directions()
        icfg = IntensityConfig(
            n_dirs=int(mus.size),
            use_russian_roulette=cfg.use_russian_roulette_intensity,
            zeta_min=cfg.zeta_min, use_hybrid_phase=cfg.use_hybrid_phase_funs)
        dirs = make_intensity_directions(mus, phis)
    kcfg = dataclasses.replace(kernel_config_from(cfg), max_steps=100_000)
    for b in batch_ids:
        t = run_batch(dom, sfc, src, rng.batch_key(SEEDS[run], b), kcfg,
                      icfg, dirs, n_photons=photons)
        assert int(t.n_bad) == 0, int(t.n_bad)
        tn = t.normalized(dom.grid)
        row = [float(np.mean(np.asarray(a)))
               for a in (tn.flux_up, tn.flux_down, tn.flux_absorbed)]
        if run == "rt":
            for a in (tn.flux_up_by_order, tn.flux_down_by_order):
                row += np.asarray(a, np.float64).mean(axis=(0, 1)).tolist()
        if run == "rad":
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
    ap.add_argument("run", choices=("sw", *SEEDS, "stats"))
    ap.add_argument("paths", nargs="*", help="the batch files (stats)")
    ap.add_argument("--photons", type=int, default=16384)
    ap.add_argument("--batches", default="0:16", help="first:last+1")
    args = ap.parse_args(argv)
    if args.run == "stats":
        return stats(args.paths)
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    lo, hi = (int(v) for v in args.batches.split(":"))
    rows = (sw_batches(args.photons, range(lo, hi)) if args.run == "sw"
            else step_batches(args.run, args.photons, range(lo, hi)))
    for b, n, values in rows:
        print(json.dumps({"run": args.run, "batch": b, "n": n,
                          "values": values}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
