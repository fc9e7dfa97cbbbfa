"""Reference values of the Landsat-scale radiance runs, from the JAX package
on the CPU (independent of the PyTorch port's kernels).

* ``cut NAMELIST``: writes cut copies of a deck for the JAX CLI, one per
  seed: ``numPhotonsPerBatch`` replaced by ``--photons``, one batch,
  ``iseed`` the seed and the output files named after it. Each copy runs
  unchanged through ``python -m mcbrat3d_tpu.driver.cli run``; distinct
  seeds give independent batches, and ``stats`` reads the netCDF files the
  runs write.
* ``gas``: the gas template at full width, ``broken_cloud_scene()`` (128 x
  128 x 64 columns of 30 x 30 x 20 m) plus one horizontally uniform pure
  absorber, ssa 0 with an isotropic table and q(z) = 2.5e-4 m^-1 *
  exp(-z_c / 2000 m) at the cell centres (a vertical optical depth of
  about 0.24), macro factor 8, 201 CDF steps, no radiance tables (analytic
  HG): a flux run (beam mu0 0.5, Lambertian albedo 0.2) and the same with
  the 16 directions of ``bench.py:555-559``, seed 7, on the XLA path.
* ``witness --estimator xla|k3``: the same gas template cut to 32 x 32 x 64
  columns (the same column height, so the same slant paths, which wrap the
  domain three times at mu 0.4), radiance only, the eight distinct
  directions of the 16 (mu 1 ... 0.4), seed 8, through the XLA local
  estimator or the column kernel (K3) in Pallas interpret mode.

A batch's line holds its photons and the domain means of R, T, A and the
radiance of each direction. ``stats`` turns such lines, and the CLI's
netCDF files (R, T, A, the absorption profile's column integral, the
domain-mean radiances), into means and standard errors over the batches.
Batches are independent, so a long run can be split over processes:

    python tools/landsat_radiance_reference.py cut landsat_radiance.nml \\
        --photons 8192 --seeds 10:26 --dir cut
    for s in $(seq 10 25); do JAX_PLATFORMS=cpu python -m \\
        mcbrat3d_tpu.driver.cli run cut/seed_$s.nml; done
    JAX_PLATFORMS=cpu python tools/landsat_radiance_reference.py gas \\
        --photons 8192 --batches 0:16 > gas.jsonl
    JAX_PLATFORMS=cpu python tools/landsat_radiance_reference.py witness \\
        --estimator k3 --photons 4096 --batches 0:32 > k3.jsonl
    python tools/landsat_radiance_reference.py stats cut/*.nc gas.jsonl
"""

import argparse
import json
import os
import re
import sys

import numpy as np

MUS16 = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4] * 2
PHIS16 = [(i * 45.0 + 15.0) % 360.0 for i in range(16)]


def cut(namelist, photons, seeds, out_dir):
    """One copy of ``namelist`` per seed in ``out_dir``."""
    with open(namelist) as f:
        text = f.read()
    os.makedirs(out_dir, exist_ok=True)
    for s in seeds:
        t = text
        for key, value in (("numPhotonsPerBatch", photons),
                           ("numBatches", 1), ("iseed", s)):
            t, n = re.subn(rf"(?im)^(\s*{key}\s*=\s*)\S+", rf"\g<1>{value}",
                           t)
            assert n == 1, key
        for key in ("outputFluxFile", "outputRadFile", "outputNetcdfFile"):
            t = re.sub(rf"(?im)^(\s*{key}\s*=\s*')([^']*)'",
                       lambda m: (f"{m.group(1)}"
                                  f"{os.path.join(out_dir, f'seed_{s}_')}"
                                  f"{os.path.basename(m.group(2))}'"), t)
        with open(os.path.join(out_dir, f"seed_{s}.nml"), "w") as f:
            f.write(t)


def _row(t, grid):
    t = t.normalized(grid)
    row = [float(np.mean(np.asarray(a)))
           for a in (t.flux_up, t.flux_down, t.flux_absorbed)]
    if t.intensity is not None:
        row += np.asarray(t.intensity, np.float64).mean(axis=(0, 1)).tolist()
    return int(t.n_photons), row


def gas_domain(nx=128, ny=128):
    from mcbrat3d_tpu.domain.domain import OpticalComponent, build_domain
    from mcbrat3d_tpu.physics.phase_function import (PhaseFunction,
                                                     PhaseFunctionTable)
    from mcbrat3d_tpu.scenes.collection import broken_cloud_scene

    grid, comps, _ = broken_cloud_scene(nx=nx, ny=ny)
    nz = grid.shape[2]
    z_c = (np.arange(nz) + 0.5) * 20.0
    q = (2.5e-4 * np.exp(-z_c / 2000.0)).reshape(1, 1, nz)
    gas = OpticalComponent(
        "gas absorber", q, np.zeros_like(q), np.zeros(q.shape, np.int32),
        PhaseFunctionTable([PhaseFunction.isotropic()], key=[1.0]))
    dom = build_domain(grid, [comps[0], gas], macro_factor=8,
                       n_cdf_steps=201)
    assert dom.col_template and dom.col_qz is not None
    return dom


def _gas_runs(dom, photons, n_dirs):
    from mcbrat3d_tpu.physics.surface import Surface
    from mcbrat3d_tpu.sources import illumination
    from mcbrat3d_tpu.transport.integrator import KernelConfig
    from mcbrat3d_tpu.transport.local_estimate import (
        IntensityConfig, make_intensity_directions)

    lanes = min(photons, 1 << 14)
    cfg = KernelConfig(n_lanes=lanes, photons_per_lane=-(-photons // lanes),
                       max_steps=400_000, use_pallas="off",
                       need_volume_absorption=False)
    icfg = IntensityConfig(n_dirs=n_dirs, use_russian_roulette=True,
                           use_hybrid_phase=True, pallas_min_mu=0.4)
    dirs = make_intensity_directions(MUS16[:n_dirs], PHIS16[:n_dirs])
    return (Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
            cfg, icfg, dirs)


def gas_batches(photons, batches):
    from mcbrat3d_tpu.core import rng
    from mcbrat3d_tpu.transport.integrator import run_batch

    dom = gas_domain()
    sfc, src, cfg, icfg, dirs = _gas_runs(dom, photons, 16)
    for b in batches:
        for run, ic, di in (("gas_flux", None, None),
                            ("gas_radiance", icfg, dirs)):
            t = run_batch(dom, sfc, src, rng.batch_key(7, b), cfg,
                          intensity_config=ic, intensity_dirs=di,
                          n_photons=photons)
            yield run, b, _row(t, dom.grid)


def witness_batches(estimator, photons, batches):
    from mcbrat3d_tpu.core import rng
    from mcbrat3d_tpu.transport import pallas_col
    from mcbrat3d_tpu.transport.integrator import run_batch

    dom = gas_domain(32, 32)
    sfc, src, cfg, icfg, dirs = _gas_runs(dom, photons, 8)
    for b in batches:
        key = rng.batch_key(8, b)
        if estimator == "xla":
            t = run_batch(dom, sfc, src, key, cfg, intensity_config=icfg,
                          intensity_dirs=dirs, n_photons=photons)
        else:
            t = pallas_col.run_batch_pallas_col_tallies(
                dom, sfc, src, key, cfg, interpret=True,
                intensity_config=icfg, intensity_dirs=dirs)
        yield f"witness_{estimator}", b, _row(t, dom.grid)


def _netcdf_row(path):
    """R, T, A, the profile's column integral (sum of profile * dz * 1000)
    and the domain-mean radiances of one CLI run's netCDF file."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as nc:
        v = nc.variables
        row = [float(np.mean(v[k][:])) for k in ("fluxUp", "fluxDown",
                                                  "fluxAbsorbed")]
        dz = np.diff(np.asarray(v["z-Edges"][:], np.float64))
        row.append(float(np.sum(np.asarray(v["absorptionProfile"][:])
                                * dz * 1000.0)))
        row += np.asarray(v["intensity"][:]).mean(axis=(1, 2)).tolist()
        return int(round(float(nc.totalPhotons))), row


def stats(paths):
    runs = {}
    for path in paths:
        if path.endswith(".nc"):
            n, values = _netcdf_row(path)
            runs.setdefault("deck", {})[path] = {"n": n, "values": values}
            continue
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
    ap.add_argument("run", choices=("cut", "gas", "witness", "stats"))
    ap.add_argument("paths", nargs="*",
                    help="the namelist (cut) or the batch and netCDF files "
                         "(stats)")
    ap.add_argument("--photons", type=int, default=8192)
    ap.add_argument("--batches", default="0:16", help="first:last+1")
    ap.add_argument("--seeds", default="10:26", help="first:last+1 (cut)")
    ap.add_argument("--dir", default="cut", help="output directory (cut)")
    ap.add_argument("--estimator", choices=("xla", "k3"), default="xla")
    args = ap.parse_args(argv)
    if args.run == "stats":
        return stats(args.paths)
    if args.run == "cut":
        lo, hi = (int(v) for v in args.seeds.split(":"))
        return cut(args.paths[0], args.photons, range(lo, hi), args.dir)
    import jax
    jax.config.update("jax_platforms", "cpu")
    lo, hi = (int(v) for v in args.batches.split(":"))
    gen = (gas_batches(args.photons, range(lo, hi)) if args.run == "gas"
           else witness_batches(args.estimator, args.photons, range(lo, hi)))
    for run, b, (n, values) in gen:
        print(json.dumps({"run": run, "batch": b, "n": n, "values": values}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
