"""Reference values of the Landsat-scale longwave run and of the Landsat
scene over a per-pixel surface, from the JAX package on the CPU
(independent of the PyTorch port's kernels).

* ``lw``: a 10 um window-band thermal run over ``broken_cloud_scene(ssa=
  0.5)`` (128 x 128 x 64 columns of 30 x 30 x 20 m, macro factor 8, analytic
  HG) with the lapse-rate profile T(z) = 288 K - 6.5 K/km at the cell
  centres, so the domain carries its column emission tables (col_em_*); the
  per-voxel emission source of ``emission_weighting`` (surface 288 K,
  emissivity 0.95), a Lambertian surface of albedo 0.05, lw_mode with the
  3D absorption tally; seed 11. A batch's values are the domain means of
  the normalized up and down fluxes and of the net column absorption
  (emission pre-credits included), then the 64 levels of the net
  absorption profile (the horizontal mean of the normalized 3D field).
* ``px``: ``broken_cloud_scene()`` (ssa 0.99, macro factor 8, analytic HG,
  the hybrid forward row of 10 degrees) under a beam of mu0 0.5, azimuth 0,
  over a Lambertian surface of 16 x 16 albedo pixels, 0.1 + 0.7 * rand from
  ``np.random.RandomState(4)``: a flux run (R, T, A and the 64-level
  absorption profile) and a radiance run with the 16 directions of
  ``run/landsat_radiance.nml`` (R, T, A and the 16 domain-mean radiances);
  seed 12.

Both run on the XLA path (``use_pallas="off"``) at full width;
``--flux-only`` leaves out ``px``'s radiance run. With
``--cut`` the same runs take a 64 x 32 x 32 cut of the scene (65,536
cells: past the record kernel's 36,864, inside the column kernel's
envelope) through the JAX column kernel (K3) in Pallas interpret mode,
flux only. A batch's line holds its photons and its values; ``stats``
turns the lines into means and standard errors over the batches. Batches
are independent, so a long run can be split over processes:

    JAX_PLATFORMS=cpu python tools/landsat_lw_px_reference.py lw \\
        --photons 16384 --batches 0:24 > lw.jsonl
    JAX_PLATFORMS=cpu python tools/landsat_lw_px_reference.py px \\
        --photons 8192 --batches 0:8 > px_0.jsonl    # and 8:16, 16:24
    JAX_PLATFORMS=cpu python tools/landsat_lw_px_reference.py px \\
        --flux-only --photons 8192 --batches 24:200 > px_flux.jsonl
    JAX_PLATFORMS=cpu python tools/landsat_lw_px_reference.py lw --cut \\
        --photons 8192 --batches 0:16 > lw_cut.jsonl
    JAX_PLATFORMS=cpu python tools/landsat_lw_px_reference.py px --cut \\
        --photons 8192 --batches 0:16 > px_cut.jsonl
    python tools/landsat_lw_px_reference.py stats lw*.jsonl px*.jsonl
"""

import argparse
import dataclasses
import json
import sys

import numpy as np

MUS16 = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4] * 2
PHIS16 = [(i * 45.0 + 15.0) % 360.0 for i in range(16)]
CUT = dict(nx=64, ny=32, nz=32)


def lapse_temps(nx, ny, nz, dz_km=0.02):
    """T(z) = 288 K - 6.5 K/km at the cell centres, the same in every
    column: [nx, ny, nz] float64."""
    tz = 288.0 - 6.5 * (np.arange(nz) + 0.5) * dz_km
    return np.broadcast_to(tz, (nx, ny, nz)).copy()


def albedo_grid():
    """The 16 x 16 x 1 per-pixel albedo grid, float32."""
    rs = np.random.RandomState(4)
    return (0.1 + 0.7 * rs.rand(16, 16, 1)).astype(np.float32)


def lw_case(size):
    from mcbrat3d_tpu.domain.domain import build_domain
    from mcbrat3d_tpu.physics.surface import Surface
    from mcbrat3d_tpu.scenes.collection import broken_cloud_scene
    from mcbrat3d_tpu.sources import illumination
    from mcbrat3d_tpu.spectral.weights import emission_weighting

    grid, comps, _ = broken_cloud_scene(ssa=0.5, **size)
    temps = lapse_temps(*grid.shape)
    dom = build_domain(grid, comps, temps=temps, lambda_um=10.0,
                       macro_factor=8, n_cdf_steps=201)
    assert dom.col_template and dom.col_em_prob is not None
    kabs = np.asarray(dom.total_ext) * (1.0 - np.asarray(dom.ssa)[..., 0])
    w = emission_weighting(grid, temps, kabs, 288.0, 0.95, 10.0)
    src = illumination.emission(w.voxel_cdf, w.frac_atms_power, grid.shape)
    sfc = Surface.lambertian(0.05, temperature=288.0, emissivity=0.95)
    return dom, sfc, src


def px_case(size, tables=True):
    from mcbrat3d_tpu.domain.domain import build_domain
    from mcbrat3d_tpu.physics.surface import Surface
    from mcbrat3d_tpu.scenes.collection import broken_cloud_scene
    from mcbrat3d_tpu.sources import illumination

    grid, comps, _ = broken_cloud_scene(**size)
    dom = build_domain(grid, comps, macro_factor=8, n_cdf_steps=201,
                       compute_intensity_tables=tables,
                       hybrid_width_deg=10.0 if tables else 0.0)
    assert dom.col_template
    return (dom, Surface(params=albedo_grid()),
            illumination.directional(0.5, 0.0))


def _row(t, grid, profile):
    t = t.normalized(grid)
    row = [float(np.mean(np.asarray(a)))
           for a in (t.flux_up, t.flux_down, t.flux_absorbed)]
    if profile:
        prof = t.absorption_profile
        if prof is None:
            prof = np.asarray(t.volume_absorption, np.float64).mean(
                axis=(0, 1))
        row += np.asarray(prof, np.float64).tolist()
    if t.intensity is not None:
        row += np.asarray(t.intensity, np.float64).mean(axis=(0, 1)).tolist()
    return int(t.n_photons), row


def batches(run, photons, batch_ids, cut, flux_only=False):
    from mcbrat3d_tpu.core import rng
    from mcbrat3d_tpu.transport import pallas_col
    from mcbrat3d_tpu.transport.integrator import KernelConfig, run_batch
    from mcbrat3d_tpu.transport.local_estimate import (
        IntensityConfig, make_intensity_directions)

    size = CUT if cut else {}
    lanes = min(photons, 1 << 14)
    cfg = KernelConfig(n_lanes=lanes, photons_per_lane=-(-photons // lanes),
                       max_steps=400_000,
                       use_pallas="on" if cut else "off",
                       lw_mode=run == "lw", need_volume_absorption=True,
                       need_absorption_profile=True)
    if run == "lw":
        dom, sfc, src = lw_case(size)
        seed, cases = 11, [("lw", None, None)]
    else:
        dom, sfc, src = px_case(size, tables=not cut)
        seed, cases = 12, [("px_flux", None, None)]
        if not (cut or flux_only):
            icfg = IntensityConfig(n_dirs=16, use_russian_roulette=True,
                                   zeta_min=0.3, use_hybrid_phase=True,
                                   pallas_min_mu=0.4)
            cases.append(("px_radiance", icfg,
                          make_intensity_directions(MUS16, PHIS16)))
    for b in batch_ids:
        for name, icfg, dirs in cases:
            key = rng.batch_key(seed, b)
            if cut:
                t = pallas_col.run_batch_pallas_col_tallies(
                    dom, sfc, src, key, cfg, n_photons=photons,
                    interpret=True)
                name += "_cut_k3"
            else:
                kw = {} if icfg is None else dict(
                    need_volume_absorption=False)
                t = run_batch(dom, sfc, src, key,
                              dataclasses.replace(cfg, **kw),
                              intensity_config=icfg, intensity_dirs=dirs,
                              n_photons=photons)
            yield name, b, _row(t, dom.grid, profile=icfg is None)


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
    ap.add_argument("run", choices=("lw", "px", "stats"))
    ap.add_argument("paths", nargs="*", help="the batch files (stats)")
    ap.add_argument("--photons", type=int, default=8192)
    ap.add_argument("--batches", default="0:16", help="first:last+1")
    ap.add_argument("--cut", action="store_true",
                    help="64 x 32 x 32 through JAX's K3 in interpret mode")
    ap.add_argument("--flux-only", action="store_true",
                    help="px: the flux run alone")
    args = ap.parse_args(argv)
    if args.run == "stats":
        return stats(args.paths)
    import jax
    jax.config.update("jax_platforms", "cpu")
    lo, hi = (int(v) for v in args.batches.split(":"))
    for run, b, (n, values) in batches(args.run, args.photons,
                                       range(lo, hi), args.cut,
                                       args.flux_only):
        print(json.dumps({"run": run, "batch": b, "n": n, "values": values}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
