#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (mcbrat3d_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each asserting; any failure exits non-zero:

1. print the card (nvidia-smi name and power limit) and build the CUDA
   record kernel from mcbrat3d_tpu_torch/csrc, reporting the build time;
2. kernel against its plain PyTorch version on the card, same seeds: the
   step cloud at 2^20 photons for macro_factor 0 and 8, both tally
   layouts, plus the tabulated-phase configuration the namelist deck runs
   and a reflecting surface without roulette;
   domain-mean R/T/A within 2e-3 and per-pixel fluxes within 5 sigma;
3. the main path through the command line: mkdomain step_cloud (512
   Legendre moments), then run/step_cloud_mono.nml (16 x 1,048,576
   photons, 3D absorption tally)
   on cuda; n_bad == 0, R/T/A within 4.5 sigma of the frozen step-cloud
   goldens, output files written, the kernel launched and the plain step
   never run;
4. one headline batch (macro_factor 16, 2^16 lanes x 1024 photons, flux
   tallies only): photons/s of the kernel, and of the plain version at the
   same lane count.

Prints the card line, then one JSON line describing each kernel, then the
final JSON status line.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (ssa, mu0) = (0.99, 0.5) row of tests/test_golden.py: frozen from the
# native C++ tracer at 40M photons (one-sigma ~8e-5).
GOLDEN_RTA = (0.47656, 0.32485, 0.19860)
RTA_TOL_KERNEL_VS_PLAIN = 2e-3
HEADLINE_PLAIN_PPL = 16


def _sync():
    import torch
    torch.cuda.synchronize()


def _rta(t):
    n = t.n_photons
    return tuple(float(a.sum()) / n
                 for a in (t.flux_up, t.flux_down, t.flux_absorbed))


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def phase_compare(rk, make_step_cloud, Surface, illumination, KernelConfig,
                  rng):
    """Kernel vs plain on the card; returns the largest per-pixel
    difference of the normalized fluxes."""
    import dataclasses

    source = illumination.directional(0.5, 0.0)
    # (macro_factor, 3D tally, analytic HG, surface albedo, roulette)
    cases = [(mf, vol, True, 0.0, True) for mf in (0, 8)
             for vol in (False, True)]
    cases.append((8, True, False, 0.0, True))  # tabulated, as the deck runs
    cases.append((8, False, True, 0.3, False))  # reflection, no roulette
    max_err = 0.0
    for i, (mf, vol, analytic, albedo, rr) in enumerate(cases):
        surface = Surface.lambertian(albedo)
        dom = make_step_cloud(ssa=0.99, macro_factor=mf, n_cdf_steps=10001,
                              device="cuda")
        if not analytic:
            # a file-read domain carries Legendre moments, not hg_g
            dom = dataclasses.replace(dom, all_hg=False)
        cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                           max_steps=100_000, need_volume_absorption=vol,
                           use_russian_roulette=rr)
        seed = rng.batch_seed(10, i)
        before = rk.LAUNCHES
        tk, sk = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, seed, cfg))
        assert rk.LAUNCHES > before, "kernel was not launched"
        tk2 = rk.run_batch_record_tallies(dom, surface, source, seed, cfg)
        assert (tk2.n_photons, tk2.n_bad) == (tk.n_photons, tk.n_bad)
        rerun = max(abs(float(a.sum()) / float(b.sum()) - 1.0)
                    for a, b in ((tk.flux_up, tk2.flux_up),
                                 (tk.flux_down, tk2.flux_down),
                                 (tk.flux_absorbed, tk2.flux_absorbed)))
        assert rerun < 1e-5, f"kernel reruns differ by {rerun:.2e}"
        tp, sp = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, seed, cfg, launch=rk.record_launch_plain))
        assert tk.n_photons == tp.n_photons == 1 << 20, (tk.n_photons,
                                                         tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        rta_k, rta_p = _rta(tk), _rta(tp)
        gap = max(abs(a - b) for a, b in zip(rta_k, rta_p))
        n = tk.n_photons
        z_max = 0.0
        for a, b in ((tk.flux_up, tp.flux_up), (tk.flux_down, tp.flux_down),
                     (tk.flux_absorbed, tp.flux_absorbed)):
            a = a.double().cpu()
            b = b.double().cpu()
            per_col = n / a.numel()
            sigma = ((a + b).clamp(min=1.0) / 2).sqrt()
            z_max = max(z_max, float(((a - b).abs() / sigma).max()))
            max_err = max(max_err, float((a - b).abs().max()) / per_col)
        print(f"compare macro={mf} vol={vol} analytic={analytic} "
              f"albedo={albedo} roulette={rr}: "
              f"kernel R/T/A={rta_k} plain={rta_p} gap={gap:.3e} "
              f"pixel z_max={z_max:.2f} rerun rel={rerun:.1e} "
              f"kernel {sk:.3f} s plain {sp:.3f} s",
              flush=True)
        assert gap < RTA_TOL_KERNEL_VS_PLAIN, gap
        assert z_max < 5.0, z_max
    return max_err


def phase_main_path(rk, cli):
    """The namelist deck through the CLI on cuda."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copy(ROOT / "run" / "step_cloud_mono.nml", tmp / "deck.nml")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            # 512 Legendre moments: the file stores the phase function as
            # moments, and the default 64 shift R by -1.9e-3 against the
            # analytic-HG goldens (the JAX file path shows the same shift)
            assert cli.main(["mkdomain", "step_cloud", "StepCloud.dom",
                             "ssa=0.99", "n_legendre=512"]) == 0
            plain_steps = []
            plain = rk.record_launch_plain

            def counting_plain(*args, **kwargs):
                plain_steps.append(1)
                return plain(*args, **kwargs)

            rk.record_launch_plain = counting_plain
            buf = io.StringIO()
            rk.LAUNCHES = 0
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["run", "deck.nml", "--device", "cuda"])
            finally:
                rk.record_launch_plain = plain
            seconds = time.perf_counter() - t0
            launches = rk.LAUNCHES
            assert rc == 0
            out = json.loads(buf.getvalue().strip().splitlines()[-1])
            for f in ("StepCloud_flux.out", "StepCloud_results.nc"):
                assert (tmp / f).stat().st_size > 0, f
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    print(f"main path: {n} photons in {out['n_batches']} batches, "
          f"n_bad={out['n_bad']}, R/T/A={rta}, {seconds:.2f} s "
          f"({n / seconds:.4g} photons/s incl. setup and output), "
          f"{launches} kernel launches", flush=True)
    assert n == 16 * 1_048_576 and out["n_batches"] == 16
    assert out["n_bad"] == 0
    assert launches > 0, "the main path did not launch the record kernel"
    assert not plain_steps, "the main path ran the plain PyTorch step"
    for got, want, name in zip(rta, GOLDEN_RTA, "RTA"):
        sigma = (max(want * (1 - want), 1e-8) / n) ** 0.5 + 8e-5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    return launches


def phase_headline(rk, make_step_cloud, Surface, illumination, KernelConfig,
                   rng):
    """One headline batch: kernel and plain photons/s and time per launch
    (128 steps of 65,536 lanes)."""
    dom = make_step_cloud(ssa=0.99, macro_factor=16, device="cuda")
    surface = Surface.lambertian(0.0)
    source = illumination.directional(0.5, 0.0)
    res = {}
    for name, ppl, launch in (
            ("kernel", 1024, rk.record_launch),
            ("plain", HEADLINE_PLAIN_PPL, rk.record_launch_plain)):
        cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=ppl,
                           max_steps=1_600_000, need_volume_absorption=False)
        if name == "kernel":  # warm-up batch
            rk.run_batch_record_tallies(dom, surface, source,
                                        rng.batch_seed(0, 99), cfg)
        t, sec = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, rng.batch_seed(0, 0), cfg, launch=launch))
        assert t.volume_absorption is None and t.n_bad == 0
        assert t.n_photons == (1 << 16) * ppl
        n_launch = t.n_steps // 128
        res[name] = dict(photons_per_s=t.n_photons / sec,
                         ms_per_launch=1e3 * sec / n_launch,
                         photons=t.n_photons, seconds=sec,
                         launches=n_launch, rta=_rta(t))
        print(f"headline {name}: {t.n_photons} photons in {sec:.3f} s = "
              f"{t.n_photons / sec:.6g} photons/s, {n_launch} launches, "
              f"{1e3 * sec / n_launch:.4f} ms/launch, R/T/A={_rta(t)}",
              flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "mcbrat3d_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(mcbrat3d_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mcbrat3d_tpu_torch import _build
    from mcbrat3d_tpu_torch.core import rng
    from mcbrat3d_tpu_torch.driver import cli
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.load("record_kernel")
    info = _build.BUILD_INFO["record_kernel"]
    print(f"record_kernel built in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    args = (rk, make_step_cloud, Surface, illumination, KernelConfig, rng)
    max_err = phase_compare(*args)
    launches = phase_main_path(rk, cli)
    head = phase_headline(*args)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "record_kernel",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:712",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": head["kernel"]["ms_per_launch"],
        "plain_ms": head["plain"]["ms_per_launch"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
