#!/usr/bin/env python3
"""A/B of the record, column and separable kernels' steps between two
checkouts, on one card, in turns: A, B, B, A (or one checkout given twice:
its spread).

    python3 mcbrat3d_tpu_torch/tools/ab_lone_step.py A_ROOT B_ROOT

Each turn runs in its own process from that checkout's root, imports that
checkout's package (so each builds its own kernels into its own
``build/torch_kernels/``) and times, with the measurement functions of the
``chip_smoke.py`` beside this script (the same code for both checkouts):
the lone step (one warp alone on the card, ns per live lane-step, as the
last warps of a batch run; ``lone_step``) on the record kernel's flux
headline (bench.py:106-134: the step cloud, macro 16) and on the main
deck's configuration (run/step_cloud_mono.nml: the 10,001-step row,
macro 8, the 3D tally), on the Landsat headline's configuration
(bench.py:497-545: analytic HG, macro 8), with the tabulated row and at
macro 0, and on the separable headline's (bench.py:454-494: the 325 x
325 x 150 flagship scene, LW emission); the refill schedule's batch of
the Landsat headline (2^20 photons) and of the Landsat deck's
configuration (the 10,001-step row), kernel ms a launch from CUDA events
and photons/s, the mean of three batches each; and the split of the main
deck's 2^20-photon record batch (``batch_split``, the mean of three): the
host's set-up before its first launch, the kernel time, the rest of the
wall clock, and the kernel time past what its live lane-steps take at
the full card's rate (its tail). Prints one line per turn and, last, a
JSON object with the card (nvidia-smi name and power limit) and every
turn's numbers. Exits non-zero if a turn fails.
"""

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
SMOKE = HERE.parents[2] / "chip_smoke.py"

# The lone step: one warp of slots (32, on one SM) with quota enough to stay
# live through one launch of rk.REFILL_STEPS steps, as the last warps of a
# batch run
LONE_SLOTS = 32


def lone_step(cs, mod, rk, run_one, label):
    """ns per live lane-step of one warp alone on the card (the batch's
    tail, where few warps are live), from CUDA events around its launch
    (``cs._evented_batch``): ``run_one(schedule)`` runs one batch on the
    schedule, with photons enough that its lanes stay live through the
    launch."""
    sched = rk.RefillSchedule(rk.REFILL_STEPS, resident=LONE_SLOTS)
    run_one(sched)  # warm-up
    _, r = cs._evented_batch(mod, lambda sd: run_one(sched), 0,
                             f"{label}, one warp")
    steps_per_lane = r["lane_steps"] / LONE_SLOTS
    return 1e6 * r["kernel_ms_per_launch"] * r["launches"] / steps_per_lane


def batch_split(cs, rk, run, seed, ns_per_lane_step):
    """Where the wall clock of one record batch ``run(seed)`` goes: the
    host's set-up before its first launch (params, tables, the occupancy
    query, the state), the kernel time (CUDA events around each launch),
    the rest (read-backs, quota rebalances, the tallies' assembly), and the
    tail: the kernel time past its live lane-steps at the full card's
    ``ns_per_lane_step``, which the batch's slowest slots' serial chains
    take. All in ms."""
    import torch

    orig = rk._launch_cuda
    events, first = [], []

    def timed(*args):
        if not first:
            first.append(time.perf_counter())
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        orig(*args)
        e1.record()
        events.append((e0, e1))

    rk._launch_cuda = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = run(seed)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    finally:
        rk._launch_cuda = orig
    kernel = sum(a.elapsed_time(b) for a, b in events)
    setup = 1e3 * (first[0] - t0)
    full = 1e-6 * t.n_lane_steps * ns_per_lane_step
    return dict(wall_ms=wall, setup_ms=setup, kernel_ms=kernel,
                rest_ms=wall - setup - kernel, tail_ms=kernel - full,
                launches=len(events), photons=t.n_photons,
                lane_steps_per_photon=t.n_lane_steps / t.n_photons)


def record_measure(cs, rk, rng, KernelConfig, make_step_cloud, Surface,
                   illumination) -> dict:
    """The record kernel's part of a turn: the lone step on the flux
    headline's and the deck's configurations, the deck configuration's
    full-card rate (a 2^24-photon batch, every slot live through its
    launches) and the split of its 2^20-photon batch."""
    src = illumination.directional(0.5, 0.0)
    head = make_step_cloud(ssa=0.99, macro_factor=16, device="cuda")
    deck = dataclasses.replace(
        make_step_cloud(ssa=0.99, n_legendre=512, macro_factor=8,
                        n_cdf_steps=10001, device="cuda"), all_hg=False)
    out = {}
    for name, dom, vol in (("record headline", head, False),
                           ("record deck", deck, True)):
        lone = KernelConfig(n_lanes=LONE_SLOTS, photons_per_lane=256,
                            need_volume_absorption=vol)
        out[name] = lone_step(cs, rk, rk, lambda sched: (
            rk.run_batch_record_tallies(dom, Surface.lambertian(0.0), src,
                                        rng.batch_seed(0, 5), lone,
                                        rcfg=sched)), name)
    cfg = KernelConfig(n_lanes=1 << 17, photons_per_lane=8,
                       max_steps=100_000)

    def run(sd, n_photons=None):
        return rk.run_batch_record_tallies(deck, Surface.lambertian(0.0),
                                           src, sd, cfg, n_photons=n_photons)

    run(rng.batch_seed(0, 99))  # warm-up
    _, full = cs._evented_batch(rk, lambda sd: run(sd, 1 << 24),
                                rng.batch_seed(0, 98),
                                "record deck configuration, 2^24 photons")
    ns = 1e6 * full["kernel_ms_per_launch"] * full["launches"] / full[
        "lane_steps"]
    splits = [batch_split(cs, rk, run, rng.batch_seed(0, b), ns)
              for b in range(3)]
    split = {k: sum(d[k] for d in splits) / len(splits) for k in splits[0]}
    split["full_card_ns_per_lane_step"] = ns
    return out, split


def measure(root: Path) -> dict:
    """One turn, in this process: the checkout at ``root``'s package timed
    by this repository's chip_smoke functions."""
    sys.path.insert(0, str(root))
    from mcbrat3d_tpu_torch.core import rng
    from mcbrat3d_tpu_torch.domain.domain import build_domain
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.scenes.collection import (broken_cloud_scene,
                                                      lw_flagship_scene)
    from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk
    from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

    if not Path(ck.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ck.__file__}, not {root}'s package")
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sfc = Surface.lambertian(0.2)
    src = illumination.directional(0.5, 0.0)
    dom = cs._broken_cloud(broken_cloud_scene, build_domain, 8, 201)
    variants = {
        "headline": dom,
        "tabulated row": dataclasses.replace(dom, all_hg=False),
        "macro 0": cs._broken_cloud(broken_cloud_scene, build_domain, 0, 201),
    }
    lone, split = record_measure(cs, rk, rng, KernelConfig, make_step_cloud,
                                 Surface, illumination)
    out = {"lone_ns": lone, "record_deck_batch": split}
    out["lone_ns"].update({name: lone_step(cs, ck, rk, lambda sched: (
        ck.run_batch_col(d, sfc, src, rng.batch_seed(0, 5), sched,
                         n_photons=LONE_SLOTS * 64)), name)
        for name, d in variants.items()})
    lw = cs._lw_scene(lw_flagship_scene, build_domain, 325, 150, 8)
    lw_src = illumination.emission_separable(lw, 288.0, 0.95)
    out["lone_ns"]["separable"] = lone_step(cs, sk, rk, lambda sched: (
        sk.run_batch_sep(lw, Surface.lambertian(0.05), lw_src,
                         rng.batch_seed(0, 5), sched,
                         n_photons=LONE_SLOTS * 1024, lw_mode=True)),
        "separable")
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                       max_steps=400_000, need_volume_absorption=False)
    deck = dataclasses.replace(
        cs._broken_cloud(broken_cloud_scene, build_domain, 8, 10001),
        all_hg=False)
    for name, d in (("headline", dom), ("deck", deck)):
        ck.run_batch_col_tallies(d, sfc, src, rng.batch_seed(0, 99), cfg)
        rs = [cs._evented_batch(ck, lambda sd: ck.run_batch_col_tallies(
            d, sfc, src, sd, cfg), rng.batch_seed(0, b), name)[1]
            for b in range(3)]
        out[name] = {k: sum(r[k] for r in rs) / len(rs)
                     for k in ("kernel_ms_per_launch", "photons_per_s",
                               "launches", "busy")}
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
        lone = ", ".join(f"{k} {v:.1f}" for k, v in res["lone_ns"].items())
        print(f"{label} {root}: lone step ns ({lone}); headline "
              f"{res['headline']['kernel_ms_per_launch']:.4f} ms/launch, "
              f"{res['headline']['photons_per_s']:.6g} photons/s; deck "
              f"configuration {res['deck']['kernel_ms_per_launch']:.4f} "
              f"ms/launch, {res['deck']['photons_per_s']:.6g} photons/s; "
              "record deck batch (ms): " + ", ".join(
                  f"{k} {v:.4g}" for k, v in res["record_deck_batch"].items()),
              flush=True)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
