"""Rank functions for ``tests/test_torch_parallel.py``, run by
``mcbrat3d_tpu_torch.parallel.launch.spawn`` on gloo ranks on the CPU.

Kept out of the test module so that a rank imports the port alone, never
JAX. Every rank returns numpy arrays and Python numbers. Besides its
sharded runs, each rank runs the plain serial sub-batch of its neighbour's
stream (rank (d + 1) % n's, through ``run_batch`` with no group), so the
serial references of a run come from the other processes and the ranks
work in parallel.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.parallel.mesh import (COUNT_FIELDS, TALLY_FIELDS,
                                              make_mesh, run_batch_sharded)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.plane_parallel import make_slab
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

# tests/test_parallel.py's cases, at 256 lanes a rank
STEP = dict(ssa=0.99, surface=0.2, mu=0.5, seed=11, batch=3)
CONSERVATION = dict(ssa=1.0, surface=0.0, mu=0.866, seed=0, batch=0)
N_REQUESTED = 1234
CHUNK_DIRS = ([1.0, 0.8, 0.6, 0.45], [0.0, 90.0, 180.0, 315.0])
# tests/test_multihost.py's case
MULTIHOST = KernelConfig(n_lanes=128, photons_per_lane=4, max_steps=4000)


def config(use_pallas, n_lanes=256, photons_per_lane=1):
    return KernelConfig(n_lanes=n_lanes, photons_per_lane=photons_per_lane,
                        max_steps=4000, use_pallas=use_pallas)


def step_case(device, case, **build):
    dom = make_step_cloud(ssa=case["ssa"], device=device, **build)
    return (dom, Surface.lambertian(case["surface"]),
            illumination.directional(case["mu"], 0.0))


def host(t) -> dict:
    """A Tallies as numpy arrays and ints (None fields left out)."""
    out = {k: getattr(t, k).cpu().numpy() for k in TALLY_FIELDS
           if getattr(t, k) is not None}
    out.update({k: int(getattr(t, k)) for k in COUNT_FIELDS})
    return out


def neighbour_batch(dom, sfc, src, seed, batch, cfg, mesh, **kw):
    """The plain serial sub-batch of rank (d + 1) % n's stream."""
    stream = batch * mesh.size + (mesh.rank + 1) % mesh.size
    return stream, host(run_batch(dom, sfc, src, rng.batch_seed(seed, stream),
                                  cfg, key=rng.batch_key(seed, stream), **kw))


def two_rank_cases(device, deck_dir):
    """Every 2-rank case of the test module, on one group."""
    mesh = make_mesh()
    out = {"mesh": (mesh.rank, mesh.size, str(mesh.device))}
    dom, sfc, src = step_case(device, STEP)
    for kernel, use_pallas in (("wave", "off"), ("k1", "on")):
        cfg = config(use_pallas)
        out[kernel] = host(run_batch_sharded(dom, sfc, src, STEP["seed"],
                                             STEP["batch"], cfg, mesh))
        out[kernel + "_serial"] = neighbour_batch(
            dom, sfc, src, STEP["seed"], STEP["batch"], cfg, mesh)
    out["conservation"] = host(run_batch_sharded(
        *step_case(device, CONSERVATION), CONSERVATION["seed"],
        CONSERVATION["batch"], config("on"), mesh))
    out["n_requested"] = host(run_batch_sharded(
        make_slab(tau=1.0, ssa=1.0, n_cdf_steps=201, device=device),
        Surface.lambertian(0.0), illumination.directional(1.0, 0.0), 0, 0,
        config("auto", photons_per_lane=4), mesh, n_photons=N_REQUESTED))
    out["chunked"] = chunked_radiance(device, mesh)
    out["run_simulation"] = run_simulation_case(device, mesh)
    out["broadband"] = broadband_case(device, mesh, deck_dir)
    out["cli"] = cli_case(deck_dir)
    return out


def chunked_radiance(device, mesh):
    """tests/test_parallel.py::test_sharded_dir_chunked_radiance with
    MAX_KERNEL_DIRS 2: four directions in two chunked passes, and the last
    two directions alone (on a slab of optical depth 1, whose short paths
    keep the record kernel's plain radiance step quick)."""
    dom = make_slab(tau=1.0, ssa=0.99, n_cdf_steps=201,
                    compute_intensity_tables=True, device=device)
    sfc, src = Surface.lambertian(0.2), illumination.directional(0.5, 0.0)
    dirs = le.make_intensity_directions(*CHUNK_DIRS, device=device)
    cfg = config("on", n_lanes=128)
    icfg = le.IntensityConfig(n_dirs=4, use_russian_roulette=False,
                              use_hybrid_phase=False, pallas_min_mu=0.4)
    cap, le.MAX_KERNEL_DIRS = le.MAX_KERNEL_DIRS, 2
    try:
        four = run_batch_sharded(dom, sfc, src, 7, 0, cfg, mesh, icfg, dirs)
        two = run_batch_sharded(dom, sfc, src, 7, 0, cfg, mesh,
                                dataclasses.replace(icfg, n_dirs=2),
                                dirs[:, 2:])
    finally:
        le.MAX_KERNEL_DIRS = cap
    return host(four), host(two)


def step_config(**kw):
    from mcbrat3d_tpu_torch.driver.config import SimulationConfig
    base = dict(num_photons_per_batch=501, num_batches=2, iseed=7,
                n_lanes=256, n_phase_intervals=501,
                report_volume_absorption=True)
    base.update(kw)
    return SimulationConfig(**base)


def results(res) -> dict:
    return dict(mean={k: np.asarray(v) for k, v in res.mean.items()},
                stderr={k: np.asarray(v) for k, v in res.stderr.items()},
                total_photons=res.total_photons, n_batches=res.n_batches,
                n_bad=res.n_bad)


def run_simulation_case(device, mesh):
    """The step cloud through run_simulation over the group (501 photons a
    batch: 251 on rank 0, 250 on rank 1), checkpointing every batch."""
    from mcbrat3d_tpu_torch.driver.run import run_simulation
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=501, device=device)
    chunks = []
    res = run_simulation(dom, Surface.lambertian(0.0),
                         illumination.directional(0.5, 0.0),
                         step_config(checkpoint_every_batches=1), mesh=mesh,
                         checkpoint_cb=lambda b, acc, chunk:
                         chunks.append((b, chunk)))
    return results(res), chunks


def broadband_deck(deck_dir):
    from mcbrat3d_tpu_torch.driver.config import load_config
    return load_config(f"{deck_dir}/sw.nml")


def broadband_case(device, mesh, deck_dir):
    from mcbrat3d_tpu_torch.spectral import broadband
    return results(broadband.run_broadband(broadband_deck(deck_dir), device,
                                           mesh=mesh))


def cli_case(deck_dir):
    """The step-cloud deck through the command line under the group
    (mesh "auto"): the JSON line printed and the output writes made on
    this rank."""
    from mcbrat3d_tpu_torch.driver import cli, simulate

    writes, write_all = [], simulate.output_mod.write_all

    def counting(*args, **kwargs):
        writes.append(1)
        return write_all(*args, **kwargs)

    simulate.output_mod.write_all = counting
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", f"{deck_dir}/step.nml", "--device", "cpu"])
    finally:
        simulate.output_mod.write_all = write_all
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    return rc, lines, len(writes)


def four_rank_cases(device):
    """tests/test_multihost.py's cases over four ranks: the global batch
    each rank holds, its neighbour's plain sub-batch and a host moment
    accumulator over that sub-batch (a batch of this process alone)."""
    from mcbrat3d_tpu_torch.core.accumulate import MomentAccumulator
    mesh = make_mesh()
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=501, device=device)
    sfc, src = Surface.lambertian(0.2), illumination.directional(0.5, 0.0)
    t = host(run_batch_sharded(dom, sfc, src, 7, 0, MULTIHOST, mesh))
    stream, local = neighbour_batch(dom, sfc, src, 7, 0, MULTIHOST, mesh)
    acc = MomentAccumulator()
    acc.add(float(local["n_photons"]),
            {"flux_up": local["flux_up"].astype(np.float64)
             / local["n_photons"]})
    return t, (stream, local), acc.state_dict()


def fail_on_rank_one(device):
    """Rank 1 raises; rank 0 waits at a barrier it would never pass."""
    from mcbrat3d_tpu_torch.parallel import distributed
    if distributed.rank() == 1:
        raise RuntimeError("rank 1 stops here")
    distributed.synchronize()
