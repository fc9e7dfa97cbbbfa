"""Start a group of ranks from one process, and the multi-rank dry run.

``spawn`` is what ``torchrun`` does for a command line, for a Python
function: it starts the ranks as fresh processes
(``torch.multiprocessing.spawn``), joins each to one group over a file
store in a temporary directory and returns what each rank's function
returned. Every rank may be given the same device, so gloo ranks can share
one card or the CPU; NCCL refuses two ranks on one card
(``distributed.initialize``). ``dryrun_multichip`` is the counterpart of
``__graft_entry__.py``'s.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import torch.multiprocessing as mp


def spawn(fn, n_ranks: int, device, backend=None, args=(),
          timeout: float = 600.0) -> list:
    """Run ``fn(device, *args)`` on ``n_ranks`` new processes, each a rank
    of one group on ``device`` (``distributed.initialize``; the backend is
    ``backend``, else NCCL on a CUDA device and gloo on the CPU), and
    return the ranks' return values in rank order (they must pickle). Each
    rank sees torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` 0, ``LOCAL_WORLD_SIZE``) and runs one host thread
    (``torch.set_num_threads(1)``: the ranks share a host). A rank that
    raises or dies makes ``torch.multiprocessing`` stop the others, and
    this raises ``RuntimeError`` with the traceback of every rank that
    raised; ranks not done within ``timeout`` seconds are killed and this
    raises too."""
    store = tempfile.mkdtemp(prefix="mcb_group_")
    ctx = None
    try:
        ctx = mp.spawn(_rank_main, args=(fn, args, n_ranks, store,
                                         str(device), backend),
                       nprocs=n_ranks, join=False)
        deadline = time.monotonic() + timeout
        try:
            # join returns early each time one rank ends well
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"ranks not done within {timeout} s: "
                        f"{[p.pid for p in ctx.processes if p.is_alive()]}")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # every rank that raised: the first one seen may only have
            # lost its peer
            raise RuntimeError(f"rank {e.error_index} of {n_ranks} failed:"
                               f"\n{e}" + "".join(
                                   f"\nrank {r}:\n{tb}" for r, tb in
                                   _tracebacks(ctx) if r != e.error_index)
                               ) from e
        out = []
        for r in range(n_ranks):
            with open(_result_path(store, r), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for path in ctx.error_files:
                if os.path.exists(path):
                    os.remove(path)
        shutil.rmtree(store, ignore_errors=True)


def _tracebacks(ctx):
    """(rank, traceback) of each rank that raised, from the error files
    ``torch.multiprocessing`` keeps."""
    out = []
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, "rb") as f:
                out.append((r, pickle.load(f)))
    return out


def _result_path(store, rank):
    return os.path.join(store, f"rank{rank}.pkl")


def _rank_main(rank, fn, args, n_ranks, store, device, backend):
    """One rank: join the group, run ``fn``, write its value to the store
    directory, leave the group (an exception reaches the parent through
    ``torch.multiprocessing``)."""
    import torch

    from mcbrat3d_tpu_torch.parallel import distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n_ranks),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(n_ranks))
    torch.set_num_threads(1)
    try:
        dev = distributed.initialize(
            init_method="file://" + os.path.join(store, "store"),
            world_size=n_ranks, rank=rank, backend=backend, device=device)
        value = fn(dev, *args)
        with open(_result_path(store, rank), "wb") as f:
            pickle.dump(value, f)
    finally:
        distributed.shutdown()


def _dryrun_rank(device):
    from mcbrat3d_tpu_torch.parallel.mesh import make_mesh, run_batch_sharded
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

    domain = make_step_cloud(ssa=0.99, n_cdf_steps=501, device=device)
    config = KernelConfig(n_lanes=256, photons_per_lane=1, max_steps=2000)
    t = run_batch_sharded(domain, Surface.lambertian(0.2),
                          illumination.directional(0.5, 0.0), seed=0,
                          global_batch=0, config=config, mesh=make_mesh())
    total = (float(t.flux_up.sum()) + float(t.flux_down.sum())
             + float(t.flux_absorbed.sum()))
    return int(t.n_photons), total, config.photons_per_batch, str(device)


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> None:
    """One global batch of the step cloud (256 lanes x 1 photon a rank,
    2,000 steps, albedo 0.2, mu 0.5) over ``n_devices`` spawned ranks on
    ``device``, as ``__graft_entry__.dryrun_multichip`` runs it over a
    device mesh: asserts every rank's photon count and a balance within
    0.25 (albedo 0.2: most photons are conserved)."""
    outs = spawn(_dryrun_rank, n_devices, device, backend=backend)
    for n, total, per_rank, _ in outs:
        assert n == n_devices * per_rank, (n, n_devices)
        assert abs(total / n - 1.0) < 0.25, total
    n, total = outs[0][:2]
    print(f"dryrun_multichip({n_devices}): OK, {n} photons, "
          f"balance={total / n:.4f}, ranks on "
          f"{sorted({o[3] for o in outs})}")
