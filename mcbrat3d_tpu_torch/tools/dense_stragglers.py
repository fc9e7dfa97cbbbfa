#!/usr/bin/env python3
"""The photons that run/dense_cloud_mono.nml leaves alive at its step cap.

    python3 mcbrat3d_tpu_torch/tools/dense_stragglers.py [--batches N]

Runs the deck's batches (the dense scene written to and read back from a
domain file, 2,097,152 photons per batch, the deck's pool, step cap and
seeds) through the tiled kernel on the card and prints, for every batch
with n_bad > 0, the state (x, y, z, ux, uy, uz, w) of each photon still
alive at its end, then the card (nvidia-smi name and power limit). A
photon that leaves the surface with mu = 1e-6 (the reflection's floor,
taken when its uniform is exactly 0) stays in the clear bottom layer of
the scene for more steps than any cap allows.
"""

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from mcbrat3d_tpu_torch.core import rng  # noqa: E402
from mcbrat3d_tpu_torch.domain import io_netcdf  # noqa: E402
from mcbrat3d_tpu_torch.domain.domain import build_domain  # noqa: E402
from mcbrat3d_tpu_torch.physics.surface import Surface  # noqa: E402
from mcbrat3d_tpu_torch.scenes.collection import (  # noqa: E402
    dense_cloud_scene)
from mcbrat3d_tpu_torch.sources import illumination  # noqa: E402
from mcbrat3d_tpu_torch.transport import tile_kernel as tk  # noqa: E402
from mcbrat3d_tpu_torch.transport.integrator import (  # noqa: E402
    KernelConfig)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_stragglers: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "DenseCloud.dom")
        grid, comps, _ = dense_cloud_scene()
        io_netcdf.write_domain(path, grid, comps, surface_albedo=0.2)
        grid, comps, _, _ = io_netcdf.read_domain(path, device="cuda")
    # the deck's defaults: nPhaseIntervals 10001, macro factor 8, maxSteps
    # 100,000, iseed 10
    dom = build_domain(grid, comps, n_cdf_steps=10001, macro_factor=8)
    cfg = KernelConfig(n_lanes=262144, photons_per_lane=8, max_steps=100_000,
                       need_volume_absorption=False)
    nx, ny, nz = dom.grid.shape
    tx, ty, tz = tk.plan_for(dom)
    n_tiles = (nx // tx) * (ny // ty) * (nz // tz)
    last = []
    launch = tk._launch_cuda

    def keep_pool(pool, *a, **k):
        launch(pool, *a, **k)
        last[:] = [pool]

    tk._launch_cuda = keep_pool
    try:
        for b in range(args.batches):
            t = tk.run_batch_tile_tallies(
                dom, Surface.lambertian(0.2),
                illumination.directional(0.5, 0.0), rng.batch_seed(10, b),
                cfg, n_photons=2_097_152)
            if t.n_bad:
                pool = last[0]
                alive = torch.nonzero(pool.tile < n_tiles).squeeze(1)
                print(f"batch {b}: n_bad {t.n_bad}, {t.n_passes} passes; "
                      "alive (x, y, z, ux, uy, uz, w): "
                      f"{pool.st[:, alive].T.tolist()}", flush=True)
    finally:
        tk._launch_cuda = launch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
