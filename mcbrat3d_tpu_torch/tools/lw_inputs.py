#!/usr/bin/env python3
"""Inputs of the non-separable broadband-LW deck ``run/broadband_lw.nml``.

    python3 mcbrat3d_tpu_torch/tools/lw_inputs.py [DIR]

Writes ``common.nc`` and ``ssp_thermal.nc`` into DIR (default: the current
directory): the LW flagship's physics (``scenes.collection.
lw_flagship_physical``: a cloud of 3 Reff keys with volExt and Legendre
rows plus an absXsec gas, 64 bins over 8-13 um) on 32 x 32 x 24 cells of
0.1 x 0.1 x 0.25 km, the cloud at levels 9-14, and temperatures of the
lapse profile plus a +-2 K jitter in every cell, drawn from seed 0. The reader rebuilds
the gas number density from the per-level pressures and those 3D
temperatures, so no bin is separable: every bin takes the generic per-bin
build and the per-voxel emission source, which the record kernel runs
(24,576 cells, within its 36,864-cell envelope). Built on the host: the
files are all it makes.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

# the deck's scene (32 x 32 x 24, 0.1 x 0.1 x 0.25 km, cloud at levels 9-14)
SCENE = dict(nx=32, ny=32, nz=24, dx=0.1, dy=0.1, dz=0.25,
             cloud_base_level=9, cloud_top_level=14)
JITTER_K = 2.0
JITTER_SEED = 0


def write_lw_broadband_inputs(directory=".", **kw):
    """Write the deck's ``common.nc`` and ``ssp_thermal.nc`` into
    ``directory`` and return their paths. ``kw`` overrides ``SCENE`` and
    the other arguments of ``lw_flagship_physical`` (tests cut the grid and
    the bins)."""
    from mcbrat3d_tpu_torch.domain.common import write_common
    from mcbrat3d_tpu_torch.domain.ssp import write_ssp_table
    from mcbrat3d_tpu_torch.scenes.collection import lw_flagship_physical

    common, tbl, pressure_hpa = lw_flagship_physical(
        **{**SCENE, "device": "cpu", **kw})
    rs = np.random.RandomState(JITTER_SEED)
    common.temps = common.temps + rs.uniform(-JITTER_K, JITTER_K,
                                             common.temps.shape)
    os.makedirs(directory, exist_ok=True)
    common_path = os.path.join(directory, "common.nc")
    ssp_path = os.path.join(directory, "ssp_thermal.nc")
    write_common(common_path, common, pressure_hpa=pressure_hpa)
    write_ssp_table(ssp_path, tbl)
    return common_path, ssp_path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("directory", nargs="?", default=".")
    args = ap.parse_args()
    for p in write_lw_broadband_inputs(args.directory):
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
