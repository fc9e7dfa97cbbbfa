"""Scene-generator command line: ``mkdomain <scene> <out.nc> k=v ...``.

PyTorch-port counterpart of ``mcbrat3d_tpu.tools.scene_cli``, the
reference's Domain-Files generator programs (reference:
Domain-Files/i3rcStepCloud.f95 etc.): every scene the JAX package
registers, written as a reference-schema domain file. The scene is only
written to the file, so it is built on the host (``device=cpu`` unless a
parameter says otherwise).
"""

from __future__ import annotations

from mcbrat3d_tpu_torch.domain import io_netcdf
from mcbrat3d_tpu_torch.scenes import collection
from mcbrat3d_tpu_torch.scenes.plane_parallel import plane_parallel_scene
from mcbrat3d_tpu_torch.scenes.step_cloud import step_cloud_scene

SCENES = {
    "step_cloud": step_cloud_scene,
    "plane_parallel": plane_parallel_scene,
    "step_cloud_2tau": collection.step_cloud_2tau_scene,
    "cubic": collection.cubic_cloud_scene,
    "homog_bb": collection.homog_bb_scene,
    "inhomog_bb": collection.inhomog_bb_scene,
    "landsat": collection.landsat_cloud_scene,
    "radar": collection.radar_cloud_scene,
    "broken_cloud": collection.broken_cloud_scene,
}


def _parse_params(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def main(scene: str, output: str, params=None) -> int:
    if scene not in SCENES:
        print(f"unknown scene {scene!r}; available: {sorted(SCENES)}")
        return 2
    kw = {"device": "cpu", **_parse_params(params)}
    grid, components, temps = SCENES[scene](**kw)
    io_netcdf.write_domain(output, grid, components, temps=temps)
    print(f"wrote {output}")
    return 0
