"""PyTorch port: the record kernel's 3-component deck through the command
line, and the public builders' device. run/step_cloud_multi3_mono.nml, cut
to 2 x 512 photons, runs on the record kernel's plain step on the CPU and
its means equal a direct run_batch of the same batches; every public
builder called without ``device`` builds on the card and raises where
there is none. The record kernel's envelope against the JAX kernel is in
``test_torch_record_envelope.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain import common, io_netcdf
from mcbrat3d_tpu_torch.domain.domain import build_domain, domain_from_numpy
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes import collection, plane_parallel
from mcbrat3d_tpu_torch.scenes.step_cloud import (make_step_cloud,
                                                  make_step_cloud_multi,
                                                  step_cloud_multi_scene,
                                                  step_cloud_scene)
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import run_batch

from test_torch_record_envelope import jax_arrays

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_three_component_deck_through_the_cli(tmp_path, capsys,
                                              monkeypatch):
    """run/step_cloud_multi3_mono.nml, cut to 2 x 512 photons, through the
    port's command line on the CPU on the file its header writes: the
    record kernel's plain step, the tabulated branch with three stacked
    rows, no new option; the means equal a direct run_batch of the same
    batches."""
    grid, comps, temps = step_cloud_multi_scene(analytic=False, device="cpu")
    io_netcdf.write_domain(str(tmp_path / "StepCloudMulti3.dom"), grid,
                           comps, temps=temps)
    with open(os.path.join(ROOT, "run", "step_cloud_multi3_mono.nml")) as f:
        deck = (f.read().replace("numPhotonsPerBatch = 1048576",
                                 "numPhotonsPerBatch = 512")
                .replace("numBatches = 16", "numBatches = 2")
                .replace("nPhaseIntervals = 10001", "nPhaseIntervals = 501"))
    (tmp_path / "deck.nml").write_text(deck)
    monkeypatch.chdir(tmp_path)
    plain = []
    orig = rk.record_launch_plain

    def counting(*args, **kwargs):
        plain.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(rk, "record_launch_plain", counting)
    capsys.readouterr()
    assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["total_photons"] == 1024 and out["n_bad"] == 0
    assert plain and out["tile_passes"] == 0
    assert sorted(out["outputs"]) == ["StepCloudMulti3_flux.out",
                                      "StepCloudMulti3_results.nc"]

    from mcbrat3d_tpu_torch.driver.config import load_config
    from mcbrat3d_tpu_torch.driver.run import kernel_config_from
    cfg = load_config("deck.nml")
    assert cfg.macro_factor == 8 and cfg.report_volume_absorption
    g2, c2, t2, _ = io_netcdf.read_domain("StepCloudMulti3.dom",
                                          device="cpu")
    dom = build_domain(g2, c2, temps=t2, n_cdf_steps=cfg.n_phase_intervals,
                       macro_factor=cfg.macro_factor)
    assert dom.n_components == 3 and not dom.all_hg
    assert dom.tables.inverse.shape[0] == 3
    src = illumination.directional(cfg.solar_mu, cfg.solar_azimuth)
    kcfg = kernel_config_from(cfg)
    rta_b = []
    for b in range(2):
        t = run_batch(dom, Surface.lambertian(0.0), src,
                      rng.batch_seed(cfg.iseed, b), kcfg,
                      n_photons=cfg.num_photons_per_batch)
        rta_b.append([float(a.sum()) / t.n_photons for a in
                      (t.flux_up, t.flux_down, t.flux_absorbed)])
    want = np.mean(rta_b, axis=0)
    got = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _files(tmp_path):
    g, c, t = step_cloud_scene(device="cpu")
    io_netcdf.write_domain(str(tmp_path / "d.dom"), g, c, temps=t)
    collection.write_lw_flagship_inputs(
        str(tmp_path / "common.nc"), str(tmp_path / "ssp.nc"), nx=4, ny=4,
        nz=150, n_lambda=2)
    return tmp_path


BUILDERS = {
    "Grid.regular": lambda p: Grid.regular(4, 4, 4, 0.1, 0.1, 0.1),
    "Grid.from_edges": lambda p: Grid.from_edges(
        np.arange(5.0), np.arange(5.0), np.arange(5.0)),
    "step_cloud_scene": lambda p: step_cloud_scene(),
    "make_step_cloud": lambda p: make_step_cloud(n_cdf_steps=11),
    "step_cloud_multi_scene": lambda p: step_cloud_multi_scene(),
    "make_step_cloud_multi": lambda p: make_step_cloud_multi(
        n_cdf_steps=11),
    "broken_cloud_scene": lambda p: collection.broken_cloud_scene(8, 8, 4),
    "dense_cloud_scene": lambda p: collection.dense_cloud_scene(8, 8, 4),
    "lw_flagship_scene": lambda p: collection.lw_flagship_scene(4, 4, 150),
    "lw_flagship_physical": lambda p: collection.lw_flagship_physical(
        4, 4, 150, n_lambda=2),
    "plane_parallel_scene": lambda p: plane_parallel.plane_parallel_scene(),
    "make_slab": lambda p: plane_parallel.make_slab(n_cdf_steps=11),
    "domain_from_numpy": lambda p: domain_from_numpy(
        jax_arrays(jmake(n_cdf_steps=11))),
    "read_domain": lambda p: io_netcdf.read_domain(str(p / "d.dom")),
    "read_common": lambda p: common.read_common(str(p / "common.nc")),
    "make_intensity_directions": lambda p: le.make_intensity_directions(
        [1.0], [0.0]),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builders_default_to_the_card(tmp_path, builder):
    """Called without ``device``, each public builder builds on the card,
    and raises where there is none: no silent CPU fallback."""
    build = BUILDERS[builder]
    path = _files(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(path)
        return
    out = build(path)
    if isinstance(out, tuple):
        out = out[0]
    device = out.device if hasattr(out, "device") else out.grid.device
    assert device.type == "cuda"
