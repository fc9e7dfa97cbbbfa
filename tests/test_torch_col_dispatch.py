"""PyTorch port: the column-template kernel (K3) in the dispatch and the
command line. The kernel the port's ``run_batch`` picks for a column
template against the JAX package's own choice (every source, with and
without the absorption profile, inside and past the record kernel's cell
count), the broken-cloud domain file of ``mkdomain`` against the JAX
package's, and the Landsat-scale flux and radiance decks through the
port's command line on the CPU. The plain step against the JAX column
kernel is in ``test_torch_col_kernel.py``.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.driver import output as joutput
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.driver.run import Results as JResults
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.tools import scene_cli as jscene_cli
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu.transport import pallas_tile as jtile
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

from test_torch_col_kernel import ROOT, SOURCES, both_domains, column_field

torch.set_num_threads(1)


class _Picked(Exception):
    pass


def _picker(name):
    def pick(*args, **kwargs):
        raise _Picked(name)
    return pick


DISPATCH_CASES = [
    ((64, 32, 32), False), ((64, 32, 32), True),
    ((24, 24, 40), False), ((24, 24, 40), True),
]


def _picks(monkeypatch, shape, profile, source):
    """(JAX package's kernel, port's kernel) for one column-template domain
    (use_pallas="on", the choice taken at trace time, no kernel run)."""
    jd, td = both_domains(column_field(*shape), 8, n_cdf_steps=101)
    for mod, fn, name in ((jpk, "run_batch_pallas_tallies", "record"),
                          (jpc, "run_batch_pallas_col_tallies", "column"),
                          (jsep, "run_batch_pallas_sep_tallies", "separable"),
                          (jtile, "run_batch_pallas_tile_tallies", "tiled"),
                          (rk, "run_batch_record_tallies", "record"),
                          (ck, "run_batch_col_tallies", "column")):
        monkeypatch.setattr(mod, fn, _picker(name))
    kw = dict(n_lanes=1024, photons_per_lane=1, need_volume_absorption=False,
              need_absorption_profile=profile)
    tsrc, jsrc = SOURCES[source]
    with pytest.raises(_Picked) as jax_pick:
        jintegrator.run_batch(jd, JSurface.lambertian(0.2), jsrc(),
                              jrng.batch_key(0, 0),
                              jintegrator.KernelConfig(use_pallas="on", **kw))
    with pytest.raises(_Picked) as port_pick:
        run_batch(td, Surface.lambertian(0.2), tsrc(), 0, KernelConfig(**kw))
    return str(jax_pick.value), str(port_pick.value)


@pytest.mark.parametrize("shape,profile", DISPATCH_CASES)
def test_dispatch_picks_the_kernel_jax_picks(monkeypatch, shape, profile):
    """Past the record kernel's cell count the column kernel takes the
    domain; inside it, past 16,384 cells and without the 3D tally or the
    profile, the JAX package skips the record kernel and takes K3 before
    K5 -- the port must choose as the JAX package does."""
    jax_pick, port_pick = _picks(monkeypatch, shape, profile, "directional")
    assert port_pick == jax_pick
    n_cells = np.prod(shape)
    expect = ("column" if n_cells > rk.MAX_CELLS or not profile
              else "record")
    assert port_pick == expect


@pytest.mark.parametrize("source", ["random_azimuth", "flux"])
@pytest.mark.parametrize("shape,profile", DISPATCH_CASES)
def test_dispatch_of_the_other_sources(monkeypatch, shape, profile, source):
    """A random-azimuth or flux source on a column-template domain goes
    where the JAX package sends it: its record kernel inside its cell count
    with the profile, the column kernel everywhere else."""
    jax_pick, port_pick = _picks(monkeypatch, shape, profile, source)
    assert port_pick == jax_pick
    k1_in_jax = np.prod(shape) <= rk.MAX_CELLS and profile
    assert jax_pick == ("record" if k1_in_jax else "column")


def test_mkdomain_broken_cloud_matches_the_jax_file(tmp_path, capsys):
    params = ["nx=32", "ny=24", "nz=16", "seed=2"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(["mkdomain", "broken_cloud", "port.dom",
                         *params]) == 0
        assert jscene_cli.main("broken_cloud", "jax.dom", params) == 0
    finally:
        os.chdir(cwd)
    pg, pc_, pt, pa = jio.read_domain(str(tmp_path / "port.dom"))
    jg, jc, jt, ja = jio.read_domain(str(tmp_path / "jax.dom"))
    for a, b in zip(pg.edges_np(), jg.edges_np()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt, jt)
    assert sorted(pa) == sorted(ja)
    for k in pa:
        np.testing.assert_array_equal(pa[k], ja[k])
    assert len(pc_) == len(jc) == 1
    for a, b in zip(pc_, jc):
        for f in ("extinction", "single_scattering_albedo",
                  "phase_function_index"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for pa_, pb_ in zip(a.phase_function_table.phase_functions,
                            b.phase_function_table.phase_functions):
            np.testing.assert_array_equal(pa_.coefficients, pb_.coefficients)
    # the default scene is a column template in the port as in JAX
    grid, comps, _ = broken_cloud_scene(nx=32, ny=24, nz=16, seed=2,
                                        device="cpu")
    assert build_domain(grid, comps, n_cdf_steps=101).col_template


def test_landsat_deck_through_the_cli(tmp_path, capsys):
    """run/landsat_scale.nml cut to 2 x 4,096 photons, on the CPU: the
    column kernel's plain step runs it, and the flux file and the netCDF
    file equal what the JAX writers make of the same numbers."""
    with open(os.path.join(ROOT, "run", "landsat_scale.nml")) as f:
        text = f.read()
    text = text.replace("numPhotonsPerBatch = 1048576",
                        "numPhotonsPerBatch = 4096")
    text = text.replace("numBatches = 16", "numBatches = 2")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    calls = []
    plain = ck.col_launch_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    ck.col_launch_plain = counting
    try:
        assert cli.main(["mkdomain", "broken_cloud", "BrokenCloud.dom"]) == 0
        with open("deck.nml", "w") as f:
            f.write(text)
        capsys.readouterr()
        assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        ck.col_launch_plain = plain
        os.chdir(cwd)
    assert calls, "the deck did not run the column kernel's plain step"
    assert out["total_photons"] == 2 * 4096 and out["n_bad"] == 0
    assert sorted(out["outputs"]) == ["landsat_flux.out",
                                      "landsat_results.nc"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    assert all(0 < v < 1 for v in rta)
    cfg = jload(str(tmp_path / "deck.nml"))
    mean, err = {}, {}
    with netcdf_file(str(tmp_path / "landsat_results.nc"), "r",
                     mmap=False) as nc:
        v = nc.variables
        assert "absorbedVolume" not in v  # reportVolumeAbsorption off
        for key, name in (("flux_up", "fluxUp"), ("flux_down", "fluxDown"),
                          ("flux_absorbed", "fluxAbsorbed"),
                          ("absorption_profile", "absorptionProfile")):
            mean[key] = np.array(v[name][:]).T
            err[key] = np.array(v[name + "_StdErr"][:]).T
        total, n_batches = int(nc.totalPhotons), int(nc.numBatches)
    assert mean["absorption_profile"].shape == (64,)
    # the profile is the horizontal mean of W m^-3: its column integral
    # (dz = 20 in km -> m) is the domain-mean absorption
    assert float(mean["absorption_profile"].sum()) * 20.0 * 1000.0 == \
        pytest.approx(out["mean_flux_absorbed"], rel=1e-5)
    with open(tmp_path / "landsat_flux.out") as f:
        means = [ln for ln in f if not ln.startswith("!")][0].split()
    for i, key in enumerate(("mean_flux_up", "mean_flux_down",
                             "mean_flux_absorbed")):
        mean[key], err[key] = float(means[2 * i]), float(means[2 * i + 1])
    results = JResults(mean=mean, stderr=err, total_photons=total,
                       n_batches=n_batches, solar_flux=1.0,
                       elapsed_seconds=0.0, config=cfg)
    grid = jio.read_domain(str(tmp_path / "BrokenCloud.dom"))[0]
    jdir = tmp_path / "jax"
    jdir.mkdir()
    os.chdir(jdir)
    try:
        written = joutput.write_all(results, grid)
    finally:
        os.chdir(cwd)
    assert sorted(written) == sorted(out["outputs"])
    with open(tmp_path / "landsat_flux.out") as f:
        port_text = f.read()
    with open(jdir / "landsat_flux.out") as f:
        assert port_text == f.read()
    with netcdf_file(str(tmp_path / "landsat_results.nc"), "r",
                     mmap=False) as a, \
            netcdf_file(str(jdir / "landsat_results.nc"), "r",
                        mmap=False) as b:
        assert dict(a.dimensions) == dict(b.dimensions)
        assert sorted(a.variables) == sorted(b.variables)
        for name in a.variables:
            np.testing.assert_array_equal(a.variables[name][:],
                                          b.variables[name][:])


def test_landsat_radiance_deck_through_the_cli(tmp_path, capsys):
    """run/landsat_radiance.nml on a 64 x 64 x 16 cut of the broken cloud
    (65,536 cells: past the record kernel's 36,864, so the column kernel
    takes it, as it takes the deck) with 2 x 2,048 photons, on the CPU: the
    column kernel's plain step runs the local estimate (16 directions) and
    the radiance file carries the [16 directions][64 x 64] image."""
    with open(os.path.join(ROOT, "run", "landsat_radiance.nml")) as f:
        text = f.read()
    text = text.replace("numPhotonsPerBatch = 262144",
                        "numPhotonsPerBatch = 2048")
    text = text.replace("numBatches = 8", "numBatches = 2")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    dirs_seen = []
    plain = ck.col_launch_plain

    def counting(st, tab, prm, *args, **kwargs):
        dirs_seen.append(prm.n_dirs)
        return plain(st, tab, prm, *args, **kwargs)

    ck.col_launch_plain = counting
    try:
        assert cli.main(["mkdomain", "broken_cloud", "BrokenCloud.dom",
                         "nx=64", "ny=64", "nz=16"]) == 0
        with open("deck.nml", "w") as f:
            f.write(text)
        capsys.readouterr()
        assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        ck.col_launch_plain = plain
        os.chdir(cwd)
    assert dirs_seen and set(dirs_seen) == {16}, dirs_seen
    assert out["total_photons"] == 2 * 2048 and out["n_bad"] == 0
    assert out["launches"]["col_kernel_radiance"] == 0  # no card here
    assert sorted(out["outputs"]) == ["landsat_radiance.nc",
                                      "landsat_radiance.out",
                                      "landsat_radiance_flux.out"]
    assert len(out["mean_intensity"]) == 16
    assert all(0 < v < 1 for v in out["mean_intensity"])
    with netcdf_file(str(tmp_path / "landsat_radiance.nc"), "r",
                     mmap=False) as nc:
        assert nc.variables["intensity"].shape == (16, 64, 64)
        np.testing.assert_allclose(nc.variables["intensityMus"][:],
                                   [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45,
                                    0.4] * 2, rtol=1e-6)
    with open(tmp_path / "landsat_radiance.out") as f:
        rows = [ln for ln in f if not ln.startswith(("!", "#"))]
    assert len(rows) == 16 * 64 * 64
