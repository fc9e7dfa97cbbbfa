"""PyTorch port: the shortwave broadband path and the scattering-order
output against the JAX package.

The solar source and spectral response readers and ``solar_weighting``
equal JAX's bit for bit; a 4-bin, 8 x 8 x 8 cut of ``run/broadband_sw.nml``
(the port's ``tools/sw_inputs.py``) runs through both packages'
``run_broadband`` with ``usePallas = 'off'``, photon for photon on the wave
kernel (equal schedule, batches and incident flux; fluxes within the wave
kernel tests' tolerances, see ``tests/test_torch_wave_kernel.py``), and
with ``'auto'`` every bin runs on the record kernel (K1) and none on the
wave kernel. A deck with ``numRecScatOrd`` through the port's command
line writes the ``auxhist01`` file that JAX's writer makes of JAX's run
of the deck (its ``run_simulation`` on one device, as its command line
runs outside the tests' 8-device mesh), the fluxes within those
tolerances.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.domain.domain import build_domain as jbuild_domain
from mcbrat3d_tpu.driver import output as jout
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.driver.run import run_simulation as jrun_simulation
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.spectral import broadband as jbb
from mcbrat3d_tpu.spectral import solar as jsolar
from mcbrat3d_tpu.spectral import weights as jweights
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.driver.config import load_config
from mcbrat3d_tpu_torch.spectral import broadband, solar, weights
from mcbrat3d_tpu_torch.tools.sw_inputs import write_sw_broadband_inputs
from mcbrat3d_tpu_torch.transport import integrator
from mcbrat3d_tpu_torch.transport import record_kernel as rk

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
L1_GAP = 1e-2
MEAN_GAP = 2e-3


@pytest.fixture(scope="module")
def sw_dir(tmp_path_factory):
    """The deck's inputs cut to 8 x 8 x 8 cells and 4 bins, and the deck
    cut to 2 x 2,048 photons on 1,024 lanes with 201 CDF steps."""
    d = tmp_path_factory.mktemp("sw")
    write_sw_broadband_inputs(str(d), n=8, n_lambda=4)
    with open(os.path.join(ROOT, "run", "broadband_sw.nml")) as f:
        deck = f.read()
    for a, b in (("numLambda = 16", "numLambda = 4"),
                 ("numPhotonsPerBatch = 262144", "numPhotonsPerBatch = 2048"),
                 ("numBatches = 16", "numBatches = 2"),
                 ("nPhaseIntervals = 9001", "nPhaseIntervals = 201"),
                 ("nLanes = 65536", "nLanes = 1024"),
                 ("common_sw.nc", str(d / "common_sw.nc")),
                 ("ssp_solar.nc", str(d / "ssp_solar.nc")),
                 ("'solar.nc'", f"'{d / 'solar.nc'}'")):
        assert a in deck, a
        deck = deck.replace(a, b)
    (d / "deck.nml").write_text(deck)
    return d


def test_solar_files_and_weighting(tmp_path):
    lam = np.linspace(0.4, 1.0, 16)
    src = 1000.0 * np.exp(-((lam - 0.55) / 0.3) ** 2)
    srf = np.linspace(0.2, 1.0, 16) ** 2
    solar.write_solar_source(str(tmp_path / "s.nc"), lam, src)
    solar.write_spectral_response(str(tmp_path / "r.nc"), lam, srf)
    for a, b in zip(solar.read_solar_source(str(tmp_path / "s.nc"), 16),
                    jsolar.read_solar_source(str(tmp_path / "s.nc"), 16)):
        np.testing.assert_array_equal(a, b)
    got = solar.read_spectral_response(str(tmp_path / "r.nc"), 16)
    np.testing.assert_array_equal(
        got, jsolar.read_spectral_response(str(tmp_path / "r.nc"), 16))
    np.testing.assert_array_equal(got, srf)
    with pytest.raises(ValueError):
        solar.read_solar_source(str(tmp_path / "s.nc"), 8)
    for mu, r in ((0.5, None), (-0.3, srf), (1.0, got)):
        cdf, total = weights.solar_weighting(lam, src, mu, srf=r)
        jcdf, jtotal = jweights.solar_weighting(lam, src, mu, srf=r)
        np.testing.assert_array_equal(cdf, jcdf)
        assert total == jtotal


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).sum() <= L1_GAP * max(np.abs(a).sum(), 1e-12)


def test_sw_broadband_off_matches_jax(sw_dir):
    """usePallas = 'off' in both packages: the wave kernel on every bin,
    at JAX's batch keys."""
    deck = str(sw_dir / "deck.nml")
    cfg = dataclasses.replace(load_config(deck), use_pallas="off")
    jcfg = dataclasses.replace(jload(deck), use_pallas="off")
    before = integrator.WAVE_BATCHES
    res = broadband.run_broadband(cfg, "cpu")
    jres = jbb.run_broadband(jcfg)
    assert integrator.WAVE_BATCHES - before == res.n_batches
    assert (res.total_photons, res.n_batches) == (jres.total_photons,
                                                  jres.n_batches)
    assert res.solar_flux == jres.solar_flux
    assert res.n_bad == 0
    for k in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed"):
        assert abs(res.mean[k] - jres.mean[k]) <= MEAN_GAP * abs(
            jres.mean[k]), k
    for k in ("flux_up", "flux_down", "flux_absorbed", "volume_absorption"):
        _close(jres.mean[k], res.mean[k])


def test_sw_broadband_auto_runs_the_record_kernel(sw_dir, monkeypatch):
    """'auto': every bin (2 components, 512 cells) on K1, none on the wave
    kernel; the spectral response weights the schedule."""
    lam = np.linspace(0.4, 1.0, 4)
    solar.write_spectral_response(str(sw_dir / "srf.nc"), lam,
                                  np.linspace(1.0, 0.1, 4))
    cfg = dataclasses.replace(load_config(str(sw_dir / "deck.nml")),
                              instr_response_file=str(sw_dir / "srf.nc"))
    launches = []
    plain = rk.record_launch_plain

    def counting(*args, **kwargs):
        launches.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(rk, "record_launch_plain", counting)
    before = integrator.WAVE_BATCHES
    res = broadband.run_broadband(cfg, "cpu")
    assert integrator.WAVE_BATCHES == before
    assert len(launches) >= res.n_batches > 0
    assert res.n_bad == 0 and res.total_photons == 4096
    unweighted = broadband.run_broadband(
        dataclasses.replace(cfg, instr_response_file=""), "cpu")
    assert res.solar_flux < unweighted.solar_flux


def _aux_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    head = [ln for ln in lines if ln.startswith("!")]
    rows = np.array([[float(v) for v in ln.split()] for ln in lines
                     if not ln.startswith("!")])
    return head, rows


def test_cli_scattering_orders_aux_file(tmp_path, monkeypatch):
    """numRecScatOrd through the port's command line (no kernel tallies
    orders, so 'auto' runs the wave kernel) against JAX's run of the deck
    and its writer: the auxhist01 file's layout equals JAX's, its fluxes
    within the wave kernel's tolerances."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["mkdomain", "step_cloud", "StepCloud.dom",
                     "ssa=0.99"]) == 0
    with open(os.path.join(ROOT, "run", "step_cloud_mono.nml")) as f:
        deck = f.read()
    for a, b in (("numPhotonsPerBatch = 1048576",
                  "numPhotonsPerBatch = 4096"),
                 ("numBatches = 16", "numBatches = 2"),
                 ("nPhaseIntervals = 10001", "nPhaseIntervals = 201"),
                 ("useRussianRoulette = .true.",
                  "useRussianRoulette = .true.\n  nLanes = 2048"),
                 ("reportVolumeAbsorption = .true.",
                  "reportVolumeAbsorption = .true.\n  recScatOrd = .true.\n"
                  "  numRecScatOrd = 3\n  auxhist01_fluxFile = 'aux.out'")):
        assert a in deck, a
        deck = deck.replace(a, b)
    (tmp_path / "deck.nml").write_text(deck)
    before = integrator.WAVE_BATCHES
    assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
    assert integrator.WAVE_BATCHES - before == 2
    jcfg = jload("deck.nml")
    grid, comps, temps, attrs = jio.read_domain("StepCloud.dom")
    jdom = jbuild_domain(grid, comps, n_cdf_steps=jcfg.n_phase_intervals,
                         temps=temps, macro_factor=jcfg.macro_factor)
    jres = jrun_simulation(
        jdom, JSurface.lambertian(attrs.get("surface_albedo", 0.0)),
        jill.directional(jcfg.solar_mu, jcfg.solar_azimuth), jcfg)
    jout.write_aux_flux_by_order("jax_aux.out", jres, grid)
    head, rows = _aux_rows("aux.out")
    jhead, jrows = _aux_rows("jax_aux.out")
    assert head == jhead
    assert rows.shape == jrows.shape == (4 * 32, 7)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    for c in (3, 5):  # the up and down fluxes by order
        _close(jrows[:, c], rows[:, c])
