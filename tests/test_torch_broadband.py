"""PyTorch port: the broadband-LW path against the JAX package.

The host modules the flagship deck runs (physical-properties and SSP files,
the separable bin plan, the LW setup fluxes and the photon schedule, the
moment accumulators) equal the JAX package's, the flagship generator
writes the same files, and ``run_broadband`` follows JAX's on a 16 x 16 x
150, 4-bin cut of ``run/I3RC_bench_LW_325.nml`` photon for photon.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.core.accumulate import kahan_cumsum as jkahan
from mcbrat3d_tpu.domain import common as jcommon
from mcbrat3d_tpu.domain.domain import build_domain as jbuild_domain
from mcbrat3d_tpu.domain import sep_plan as jplan
from mcbrat3d_tpu.domain import ssp as jssp
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes import collection as jcollection
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.spectral import broadband as jbb
from mcbrat3d_tpu.spectral import weights as jweights
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu.transport import pallas_tile as jpt
from mcbrat3d_tpu_torch.core import accumulate
from mcbrat3d_tpu_torch.domain import common, sep_plan, ssp
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.driver.config import load_config
from mcbrat3d_tpu_torch.scenes import collection
from mcbrat3d_tpu_torch.spectral import broadband, weights
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport import sep_kernel as sk

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SMALL = dict(nx=16, ny=16, nz=150, n_lambda=4)
PLAN_FIELDS = ("amp", "amp_sum", "amp_max", "amp_blockmax", "macro_factor",
               "mprof", "zb", "zt", "il0", "f0", "entry", "cloud_offset",
               "comp_kinds", "num_prof", "tz", "dz_km")
SEP_FIELDS = ("sep_amp", "sep_pz", "sep_qz", "sep_block", "sep_tz",
              "sep_scalars", "sep_em_zpa", "sep_em_pb")


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The 4-bin 16 x 16 x 150 flagship pair as written by each package's
    generator, and the cut deck that reads it."""
    d = tmp_path_factory.mktemp("lw")
    collection.write_lw_flagship_inputs(str(d / "port_common.nc"),
                                        str(d / "port_ssp.nc"), **SMALL)
    jcollection.write_lw_flagship_inputs(str(d / "common.nc"),
                                         str(d / "ssp.nc"), **SMALL)
    with open(os.path.join(ROOT, "run", "I3RC_bench_LW_325.nml")) as f:
        deck = f.read()
    for a, b in (("numLambda = 64", "numLambda = 4"),
                 ("numPhotonsPerBatch = 4194304", "numPhotonsPerBatch = 1024"),
                 ("numBatches = 16", "numBatches = 2"),
                 ("nPhaseIntervals = 9001", "nPhaseIntervals = 201"),
                 ("common325.nc", "common.nc"),
                 ("ssp_thermal.nc", "ssp.nc")):
        assert a in deck, a
        deck = deck.replace(a, b)
    (d / "deck.nml").write_text(deck)
    return d


def test_flagship_inputs_and_cross_reading(inputs):
    """Each generator's files, read by either package, give the same
    arrays: the port writes what the JAX readers read, and the reverse."""
    d = inputs
    commons = [rd(str(d / f)) for rd in (
        lambda path: common.read_common(path, device="cpu"),
        jcommon.read_common) for f in ("port_common.nc", "common.nc")]
    tables = [rd(str(d / f)) for rd in (ssp.read_ssp_table,
                                        jssp.read_ssp_table)
              for f in ("port_ssp.nc", "ssp.nc")]
    for c in commons[1:]:
        for f in ("temps", "num_conc", "rho", "mass_conc", "reff"):
            np.testing.assert_array_equal(getattr(c, f),
                                          getattr(commons[0], f), err_msg=f)
        for a, b in zip(c.grid.edges_np(), commons[0].grid.edges_np()):
            np.testing.assert_array_equal(a, b)
    for t in tables[1:]:
        np.testing.assert_array_equal(t.freq_hz, tables[0].freq_hz)
        np.testing.assert_array_equal(t.surface_albedo,
                                      tables[0].surface_albedo)
        for a, b in zip(t.components, tables[0].components):
            assert (a.name, a.ext_type, a.z_level_base) == (
                b.name, b.ext_type, b.z_level_base)
            for f in ("key", "extinction", "ssa", "legendre_start",
                      "legendre_length", "legendre_coeffs", "xsec"):
                if getattr(b, f) is not None:
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f), err_msg=f)
    # and the port's writers, read back by the JAX readers
    c0, t0 = commons[0], tables[0]
    pressure = c0.num_conc[0, 0, :] * common.R_STAR * c0.temps[0, 0, :] / (
        common.N_AVOGADRO * 100.0)
    common.write_common(str(d / "rw_common.nc"), c0, pressure_hpa=pressure)
    ssp.write_ssp_table(str(d / "rw_ssp.nc"), t0)
    back = jcommon.read_common(str(d / "rw_common.nc"))
    np.testing.assert_allclose(back.num_conc, c0.num_conc, rtol=1e-12)
    np.testing.assert_array_equal(back.mass_conc, c0.mass_conc)
    np.testing.assert_array_equal(
        jssp.read_ssp_table(str(d / "rw_ssp.nc")).components[0].extinction,
        t0.components[0].extinction)


def test_plan_and_bin_domains_match_jax(inputs):
    """make_separable_bin_plan and build_domain_from_plan equal the JAX
    package's, and each plan-built bin equals the port's own generic
    compact build of the same bin."""
    d = inputs
    tc = common.read_common(str(d / "common.nc"), device="cpu")
    jc = jcommon.read_common(str(d / "common.nc"))
    ts, js = [ssp.read_ssp_table(str(d / "ssp.nc"))], [jssp.read_ssp_table(
        str(d / "ssp.nc"))]
    tp = sep_plan.make_separable_bin_plan(tc, ts, False, 8)
    jp = jplan.make_separable_bin_plan(jc, js, False, 8)
    for f in PLAN_FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert sep_plan.make_separable_bin_plan(tc, ts, True, 8) is None
    for li in range(SMALL["n_lambda"]):
        lam = float(js[0].lambdas_um[li])
        td = sep_plan.build_domain_from_plan(tc.grid, tp, li, lam,
                                             n_cdf_steps=201)
        jd = jplan.build_domain_from_plan(jc.grid, jp, li, lam,
                                          n_cdf_steps=201)
        comps, _, _ = ssp.components_from_ssp(tc, ts, li,
                                              calc_rayleigh=False)
        gd = build_domain(tc.grid, comps, temps=tc.temps, macro_factor=8,
                          n_cdf_steps=201, lambda_um=lam,
                          device_fields="compact")
        for f in SEP_FIELDS:
            np.testing.assert_array_equal(_np(getattr(td, f)),
                                          np.asarray(getattr(jd, f)),
                                          err_msg=f)
            # the generic build's emission tables see float32 temperatures,
            # the plan's float64 ones (in the JAX package too)
            np.testing.assert_allclose(
                _np(getattr(gd, f)), _np(getattr(td, f)),
                rtol=1e-3 if f.startswith("sep_em") else 1e-6, err_msg=f)
        assert td.sep_em_atm == pytest.approx(jd.sep_em_atm, rel=1e-12)
        np.testing.assert_array_equal(td.tables.inverse.numpy(),
                                      np.asarray(jd.tables.inverse))
        assert (td.sep_inv_row, td.sep_analytic_hg, td.n_components) == (
            jd.sep_inv_row, jd.sep_analytic_hg, jd.n_components)


def test_setup_fluxes_and_schedule_match_jax(inputs):
    """lw_setup_fluxes (through the plan and by the full sweep) to 1e-12
    relative, kahan_cumsum and the seeded multinomial schedule exactly."""
    d = inputs
    tc = common.read_common(str(d / "common.nc"), device="cpu")
    jc = jcommon.read_common(str(d / "common.nc"))
    ts, js = [ssp.read_ssp_table(str(d / "ssp.nc"))], [jssp.read_ssp_table(
        str(d / "ssp.nc"))]
    dl = weights.lambda_widths(ts[0].lambdas_um)
    np.testing.assert_array_equal(dl, jweights.lambda_widths(
        js[0].lambdas_um))
    tp = sep_plan.make_separable_bin_plan(tc, ts, False, 8)
    jp = jplan.make_separable_bin_plan(jc, js, False, 8)
    for plan, jplan_ in ((tp, jp), (None, None)):
        f_t = weights.lw_setup_fluxes(tc, ts, dl, 288.0, plan=plan)
        f_j = jweights.lw_setup_fluxes(jc, js, dl, 288.0, plan=jplan_)
        np.testing.assert_allclose(f_t, f_j, rtol=1e-12)
    cdf = accumulate.kahan_cumsum(f_t)
    np.testing.assert_array_equal(cdf, jkahan(f_j))
    cdf = cdf / cdf[-1]
    np.testing.assert_array_equal(
        weights.frequency_distribution(cdf, 67_108_864, seed=31),
        jweights.frequency_distribution(cdf, 67_108_864, seed=31))
    for a, b in zip(weights.solar_weighting(ts[0].lambdas_um, np.ones(4), 0.5),
                    jweights.solar_weighting(js[0].lambdas_um, np.ones(4),
                                             0.5)):
        np.testing.assert_array_equal(a, b)


def test_device_moments_match_host_moments():
    """The device accumulator's mean and standard error equal the host
    MomentAccumulator's on the same tallies (float64 sums both)."""
    r = np.random.RandomState(0)
    host, dev = accumulate.MomentAccumulator(), \
        accumulate.DeviceMomentAccumulator()
    for b in range(7):
        w = float(r.randint(500, 1500))
        arrays = {"flux_up": r.rand(4, 3) + b, "mean": np.float64(r.rand()),
                  "profile": r.rand(5) * 1e-3}
        host.add(w, arrays)
        dev.add(w, {k: torch.as_tensor(v, dtype=torch.float32)
                    for k, v in arrays.items()})
    out = dev.finalize()
    assert out.n_batches == host.n_batches == 7
    assert out.total_weight == host.total_weight
    for k in ("flux_up", "mean", "profile"):
        # the device sums take the float32 values of the tallies
        np.testing.assert_allclose(out.mean(k), host.mean(k), rtol=1e-6)
        np.testing.assert_allclose(out.stderr(k), host.stderr(k), rtol=1e-4)


def _folded_seed(iseed, batch) -> int:
    """The uint32 seed run_batch_pallas_sep folds from rng.batch_key."""
    kd = np.asarray(jax.random.key_data(jrng.batch_key(iseed, batch)))
    kd = kd.astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def test_run_broadband_matches_jax(inputs, monkeypatch):
    """The port's run_broadband against the JAX package's on the cut deck,
    photon for photon: the port's batches take the seeds the JAX kernel
    folds from its batch keys, both launch 32 steps at a time, and the JAX
    bins go straight to its separable kernel (its jitted run_batch drops
    the domain's host amplitude copy and so falls back to the per-column
    alias sampler: the same distribution by other draws). Bounds: the
    total flux and the schedule exactly; the domain means of flux up and
    down within 2^-9 relative (the JAX kernel tallies exits in bfloat16),
    net absorption and its profile within 1e-4 relative of the largest
    magnitude (bf16 hi/lo tallies)."""
    def steps32(config_for):
        def cut(*args, **kwargs):
            cfg, ppl = config_for(*args, **kwargs)
            return dataclasses.replace(cfg, steps_per_call=32), ppl
        return cut

    monkeypatch.setattr(jpk, "config_for", steps32(jpk.config_for))
    monkeypatch.setattr(rk, "config_for", steps32(rk.config_for))
    monkeypatch.setattr(broadband.rng, "batch_seed", _folded_seed)
    monkeypatch.setattr(
        jbb, "run_batch",
        lambda dom, sfc, src, key, cfg, icfg, idirs, n_photons:
        jsep.run_batch_pallas_sep_tallies(dom, sfc, src, key, cfg, n_photons,
                                          interpret=True))
    monkeypatch.chdir(inputs)
    launches = sk.SEP_LAUNCHES
    plain, run_plain = [], sk.sep_launch_plain
    monkeypatch.setattr(sk, "sep_launch_plain",
                        lambda *a, **k: plain.append(1) or run_plain(*a, **k))
    jr = jbb.run_broadband(jload("deck.nml"), mesh=None)
    tr = broadband.run_broadband(load_config("deck.nml"), "cpu")
    assert plain and sk.SEP_LAUNCHES == launches  # plain steps on the CPU
    assert tr.total_photons == jr.total_photons == 2 * 1024
    assert tr.n_batches == jr.n_batches and tr.n_bad == 0
    assert tr.solar_flux == jr.solar_flux
    for k, rtol in (("mean_flux_up", 2.0 ** -9),
                    ("mean_flux_down", 2.0 ** -9)):
        assert float(tr.mean[k]) == pytest.approx(float(jr.mean[k]),
                                                  rel=rtol), k
    scale = np.abs(jr.mean["flux_absorbed"]).max()
    np.testing.assert_allclose(tr.mean["flux_absorbed"],
                               jr.mean["flux_absorbed"], atol=1e-4 * scale)
    scale = np.abs(jr.mean["absorption_profile"]).max()
    np.testing.assert_allclose(tr.mean["absorption_profile"],
                               jr.mean["absorption_profile"],
                               atol=1e-4 * scale)


def test_lw_deck_through_the_cli(inputs, capsys, monkeypatch):
    """The cut deck through the port's command line on the CPU: the plain
    separable step runs every bin, the JSON line carries n_bad and the
    launch counts (no batch on the wave kernel), and the flux and netCDF
    files are written."""
    from mcbrat3d_tpu_torch.transport import integrator

    monkeypatch.chdir(inputs)
    monkeypatch.setattr(integrator, "WAVE_BATCHES", 0)
    capsys.readouterr()
    assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["total_photons"] == 2048 and out["n_bad"] == 0
    assert out["launches"] == {"record_kernel": 0,
                               "record_kernel_radiance": 0,
                               "record_kernel_lw": 0,
                               "col_kernel": 0,
                               "col_kernel_radiance": 0, "sep_kernel": 0,
                               "tile_kernel": 0, "wave_kernel_batches": 0}
    assert sorted(out["outputs"]) == ["LW325_flux.out", "LW325_results.nc"]
    with netcdf_file(str(inputs / "LW325_results.nc"), "r",
                     mmap=False) as nc:
        prof = np.array(nc.variables["absorptionProfile"][:])
        assert prof.shape == (150,) and np.isfinite(prof).all()
        total = float(nc.solarFlux)
    assert total == pytest.approx(2381.0126640214826, rel=1e-12)
    # the net profile integrates to the domain-mean net absorption
    assert float(prof.sum()) * 0.04 * 1000.0 == pytest.approx(
        out["mean_flux_absorbed"], rel=1e-5)


def test_unported_broadband_paths_raise(inputs, monkeypatch):
    """With Rayleigh the deck has no separable plan, so its bins take the
    generic build: 38,400 cells of three components, which no
    hand-written kernel takes (K1 past MAX_CELLS, K4 not separable, K5 not
    emission) and which the JAX package's megakernels refuse too (its XLA
    wave kernel runs them, as the port's does under usePallas = 'auto'):
    with usePallas = 'on' run_batch raises, naming each kernel's failing
    predicates."""
    monkeypatch.chdir(inputs)
    cfg = load_config("deck.nml")
    with pytest.raises(ValueError, match="n_cells=38400 > 36864") as err:
        broadband.run_broadband(dataclasses.replace(
            cfg, calc_rayleigh=True, use_pallas="on"), "cpu")
    assert "domain is not separable" in str(err.value)
    assert "emission source" in str(err.value)
    # the JAX package's dispatch of the same first bin
    common = jcommon.read_common("common.nc")
    tables = [jssp.read_ssp_table("ssp.nc")]
    comps, albedo, lam = jssp.components_from_ssp(common, tables, 0,
                                                  calc_rayleigh=True)
    dom = jbuild_domain(common.grid, comps, temps=common.temps,
                        lambda_um=lam, n_cdf_steps=201, macro_factor=8)
    w = jweights.emission_weighting(
        common.grid, common.temps,
        jweights.absorption_coefficient(comps, common.grid), 288.0,
        1.0 - albedo, lam)
    src = jill.emission(w.voxel_cdf, w.frac_atms_power, common.grid.shape)
    sfc = JSurface.lambertian(albedo, temperature=288.0,
                              emissivity=1.0 - albedo)
    args = dict(lw_mode=True, compute_intensity=False,
                record_scattering_orders=0, use_ray_tracing=False)
    assert jpk.ineligibility_reasons(dom, sfc, src, **args)
    assert jsep.sep_ineligibility_reasons(
        dom, sfc, src, need_volume_absorption=False, **args)
    assert "emission source" in jpt.tile_ineligibility_reasons(
        dom, sfc, src, need_volume_absorption=False, **args)


def test_rayleigh_deck_within_k1_runs_as_jax_dispatches(tmp_path,
                                                        monkeypatch):
    """The positive case: with Rayleigh and 8 x 8 x 150 cells (within the
    record kernel's envelope) every bin takes the generic build and the
    per-voxel source and runs on the record kernel (its plain step here),
    as the JAX package's dispatch takes its record kernel for the same
    bin."""
    kw = dict(nx=8, ny=8, nz=150, n_lambda=2)
    collection.write_lw_flagship_inputs(str(tmp_path / "common.nc"),
                                        str(tmp_path / "ssp.nc"), **kw)
    with open(os.path.join(ROOT, "run", "I3RC_bench_LW_325.nml")) as f:
        deck = f.read()
    for a, b in (("numLambda = 64", "numLambda = 2"),
                 ("numPhotonsPerBatch = 4194304", "numPhotonsPerBatch = 512"),
                 ("numBatches = 16", "numBatches = 2"),
                 ("nPhaseIntervals = 9001", "nPhaseIntervals = 201"),
                 ("common325.nc", "common.nc"),
                 ("ssp_thermal.nc", "ssp.nc")):
        deck = deck.replace(a, b)
    (tmp_path / "deck.nml").write_text(deck)
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(load_config("deck.nml"), calc_rayleigh=True)
    plain, run_plain = [], rk.record_launch_plain
    monkeypatch.setattr(rk, "record_launch_plain",
                        lambda *a, **k: plain.append(1) or run_plain(*a, **k))
    sep_plain = []
    monkeypatch.setattr(sk, "sep_launch_plain",
                        lambda *a, **k: sep_plain.append(1))
    res = broadband.run_broadband(cfg, "cpu")
    assert plain and not sep_plain
    assert res.total_photons == 1024 and res.n_bad == 0
    assert np.isfinite(float(res.mean["mean_flux_up"]))
    common = jcommon.read_common("common.nc")
    tables = [jssp.read_ssp_table("ssp.nc")]
    comps, albedo, lam = jssp.components_from_ssp(common, tables, 0,
                                                  calc_rayleigh=True)
    assert len(comps) == 3
    dom = jbuild_domain(common.grid, comps, temps=common.temps,
                        lambda_um=lam, n_cdf_steps=201, macro_factor=8)
    w = jweights.emission_weighting(
        common.grid, common.temps,
        jweights.absorption_coefficient(comps, common.grid), 288.0,
        1.0 - albedo, lam)
    src = jill.emission(w.voxel_cdf, w.frac_atms_power, common.grid.shape)
    assert jpk.ineligibility_reasons(
        dom, JSurface.lambertian(albedo, temperature=288.0,
                                 emissivity=1.0 - albedo), src,
        lw_mode=True, compute_intensity=False, record_scattering_orders=0,
        use_ray_tracing=False) == []
