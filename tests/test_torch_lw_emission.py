"""PyTorch port: the record kernel's thermal-emission envelope (K1-c)
against the JAX package.

The per-voxel emission source (``illumination.emission``: its Walker alias
pair in the kernel's cell order), the BBEmission refill of the plain record
step with the lw_mode pre-credits and the LW radiance "fresh hold", which
``record_launch`` runs on the CPU, against the JAX record kernel in Pallas
interpret mode; the port's analogues of the JAX package's physical checks
of emission; ``run_broadband``'s generic per-bin path against the JAX
package's on a cut of the inputs of ``run/broadband_lw.nml``; and the
dispatch of emission sources. The CUDA kernel is held against the plain
step on the card by chip_smoke.py (phases 2g, 2b, 2c and 3g).

Both packages draw the same counter uniforms from the same folded seed
(the emission refill at sites 10-13, its voxel offsets at 0, 1 and 2 and
its azimuth at 9), so photon paths coincide up to float rounding.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.core.grid import Grid as JGrid
from mcbrat3d_tpu.domain import ssp as jssp
from mcbrat3d_tpu.domain.common import read_common as jread_common
from mcbrat3d_tpu.domain.domain import OpticalComponent as JComponent
from mcbrat3d_tpu.domain.domain import build_domain as jbuild_domain
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.physics.phase_function import PhaseFunction as JPhase
from mcbrat3d_tpu.physics.phase_function import \
    PhaseFunctionTable as JPhaseTable
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes import collection as jcollection
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.spectral import broadband as jbb
from mcbrat3d_tpu.spectral import weights as jweights
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_tile as jpt
from mcbrat3d_tpu.transport.integrator import KernelConfig as JKernelConfig
from mcbrat3d_tpu.transport.integrator import run_batch as jrun_batch
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core import planck
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain import ssp
from mcbrat3d_tpu_torch.domain.common import read_common
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.driver.config import load_config
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import lw_flagship_physical
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import broadband, weights
from mcbrat3d_tpu_torch.tools.lw_inputs import write_lw_broadband_inputs
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport import sep_kernel as sk
from mcbrat3d_tpu_torch.transport import tile_kernel as tk
from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig, run_batch,
                                                      select_kernel)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SMALL = jpk.PallasConfig(rows=16, block_rows=8, steps_per_call=32,
                             max_steps=6000, interpret=True)
SMALL = rk.RecordConfig(rows=16, steps_per_call=32, max_steps=6000)
# Flux up and down, per domain total and per column (of the largest
# column), between the plain step and the JAX kernel: the JAX kernel
# tallies exits in bfloat16 hi/lo pairs (tests/test_torch_broadband.py's
# bound); on shared paths the gap is ~1e-6.
FLUX_REL = 2.0 ** -9
# Net volume absorption, pre-credits included, per cell, of its largest
# magnitude (bf16 hi/lo absorption tallies; ~7e-6 on shared paths).
VOL_REL = 1e-4
# Per-direction radiance gap and per-pixel gap (of the image maximum) of the
# fresh-hold radiance run: tests/test_torch_radiance.py's limits.
RAD_GAP = 1e-3
RAD_PIXEL_GAP = 1e-3
KERNEL_ARGS = dict(compute_intensity=False, record_scattering_orders=0,
                   use_ray_tracing=False)


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def lw_setup(macro_factor=0, analytic=True, intensity=False):
    """tests/test_pallas.py's lw_setup scene (8 x 4 x 8 cells, a
    half-filled HG or tabulated cloud over a uniform gas, 3D temperatures
    of 250-290 K) with its per-voxel emission source, in each package:
    ((jax domain, jax source), (port domain, port source))."""
    nx, ny, nz = 8, 4, 8
    rs = np.random.RandomState(0)
    cld = rs.rand(nx, ny, nz) * 6.0
    temps = 250.0 + 40.0 * rs.rand(nx, ny, nz)
    gas = np.full((1, 1, nz), 0.5)

    def build(G, C, PF, PFT, bd, W, ill, gkw):
        grid = G.regular(nx, ny, nz, 0.5, 0.5, 0.25, **gkw)
        if analytic:
            pf = PF.henyey_greenstein(0.85, 64)
        else:
            l = np.arange(1, 65, dtype=np.float64)
            pf = PF(coefficients=0.7 * 0.85 ** l + 0.3 * 0.3 ** l)
        comps = [C("cloud", cld, np.full_like(cld, 0.6),
                   np.zeros(cld.shape, np.int32), PFT([pf], key=[1.0])),
                 C("gas", gas, np.zeros_like(gas),
                   np.zeros(gas.shape, np.int32),
                   PFT([PF.isotropic()], key=[1.0]))]
        dom = bd(grid, comps, temps=temps, n_cdf_steps=201,
                 macro_factor=macro_factor,
                 compute_intensity_tables=intensity)
        w = W.emission_weighting(grid, temps,
                                 W.absorption_coefficient(comps, grid),
                                 290.0, 0.95, 10.0)
        return dom, ill.emission(w.voxel_cdf, w.frac_atms_power,
                                 grid.shape, **gkw)

    return (build(JGrid, JComponent, JPhase, JPhaseTable, jbuild_domain,
                  jweights, jill, {}),
            build(Grid, OpticalComponent, PhaseFunction, PhaseFunctionTable,
                  build_domain, weights, illumination, {"device": "cpu"}))


# ---------------------------------------------------------------------------
# The source: Walker alias tables and the cell of a bin
# ---------------------------------------------------------------------------

def _random_cdf(zero_share, seed):
    rs = np.random.RandomState(seed)
    p = rs.rand(6 * 5 * 4) ** 3 * (rs.rand(6 * 5 * 4) >= zero_share)
    p[:3] = 0.0  # leading zero-power voxels
    cdf = np.cumsum(p)
    return cdf / cdf[-1] if cdf[-1] > 0 else np.ones_like(cdf)


@pytest.mark.parametrize("case", ["zero_power_voxels", "mostly_zero",
                                  "no_power", "lw_setup"])
def test_alias_tables_match_jax(case):
    """``illumination.emission`` builds JAX's alias pair bit for bit, in
    the kernel's cell order, with zero-power voxels (acceptance 0) and a
    CDF with no power at all (uniform)."""
    if case == "lw_setup":
        (_, jsrc), (_, tsrc) = lw_setup()
    else:
        shape = (6, 5, 4)
        cdf = {"zero_power_voxels": lambda: _random_cdf(0.3, 1),
               "mostly_zero": lambda: _random_cdf(0.95, 2),
               "no_power": lambda: np.zeros(120)}[case]()
        jsrc = jill.emission(cdf, 0.7, shape)
        tsrc = illumination.emission(cdf, 0.7, shape, device="cpu")
    assert tsrc.atms_fraction == float(jsrc.atms_fraction)
    for a, b in ((tsrc.em_prob, jsrc.em_prob), (tsrc.em_alias, jsrc.em_alias)):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "mostly_zero":
        assert (tsrc.em_prob == 0).any()


@pytest.mark.parametrize("shape", [(32, 32, 24), (8, 4, 8), (48, 32, 24),
                                   (288, 128, 1)])
def test_cell_decomposition_matches_jax_float_divides(shape):
    """The port's integer decomposition of a bin v = (ix*ny + iy)*nz + iz
    (the plain step's and the kernel's) gives the cell that the JAX
    kernel's floored float32 divides give (pallas_kernel.py:951-956), on
    every bin of the deck's grid and of other grids up to the 36,864-cell
    envelope."""
    nx, ny, nz = shape
    v = np.arange(nx * ny * nz, dtype=np.int32)
    vf = jnp.asarray(v).astype(jnp.float32)
    colf = jnp.floor((vf + 0.5) * np.float32(1.0 / nz))
    izf = vf - colf * nz
    ixf = jnp.floor((colf + 0.5) * np.float32(1.0 / ny))
    iyf = colf - ixf * ny
    ix, iy, iz = rk.cell_indices(torch.from_numpy(v), ny, nz)
    for port, ref in ((ix, ixf), (iy, iyf), (iz, izf)):
        np.testing.assert_array_equal(port.numpy(),
                                      np.asarray(ref).astype(np.int32))
    assert int(ix.max()) == nx - 1


# ---------------------------------------------------------------------------
# The plain step against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

PARITY_CASES = {
    # (macro factor, analytic HG, surface albedo, roulette)
    "macro0_hg_albedo005": (0, True, 0.05, True),
    "macro2_table_black": (2, False, 0.0, True),
    "macro8_hg_no_roulette": (8, True, 0.05, False),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_plain_step_matches_jax_interpret_kernel(case):
    """LW transport from the per-voxel source with the pre-credits, run
    for run: equal photons, n_bad and launches; flux up and down within
    2^-9 (domain total and per column); net volume absorption, pre-credits
    included, within 1e-4 of its largest magnitude per cell. The JAX
    kernel does not count real collisions; the CUDA kernel's are held
    against the plain step's on the card. No photon was seen to part on
    these cases (no multiply-add is contracted on the refill's paths)."""
    mf, analytic, albedo, rr = PARITY_CASES[case]
    (jd, jsrc), (td, tsrc) = lw_setup(mf, analytic)
    key = jrng.batch_key(3, 1)
    fu, fd, vol, n, n_bad, n_calls = jpk.run_batch_pallas(
        jd, JSurface.lambertian(albedo), jsrc, key, JAX_SMALL,
        photons_per_lane=2, use_russian_roulette=rr, lw_mode=True)
    tu, tdn, tv, tn, t_bad, t_calls = rk.run_batch_record(
        td, Surface.lambertian(albedo), tsrc, folded_seed(key), SMALL, 2,
        use_russian_roulette=rr, lw_mode=True)
    assert tn == int(n) == 16 * 128 * 2
    assert t_bad == int(n_bad) == 0 and t_calls == int(n_calls)
    for a, b in ((tu, fu), (tdn, fd)):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert a.sum() == pytest.approx(b.sum(), rel=FLUX_REL)
        assert np.abs(a - b).max() <= FLUX_REL * np.abs(b).max()
    tv, vol = tv.numpy().astype(np.float64), np.asarray(vol, np.float64)
    assert tv.shape == vol.shape == (8, 4, 8)
    # pre-credits make the net absorption negative where emission wins
    assert (vol < 0).any()
    np.testing.assert_allclose(tv, vol, rtol=0,
                               atol=VOL_REL * np.abs(vol).max())


def test_fresh_hold_radiance_matches_jax_interpret_kernel():
    """LW radiance: a newly emitted photon contributes its emission local
    estimate (isotropic 1/(4 pi mu_d) from the atmosphere, Lambertian 1/pi
    from the surface, weight 1) in its birth step and moves from the next.
    The plain step against the JAX kernel's in-kernel estimator, same
    folded seed: per-direction means within 1e-3, pixels within 1e-3 of
    the image maximum, fluxes within 2^-9."""
    (jd, jsrc), (td, tsrc) = lw_setup(2, True, intensity=True)
    mus, phis = [1.0, 0.6], [0.0, 90.0]
    key = jrng.batch_key(5, 0)
    jt = jrun_batch(
        jd, JSurface.lambertian(0.05), jsrc, key,
        JKernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                      use_pallas="on", lw_mode=True),
        JIcfg(n_dirs=2, use_russian_roulette=False, use_hybrid_phase=False,
              pallas_march="cell"),
        jdirections(mus, phis))
    tt = run_batch(
        td, Surface.lambertian(0.05), tsrc, folded_seed(key),
        KernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                     lw_mode=True),
        intensity_config=le.IntensityConfig(n_dirs=2,
                                            use_russian_roulette=False,
                                            use_hybrid_phase=False),
        intensity_dirs=le.make_intensity_directions(mus, phis, device="cpu"))
    assert tt.n_photons == int(jt.n_photons) == 1024
    assert tt.n_bad == int(jt.n_bad) == 0
    ji = np.asarray(jt.intensity, np.float64)
    ti = tt.intensity.double().numpy()
    jm, tm = ji.mean(axis=(0, 1)), ti.mean(axis=(0, 1))
    assert np.all(jm > 0)
    assert (np.abs(tm - jm) / jm).max() < RAD_GAP
    assert np.abs(ti - ji).max() < RAD_PIXEL_GAP * np.abs(ji).max()
    for a, b in ((tt.flux_up, jt.flux_up), (tt.flux_down, jt.flux_down)):
        assert float(a.sum()) == pytest.approx(float(np.sum(b)),
                                               rel=FLUX_REL)


# ---------------------------------------------------------------------------
# Physical checks on the plain step (the JAX package's, ported)
# ---------------------------------------------------------------------------

def _lw_cfg(n_lanes, ppl, max_steps):
    return KernelConfig(n_lanes=n_lanes, photons_per_lane=ppl,
                        max_steps=max_steps, lw_mode=True)


def test_emission_histogram_matches_target():
    """tests/test_pallas.py:678-709: on a near-transparent domain every
    photon leaves, so the volume tally is minus the emission histogram,
    which matches the target voxel distribution within 5 sigma per voxel
    (and in total within 1e-3)."""
    nx, ny, nz = 8, 4, 8
    rs = np.random.RandomState(0)
    grid = Grid.regular(nx, ny, nz, 0.5, 0.5, 0.25, device="cpu")
    ext = np.full((nx, ny, nz), 1e-6)
    comp = OpticalComponent("thin", ext, np.ones_like(ext),
                            np.zeros(ext.shape, np.int32),
                            PhaseFunctionTable([PhaseFunction.isotropic()],
                                               key=[1.0]))
    domain = build_domain(grid, [comp], n_cdf_steps=201)
    p = rs.rand(nz, ny, nx) ** 2
    p /= p.sum()
    cdf = np.cumsum(p.reshape(-1))
    cdf[-1] = 1.0
    source = illumination.emission(cdf, 1.0, grid.shape, device="cpu")
    t = run_batch(domain, Surface.lambertian(0.0), source, 0,
                  _lw_cfg(2048, 32, 8000))
    n = float(t.n_photons)
    assert n == 2048 * 32 and t.n_bad == 0
    est = -t.volume_absorption.double().numpy() / n
    pk_ = p.transpose(2, 1, 0)
    sig = np.sqrt(pk_ * (1 - pk_) / n) + 1e-9
    assert np.abs((est - pk_) / sig).max() < 5.0
    assert abs(est.sum() - 1.0) < 1e-3


def _isothermal(nx, ny, nz, dx, dz, ext, temp, lam):
    grid = Grid.regular(nx, ny, nz, dx, dx, dz, device="cpu")
    temps = np.full((nx, ny, nz), temp)
    e = np.full((nx, ny, nz), ext)
    comp = OpticalComponent("abs", e, np.zeros_like(e),
                            np.zeros(e.shape, np.int32),
                            PhaseFunctionTable([PhaseFunction.isotropic()],
                                               key=[1.0]))
    domain = build_domain(grid, [comp], temps=temps, n_cdf_steps=101,
                          compute_intensity_tables=True)
    w = weights.emission_weighting(
        grid, temps, weights.absorption_coefficient([comp], grid), temp, 1.0,
        lam)
    return domain, w, illumination.emission(w.voxel_cdf, w.frac_atms_power,
                                            grid.shape, device="cpu")


def test_lw_precredit_balances_isothermal():
    """tests/test_spectral.py:126-148: in an isothermal absorbing
    atmosphere over a black surface at the same temperature the net
    heating (absorbed minus emitted, which the pre-credits encode) is
    small and negative: the atmosphere loses what escapes the top."""
    domain, _, source = _isothermal(2, 2, 4, 1.0, 0.5, 3.0, 288.0, 10.0)
    t = run_batch(domain, Surface.lambertian(0.0), source, 1,
                  _lw_cfg(1 << 14, 16, 4000))
    n = t.n_photons
    assert n == 1 << 18 and t.n_bad == 0
    net = float(t.volume_absorption.double().sum()) / n
    assert -0.2 < net < 0.005
    # with ssa 0 every photon's whole weight leaves up, down or is
    # absorbed, so the net tally is n - up - down minus one pre-credit per
    # atmospheric birth: the births follow fracAtmsPower
    births = n - float(t.flux_up.double().sum() + t.flux_down.double().sum()
                       ) - net * n
    sigma = (n * source.atms_fraction * (1.0 - source.atms_fraction)) ** 0.5
    assert abs(births - n * source.atms_fraction) < 5.0 * sigma + 1.0


def test_isothermal_blackbody_radiance_is_planck():
    """tests/test_pallas.py:1460-1500, the fresh hold: an optically thick
    isothermal atmosphere over a black surface at its temperature radiates
    B_lambda(T) into every upward direction, within 5%."""
    temp, lam = 288.0, 10.0
    domain, w, source = _isothermal(4, 4, 8, 0.25, 0.25, 6.0, temp, lam)
    dirs = le.make_intensity_directions([1.0, 0.6], [0.0, 90.0],
                                        device="cpu")
    t = run_batch(domain, Surface.lambertian(0.0), source, 0,
                  _lw_cfg(1 << 13, 8, 4000),
                  intensity_config=le.IntensityConfig(
                      n_dirs=2, use_russian_roulette=False,
                      use_hybrid_phase=False),
                  intensity_dirs=dirs)
    assert t.n_bad == 0 and t.n_photons == 1 << 16
    rad = t.normalized(domain.grid).intensity.double().mean(dim=(0, 1))
    b = planck.planck_radiance(lam, temp)
    for d in range(2):
        assert float(rad[d]) * w.flux == pytest.approx(b, rel=0.05), d


# ---------------------------------------------------------------------------
# run_broadband's generic per-bin path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deck_cut(tmp_path_factory):
    """write_lw_broadband_inputs' files cut to 8 x 8 x 24 cells and 2 bins
    (3D temperatures: no bin is separable), and the deck cut to 2 x 1,024
    photons and 201 phase steps."""
    d = tmp_path_factory.mktemp("lw_generic")
    write_lw_broadband_inputs(str(d), nx=8, ny=8, n_lambda=2)
    with open(os.path.join(ROOT, "run", "broadband_lw.nml")) as f:
        deck = f.read()
    for a, b in (("numLambda = 64", "numLambda = 2"),
                 ("numPhotonsPerBatch = 1048576",
                  "numPhotonsPerBatch = 1024"),
                 ("numBatches = 8", "numBatches = 2"),
                 ("nPhaseIntervals = 10001", "nPhaseIntervals = 201")):
        assert a in deck, a
        deck = deck.replace(a, b)
    (d / "deck.nml").write_text(deck)
    return d


def test_lw_inputs_are_not_separable(deck_cut):
    """The writer's files: the pair both packages read alike, 3D
    temperatures (the jitter) and so a 3D gas, a plan without separable
    emission, and per-bin domains with no separable template."""
    common = read_common(str(deck_cut / "common.nc"), device="cpu")
    jcommon = jread_common(str(deck_cut / "common.nc"))
    np.testing.assert_array_equal(common.temps, np.asarray(jcommon.temps))
    np.testing.assert_array_equal(common.num_conc,
                                  np.asarray(jcommon.num_conc))
    spread = common.temps - common.temps[:1, :1, :]
    assert 0.5 < np.abs(spread).max() <= 4.0
    tables = [ssp.read_ssp_table(str(deck_cut / "ssp_thermal.nc"))]
    plan = broadband.make_separable_bin_plan(common, tables, False, 8)
    assert plan is None or plan.tz is None
    comps, _, lam = ssp.components_from_ssp(common, tables, 1)
    dom = build_domain(common.grid, comps, temps=common.temps,
                       lambda_um=lam, n_cdf_steps=201)
    assert not dom.sep_template and dom.sep_em_zpa is None


def _folded_batch_seed(iseed, batch) -> int:
    return folded_seed(jrng.batch_key(iseed, batch))


def test_run_broadband_generic_path_matches_jax(deck_cut, monkeypatch):
    """The port's run_broadband against the JAX package's on the cut deck
    with K1 in interpret mode, photon for photon: every bin takes the
    generic build and the per-voxel source (below MAX_CELLS neither
    package probes the plan), the port's batches take the seeds the JAX
    kernel folds from its batch keys, and both run the JAX package's
    launch geometry (the port's by rk.jax_geometry, not its refill
    schedule), 32 steps at a time. Bounds: the total flux and the schedule
    exactly; the domain means of flux up and down within 2^-9 relative,
    net absorption per column and its profile within 1e-4 of the largest
    magnitude (the bounds of tests/test_torch_broadband.py's
    test_run_broadband_matches_jax)."""
    def steps32(config_for):
        def cut(*args, **kwargs):
            cfg, ppl = config_for(*args, **kwargs)
            return dataclasses.replace(cfg, steps_per_call=32), ppl
        return cut

    def jax_geometry32(tallies):
        def run(*args, **kwargs):
            cfg = dataclasses.replace(rk.jax_geometry(args[4]),
                                      steps_per_call=32)
            return tallies(*args, rcfg=cfg, **kwargs)
        return run

    monkeypatch.setattr(jpk, "config_for", steps32(jpk.config_for))
    monkeypatch.setattr(rk, "run_batch_record_tallies",
                        jax_geometry32(rk.run_batch_record_tallies))
    monkeypatch.setattr(broadband.rng, "batch_seed", _folded_batch_seed)
    monkeypatch.setattr(
        jbb, "run_batch",
        lambda dom, sfc, src, key, cfg, icfg, idirs, n_photons:
        jpk.run_batch_pallas_tallies(dom, sfc, src, key, cfg, n_photons,
                                     interpret=True))
    schedules = {}
    for name, mod in (("jax", jweights), ("port", weights)):
        orig = mod.frequency_distribution
        monkeypatch.setattr(
            jbb if name == "jax" else broadband, "frequency_distribution",
            lambda *a, _o=orig, _n=name, **k:
            schedules.setdefault(_n, _o(*a, **k)))
    monkeypatch.chdir(deck_cut)
    plain, run_plain = [], rk.record_launch_plain
    monkeypatch.setattr(rk, "record_launch_plain",
                        lambda *a, **k: plain.append(1) or run_plain(*a, **k))
    sep_plain = []
    monkeypatch.setattr(sk, "sep_launch_plain",
                        lambda *a, **k: sep_plain.append(1))
    jr = jbb.run_broadband(jload("deck.nml"), mesh=None)
    tr = broadband.run_broadband(load_config("deck.nml"), "cpu")
    assert plain and not sep_plain  # every bin on the plain record step
    np.testing.assert_array_equal(schedules["port"], schedules["jax"])
    assert tr.solar_flux == jr.solar_flux
    assert tr.total_photons == jr.total_photons == 2 * 1024
    assert tr.n_batches == jr.n_batches and tr.n_bad == 0
    for k in ("mean_flux_up", "mean_flux_down"):
        assert float(tr.mean[k]) == pytest.approx(float(jr.mean[k]),
                                                  rel=FLUX_REL), k
    for k in ("flux_absorbed", "absorption_profile", "volume_absorption"):
        scale = np.abs(jr.mean[k]).max()
        np.testing.assert_allclose(tr.mean[k], jr.mean[k], rtol=0,
                                   atol=VOL_REL * scale, err_msg=k)


def test_lw_deck_cut_through_the_cli(deck_cut, capsys, monkeypatch):
    """The cut deck through the port's command line on the CPU: the plain
    record step runs every bin with the emission refill, the JSON line
    carries n_bad, the launch counts and the host build seconds, and the
    flux and netCDF files are written."""
    monkeypatch.chdir(deck_cut)
    capsys.readouterr()
    assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["total_photons"] == 2048 and out["n_bad"] == 0
    assert set(out["launches"].values()) == {0}
    assert "record_kernel_lw" in out["launches"]
    assert out["build_seconds"] >= 0.0
    assert sorted(out["outputs"]) == ["LW_flux.out", "LW_results.nc"]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _flagship_separable_bin():
    """A 16 x 16 x 150 bin of the LW flagship physics (38,400 cells, past
    MAX_CELLS) built generically with its z-uniform temperatures, so
    separable with emission tables, and its per-voxel source, in each
    package."""
    kw = dict(nx=16, ny=16, nz=150, n_lambda=2)
    out = []
    for (common, tbl, _), comps_of, bd, W, ill, dkw in (
            (jcollection.lw_flagship_physical(**kw),
             jssp.components_from_ssp, jbuild_domain, jweights, jill, {}),
            (lw_flagship_physical(**kw, device="cpu"),
             ssp.components_from_ssp, build_domain, weights, illumination,
             {"device": "cpu"})):
        comps, albedo, lam = comps_of(common, [tbl], 0, calc_rayleigh=False)
        dom = bd(common.grid, comps, temps=common.temps, lambda_um=lam,
                 n_cdf_steps=201, macro_factor=8)
        w = W.emission_weighting(common.grid, common.temps,
                                 W.absorption_coefficient(comps,
                                                          common.grid),
                                 288.0, 1.0 - albedo, lam)
        out.append((dom, ill.emission(w.voxel_cdf, w.frac_atms_power,
                                      common.grid.shape, **dkw), albedo))
    return out


DISPATCH_CASES = ("emission_on_k1", "lw_mode_without_emission",
                  "separable_emission_not_on_k1", "emission_with_rpv",
                  "per_voxel_source_past_max_cells_to_k4",
                  "k5_refuses_emission")


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_emission_dispatch_matches_jax(case):
    """The port's predicates name what JAX's name: an emission source with
    its alias tables is in-kernel for K1 (lw_mode or not); lw_mode without
    an emission source is refused; a separable-backed emission source is
    not K1's; a uniform RPV surface passes K1's predicate as in JAX, and
    its lw_mode batch runs on K1 with the RPV weight at each reflection,
    path for path with JAX's K1 (fluxes within 2^-9, net absorption within
    1e-4 of its largest magnitude per cell); a per-voxel source on a
    separable domain past MAX_CELLS goes to K4 in both packages; K5
    refuses emission."""
    if case in ("emission_on_k1", "emission_with_rpv", "k5_refuses_emission"):
        (jd, jsrc), (td, tsrc) = lw_setup(2)
        jsfc, tsfc = JSurface.lambertian(0.05), Surface.lambertian(0.05)
        if case == "emission_with_rpv":
            jsfc = JSurface.rpv(0.1, 0.8, -0.2)
            tsfc = Surface(params=np.asarray([0.1, 0.8, -0.2], np.float32)
                           .reshape(1, 1, 3), brdf_name="RPV")
        if case == "k5_refuses_emission":
            tr = tk.tile_ineligibility_reasons(
                td, tsfc, tsrc, lw_mode=True, need_volume_absorption=True,
                **KERNEL_ARGS)
            jr = jpt.tile_ineligibility_reasons(
                jd, jsfc, jsrc, True, False, 0, False, True)
            assert "emission source" in tr and tr == jr
            return
        for lw in (True, False):
            tr = rk.ineligibility_reasons(td, tsfc, tsrc, lw_mode=lw,
                                          **KERNEL_ARGS)
            jr = jpk.ineligibility_reasons(jd, jsfc, jsrc, lw_mode=lw,
                                           **KERNEL_ARGS)
            assert tr == jr == []
        if case == "emission_with_rpv":
            kw = dict(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                      lw_mode=True)
            assert select_kernel(td, tsfc, tsrc,
                                 KernelConfig(**kw))[0] == "record"
            key = jrng.batch_key(3, 2)
            jt = jrun_batch(jd, jsfc, jsrc, key,
                            JKernelConfig(use_pallas="on", **kw))
            tt = run_batch(td, tsfc, tsrc, folded_seed(key),
                           KernelConfig(**kw))
            assert tt.n_photons == int(jt.n_photons) == 1024
            assert tt.n_bad == int(jt.n_bad) == 0
            for a, b in ((tt.flux_up, jt.flux_up),
                         (tt.flux_down, jt.flux_down)):
                a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
                assert a.sum() == pytest.approx(b.sum(), rel=FLUX_REL)
                assert np.abs(a - b).max() <= FLUX_REL * np.abs(b).max()
            tv = tt.volume_absorption.numpy().astype(np.float64)
            jv = np.asarray(jt.volume_absorption, np.float64)
            np.testing.assert_allclose(tv, jv, rtol=0,
                                       atol=VOL_REL * np.abs(jv).max())
    elif case == "lw_mode_without_emission":
        jd, td = jmake(ssa=0.99), make_step_cloud(ssa=0.99, device="cpu")
        tr = rk.ineligibility_reasons(
            td, Surface.lambertian(0.0), illumination.directional(0.5, 0.0),
            lw_mode=True, **KERNEL_ARGS)
        jr = jpk.ineligibility_reasons(
            jd, JSurface.lambertian(0.0), jill.directional(0.5, 0.0),
            lw_mode=True, **KERNEL_ARGS)
        assert tr == jr == ["lw_mode without an emission source"]
    else:
        (jd, jsrc, alb), (td, tsrc, _) = _flagship_separable_bin()
        jsfc = JSurface.lambertian(alb, temperature=288.0,
                                   emissivity=1.0 - alb)
        tsfc = Surface.lambertian(alb, temperature=288.0,
                                  emissivity=1.0 - alb)
        assert td.sep_template and td.sep_em_zpa is not None
        if case == "separable_emission_not_on_k1":
            tsep = illumination.emission_separable(td, 288.0, 1.0 - alb)
            jsep = jill.emission_separable(jd, 288.0, 1.0 - alb)
            tr = rk.ineligibility_reasons(td, tsfc, tsep, lw_mode=True,
                                          **KERNEL_ARGS)
            jr = jpk.ineligibility_reasons(jd, jsfc, jsep, lw_mode=True,
                                           **KERNEL_ARGS)
            assert "source kind 'emission' not in-kernel" in tr and tr == jr
            return
        kcfg = KernelConfig(n_lanes=1024, photons_per_lane=1,
                            max_steps=6000, lw_mode=True,
                            need_volume_absorption=False)
        jcfg = JKernelConfig(n_lanes=1024, photons_per_lane=1,
                             max_steps=6000, lw_mode=True, use_pallas="on",
                             need_volume_absorption=False)
        assert select_kernel(td, tsfc, tsrc, kcfg)[0] == "sep"
        assert jbb._sep_path_confirmed(jd, jsfc, jsrc, jcfg, None)
        tr = rk.ineligibility_reasons(td, tsfc, tsrc, lw_mode=True,
                                      **KERNEL_ARGS)
        assert tr == jpk.ineligibility_reasons(jd, jsfc, jsrc, lw_mode=True,
                                               **KERNEL_ARGS)
        assert any("n_cells=38400" in r for r in tr)
        assert ck.col_ineligibility_reasons(
            td, tsfc, tsrc, lw_mode=True, need_volume_absorption=False,
            **KERNEL_ARGS)
        assert sk.sep_ineligibility_reasons(
            td, tsfc, tsrc, lw_mode=True, need_volume_absorption=False,
            **KERNEL_ARGS) == []
