"""PyTorch port: the record kernel's source and component envelope (K1-a,
K1-b) against the JAX record kernel in Pallas interpret mode.

The random-azimuth, flux and spotlight refills and the 2-3 component
records (the scattering-coefficient formulation: one uniform picks the
scattering component against the cell's cumulative scattering fractions)
of the plain PyTorch step, which ``record_launch`` runs on the CPU; the
8-column multi-component record against the JAX package's packed table;
in-kernel radiance on 3 components with capped contributions; the
two-level majorant across the periodic seam on 3 components; and the
uniform RPV and per-pixel surfaces on 3 components (the three-component
deck through the command line and the builders' default device are in
``test_torch_record_deck.py``).
The CUDA kernel is held against the plain step on the card by
chip_smoke.py (phases 2, 2b, 2j and 3f).

Both packages draw the same counter uniforms from the same folded seed
(the component at site 8, the random-azimuth azimuth and the flux mu at
site 2, the flux azimuth at site 9), so photon paths coincide up to float
rounding; the tolerances are tests/test_torch_record_kernel.py's and
tests/test_torch_radiance.py's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu.scenes.step_cloud import \
    make_step_cloud_multi as jmake_multi
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport.integrator import KernelConfig as JKernelConfig
from mcbrat3d_tpu.transport.integrator import run_batch as jrun_batch
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import (domain_from_numpy,
                                              multi_component_records)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.step_cloud import (make_step_cloud,
                                                  make_step_cloud_multi)
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

JAX_SMALL = jpk.PallasConfig(rows=16, block_rows=8, steps_per_call=32,
                             max_steps=6000, interpret=True)
SMALL = rk.RecordConfig(rows=16, steps_per_call=32, max_steps=6000)
# Domain-mean R/T/A gap allowed between the plain step and the JAX kernel
# (tests/test_torch_record_kernel.py's RTA_GAP): room for a few of the
# 4,096 photons to take another path after a 1-ulp difference in a
# transcendental, 1/8 of the one-sigma MC noise at this photon count.
RTA_GAP = 1e-3
# tests/test_torch_radiance.py's radiance limits: per-direction
# domain-mean gap (relative) and per-pixel gap (of the image maximum).
RAD_GAP = 1e-3
RAD_PIXEL_GAP = 1e-3
SOURCES = {
    "directional": (lambda: illumination.directional(0.5, 30.0),
                    lambda: jill.directional(0.5, 30.0)),
    "random_azimuth": (lambda: illumination.random_azimuth(0.6),
                       lambda: jill.random_azimuth(0.6)),
    "flux": (illumination.flux, jill.flux),
    "spotlight": (lambda: illumination.spotlight(0.8, 20.0, 0.3, 0.6),
                  lambda: jill.spotlight(0.8, 20.0, 0.3, 0.6)),
}


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def rta(fu, fd, ab, n):
    return np.array([float(np.sum(np.asarray(a))) for a in (fu, fd, ab)]) / n


def assert_pixels_agree(pairs, n_a, n_b):
    """Per-pixel z < 5 (the formula of tests/test_pallas.py)."""
    for a, b in pairs:
        a = np.asarray(a, np.float64) / n_a
        b = np.asarray(b, np.float64) / n_b
        sigma = np.sqrt(a / n_a + b / n_b + 1e-12)
        z = np.abs(a - b) / np.maximum(sigma, 1e-9)
        assert z.max() < 5.0, z.max()


def both_domains(ncomp, analytic, **kw):
    """The JAX package's and the port's step cloud (ncomp 1) or step cloud
    + gas (+ Rayleigh); ``analytic=False`` on one component takes the
    tabulated inverse-CDF row, as a file-read domain does."""
    if ncomp == 1:
        jd, td = jmake(**kw), make_step_cloud(**kw, device="cpu")
        if not analytic:
            jd = dataclasses.replace(jd, all_hg=False)
            td = dataclasses.replace(td, all_hg=False)
        return jd, td
    kw = dict(kw, n_components=ncomp, analytic=analytic)
    return jmake_multi(**kw), make_step_cloud_multi(**kw, device="cpu")


def jax_arrays(dom):
    """A JAX OpticalDomain's fields as the dict domain_from_numpy takes."""
    return dict(
        x_edges=np.asarray(dom.grid.x_edges),
        y_edges=np.asarray(dom.grid.y_edges),
        z_edges=np.asarray(dom.grid.z_edges),
        xy_regular=dom.grid.xy_regular, z_regular=dom.grid.z_regular,
        total_ext=np.asarray(dom.total_ext), cum_ext=np.asarray(dom.cum_ext),
        ssa=np.asarray(dom.ssa), phase_index=np.asarray(dom.phase_index),
        cell_records=np.asarray(dom.cell_records),
        inverse=np.asarray(dom.tables.inverse),
        forward=np.asarray(dom.tables.forward),
        forward_orig=np.asarray(dom.tables.forward_orig),
        offsets=np.asarray(dom.tables.offsets), all_hg=dom.all_hg,
        uniform_ssa=dom.uniform_ssa, uniform_hg=dom.uniform_hg,
        macro_factor=dom.macro_factor)


# ---------------------------------------------------------------------------
# The multi-component record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ncomp,analytic",
                         [(2, True), (2, False), (3, True), (3, False)])
def test_multi_component_records_match_jax(ncomp, analytic):
    """The 8 columns equal the JAX kernel's packed table bit for bit
    (B[lo, h*8 + r] is record r of cell h*128 + lo): float32 in JAX's
    order, sum over the components and cumsum / max(ssa_eff, 1e-30);
    built by the port and through domain_from_numpy of the JAX domain.
    The gas (component 1) has ssa 0 and adds nothing to the running sums:
    cs_0 is 1 with two components, and cs_0 == cs_1 < 1 with three."""
    jd, td = both_domains(ncomp, analytic, ssa=0.99, n_cdf_steps=101,
                          macro_factor=8)
    n = jd.cell_records.shape[0]
    h = -(-n // 128)
    b = np.asarray(jpk._pack_tables(jd, h, 8)[0])
    want = b.reshape(128, h, 8).transpose(1, 0, 2).reshape(h * 128, 8)[:n]
    for dom in (td, domain_from_numpy(jax_arrays(jd), device="cpu")):
        got = multi_component_records(dom)
        assert got.shape == (n, 8) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        assert multi_component_records(dom) is got  # built once
    assert td.all_hg == analytic or ncomp == 2
    if ncomp == 2:  # cloud + gas: only the cloud scatters
        assert np.all(want[:, 3] == 1.0) and np.all(want[:, 4] == 0.0)
    else:
        assert np.all(want[:, 4] == want[:, 3])
        assert np.all((want[:, 3] > 0.0) & (want[:, 3] < 1.0))
    tab = rk.RecordTables.from_domain(td)
    assert tab.records.shape == (n, 8)
    prm = rk.RecordParams.make(td, Surface.lambertian(0.0),
                               illumination.directional(0.5, 0.0), True, 1.0,
                               True)
    assert (prm.stride, prm.off_ssa, prm.off_f2, prm.ncomp) == (8, 2, 5,
                                                                ncomp)


# ---------------------------------------------------------------------------
# Plain step against the JAX interpret-mode kernel
# ---------------------------------------------------------------------------

# (components, analytic, source, macro_factor, n_columns)
PARITY_CASES = {
    "random_azimuth": (1, True, "random_azimuth", 8, 32),
    "flux": (1, True, "flux", 0, 32),
    "spotlight": (1, True, "spotlight", 8, 32),
    "2comp_analytic": (2, True, "directional", 8, 32),
    "2comp_tabulated": (2, False, "directional", 0, 32),
    "3comp_analytic": (3, True, "directional", 0, 32),
    "3comp_tabulated": (3, False, "directional", 8, 32),
    # a partial macro block at the x seam (ny = 1 makes y's virtual)
    "3comp_seam": (3, True, "flux", 8, 36),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_plain_step_matches_jax_interpret_kernel(case):
    ncomp, analytic, source, mf, nx = PARITY_CASES[case]
    jd, td = both_domains(ncomp, analytic, ssa=0.99, n_columns=nx,
                          n_cdf_steps=201, macro_factor=mf)
    assert (td.n_components, bool(td.all_hg)) == (
        ncomp, analytic or ncomp == 2)
    tsrc, jsrc = SOURCES[source]
    key = jrng.batch_key(3, 0)
    fu, fd, vol, n, n_bad, _ = jpk.run_batch_pallas(
        jd, JSurface.lambertian(0.2), jsrc(), key, JAX_SMALL,
        photons_per_lane=2)
    tu, tdn, tv, tn, t_bad, _ = rk.run_batch_record(
        td, Surface.lambertian(0.2), tsrc(), folded_seed(key), SMALL, 2)
    assert tn == int(n) == 16 * 128 * 2
    assert t_bad == int(n_bad) == 0
    tu, tdn, tv = (t.numpy() for t in (tu, tdn, tv))
    gap = np.abs(rta(tu, tdn, tv, tn) - rta(fu, fd, vol, int(n)))
    assert gap.max() < RTA_GAP, gap
    assert_pixels_agree([(tu, fu), (tdn, fd),
                         (tv.sum(axis=2), np.asarray(vol).sum(axis=2))],
                        tn, int(n))


def test_spotlight_enters_at_its_point():
    """Every spotlight photon enters the top at (solar_x, solar_y) of the
    domain, read from the source's own fields: on a clear domain the
    transmitted beam lands in one column, shifted by the slant path."""
    dom = make_step_cloud_multi(n_components=2, gas_ext=1e-6, tau_thin=1e-6,
                                tau_thick=1e-6, n_cdf_steps=101,
                                device="cpu")
    src = illumination.spotlight(0.5, 0.0, 0.3, 0.6)
    fu, fd, _, n, n_bad, _ = rk.run_batch_record(
        dom, Surface.lambertian(0.0), src, 1, SMALL, 1)
    assert n == 16 * 128 and n_bad == 0
    # 250 m thick, mu 0.5: the beam moves 433 m in +x from x = 150 m
    x_land = (0.3 * 500.0 + 250.0 * np.sqrt(0.75) / 0.5) % 500.0
    col = int(x_land // (500.0 / 32))
    assert float(fd[col, 0]) > 0.999 * n


# ---------------------------------------------------------------------------
# Radiance on three components
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def radiance_pair():
    """One radiance batch of the JAX interpret kernel and of the port's
    plain step on the tabulated 3-component step cloud (original table,
    each component's own rows), the random-azimuth source and a
    contribution cap low enough to clip."""
    kw = dict(ssa=0.99, n_components=3, analytic=False, n_cdf_steps=201,
              compute_intensity_tables=True)
    jdom, tdom = jmake_multi(**kw), make_step_cloud_multi(**kw, device="cpu")
    knobs = dict(use_russian_roulette=False, use_hybrid_phase=False,
                 limit_contributions=True, max_contribution=0.02)
    mus, phis = [1.0, 0.5], [0.0, 90.0]
    key = jrng.batch_key(3, 0)
    jt = jrun_batch(
        jdom, JSurface.lambertian(0.2), jill.random_azimuth(0.5), key,
        JKernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                      use_pallas="on", need_volume_absorption=False),
        JIcfg(n_dirs=2, pallas_march="cell", **knobs), jdirections(mus, phis))
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                       need_volume_absorption=False)
    dirs = le.make_intensity_directions(mus, phis, device="cpu")
    runs = [run_batch(tdom, Surface.lambertian(0.2),
                      illumination.random_azimuth(0.5), folded_seed(key),
                      cfg, intensity_config=le.IntensityConfig(
                          n_dirs=2, **dict(knobs, limit_contributions=cap)),
                      intensity_dirs=dirs)
            for cap in (True, False)]
    return jt, runs[0], runs[1]


def test_three_component_radiance_matches_jax(radiance_pair):
    """Per-slot capped excess (surface + 3 components) redistributed as the
    JAX kernel does; the cap clips (the uncapped image differs)."""
    jt, tt, free = radiance_pair
    n = int(jt.n_photons)
    assert tt.n_photons == n == 1024
    assert tt.n_bad == int(jt.n_bad) == 0
    ji, ti = np.asarray(jt.intensity), tt.intensity.numpy()
    assert ti.shape == ji.shape == (32, 1, 2)
    jm, tm = ji.mean(axis=(0, 1)), ti.mean(axis=(0, 1))
    assert np.all(jm > 0)
    gap = np.abs(tm - jm) / jm
    assert gap.max() < RAD_GAP, gap
    pixel_gap = np.abs(ti - ji).max() / np.abs(ji).max()
    assert pixel_gap < RAD_PIXEL_GAP, pixel_gap
    assert_pixels_agree([(ti, ji)], n, n)
    fi = free.intensity.double()
    assert float((tt.intensity.double() - fi).abs().max()) > (
        1e-3 * float(fi.max()))
    for a, b in ((tt.flux_up, jt.flux_up), (tt.flux_down, jt.flux_down),
                 (tt.flux_absorbed, jt.flux_absorbed)):
        assert abs(float(a.sum()) - float(np.sum(b))) / n < RTA_GAP


def test_cap_slots_per_component():
    """With the cap the tally carries one image section per slot: the
    surface and each component."""
    dom = make_step_cloud_multi(n_components=3, n_cdf_steps=101,
                                device="cpu")
    dirs = le.make_intensity_directions([1.0], [0.0], device="cpu")
    prm = rk.RecordParams.make(
        dom, Surface.lambertian(0.0), illumination.flux(), True, 1.0, True,
        le.IntensityConfig(n_dirs=1, use_hybrid_phase=False,
                           limit_contributions=True), dirs)
    assert (prm.n_sec, prm.n_exc, prm.source_kind) == (4, 4, 2)
    assert not rk.intensity_ineligibility_reasons(
        dom, Surface.lambertian(0.0), illumination.flux(), False, 0, False,
        le.IntensityConfig(n_dirs=1, use_hybrid_phase=False), dirs)


# ---------------------------------------------------------------------------
# Majorant across the periodic seam, and the envelope
# ---------------------------------------------------------------------------

def test_macro_majorant_at_periodic_seam_three_components():
    """nx = 36 with macro_factor 8: the last macro block is partial, so its
    outer face lies past the periodic seam. The carried majorant is record
    column 1 of the 8-column record; with clamped faces the two-level run
    must agree with the global majorant's."""
    sfc = Surface.lambertian(0.0)
    src = illumination.directional(0.5, 0.0)
    out = {}
    for mf in (0, 8):
        dom = make_step_cloud_multi(n_components=3, n_columns=36,
                                    n_cdf_steps=201, macro_factor=mf,
                                    device="cpu")
        assert torch.equal(rk.RecordTables.from_domain(dom).records[:, 1],
                           dom.cell_records[:, 1])
        out[mf] = rk.run_batch_record(dom, sfc, src, rng.batch_seed(11, mf),
                                      SMALL, 4)
    n0, n8 = out[0][3], out[8][3]
    assert n0 == n8 == 16 * 128 * 4
    assert out[0][4] == out[8][4] == 0
    assert_pixels_agree([(out[8][i].numpy(), out[0][i].numpy())
                         for i in range(2)]
                        + [(out[8][2].sum(dim=2).numpy(),
                            out[0][2].sum(dim=2).numpy())], n8, n0)
    r0 = rta(*(t.numpy() for t in out[0][:3]), n0)
    r8 = rta(*(t.numpy() for t in out[8][:3]), n8)
    sigma = np.sqrt(r0 * (1 - r0) * 2 / n0)
    assert np.all(np.abs(r8 - r0) < 4.5 * sigma), (r8, r0)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_real_collisions_are_counted(ncomp):
    """Every component a pure absorber over a black surface: each real
    collision ends its photon with its whole weight 1 absorbed, so the
    counted real collisions equal the absorbed weight, and none is missed
    or counted twice across launches."""
    kw = dict(ssa=0.0, n_cdf_steps=11, macro_factor=8, device="cpu")
    dom = (make_step_cloud(**kw) if ncomp == 1
           else make_step_cloud_multi(n_components=2, **kw))
    cfg = KernelConfig(n_lanes=16 * 128, photons_per_lane=4, max_steps=6000)
    t = rk.run_batch_record_tallies(dom, Surface.lambertian(0.0),
                                    illumination.directional(0.5, 0.0),
                                    rng.batch_seed(12, ncomp), cfg)
    assert t.n_photons == 16 * 128 * 4 and t.n_bad == 0
    assert t.n_steps > SMALL.steps_per_call  # more than one launch
    assert 0 < t.n_real <= t.n_photons < t.n_lane_steps
    assert t.n_real == float(t.flux_absorbed.sum())
    assert t.n_photons == t.n_real + float(t.flux_down.sum())


def test_envelope_names_what_is_still_to_port():
    """Every source and 1-3 components are in (emission with its alias
    tables, in lw_mode or not); uniform RPV and per-pixel surfaces pass
    JAX's surface predicate (a per-pixel one not in lw_mode) and their
    batch runs on the record kernel, R/T/A within RTA_GAP of JAX's kernel
    on the same folded seed (1,024 photons, 3 components, flux source); an
    emission source without alias tables (separable-backed), lw_mode
    without an emission source and more than three components each keep a
    named predicate."""
    dom = make_step_cloud_multi(n_components=3, n_cdf_steps=101,
                                device="cpu")
    lam = Surface.lambertian(0.1)
    nx, ny, nz = dom.grid.shape
    cdf = np.linspace(0.0, 1.0, nx * ny * nz + 1)[1:]
    emission = illumination.emission(cdf, 0.8, (nx, ny, nz), device="cpu")
    for make in (lambda: illumination.directional(0.5, 10.0),
                 lambda: illumination.random_azimuth(0.5),
                 illumination.flux,
                 lambda: illumination.spotlight(0.5, 0.0, 0.5, 0.5)):
        assert rk.ineligibility_reasons(dom, lam, make(), False, False, 0,
                                        False) == []
    for lw in (False, True):
        assert rk.ineligibility_reasons(dom, lam, emission, lw, False, 0,
                                        False) == []
    reasons = rk.ineligibility_reasons(
        dom, Surface(params=np.full((2, 2, 1), 0.2, np.float32)),
        illumination.Source(kind=illumination.EMISSION), True, False, 0,
        False)
    assert len(reasons) == 2, reasons
    assert reasons[0].startswith("non-uniform or unsupported-BRDF surface")
    assert reasons[1] == "source kind 'emission' not in-kernel"
    rpv = Surface(params=np.asarray([0.1, 0.8, -0.2], np.float32)
                  .reshape(1, 1, 3), brdf_name="RPV")
    grid2 = np.asarray([0.2, 0.6], np.float32).reshape(2, 1, 1)
    jdom = jmake_multi(n_components=3, n_cdf_steps=101)
    for i, (sfc, jsfc) in enumerate(
            ((rpv, JSurface.rpv(0.1, 0.8, -0.2)),
             (Surface(params=grid2), JSurface(params=grid2)))):
        assert rk.ineligibility_reasons(dom, sfc, illumination.flux(), False,
                                        False, 0, False) == []
        assert jpk.ineligibility_reasons(jdom, jsfc, jill.flux(), False,
                                         False, 0, False) == []
        key = jrng.batch_key(8, i)
        fu, fd, vol, n, n_bad, _ = jpk.run_batch_pallas(
            jdom, jsfc, jill.flux(), key,
            dataclasses.replace(JAX_SMALL, rows=8), photons_per_lane=1)
        before = rk.LAUNCHES
        tu, tdn, tv, tn, t_bad, _ = rk.run_batch_record(
            dom, sfc, illumination.flux(), folded_seed(key),
            dataclasses.replace(SMALL, rows=8), 1)
        assert rk.LAUNCHES == before  # the plain step: CPU tensors
        assert tn == int(n) == 8 * 128 and t_bad == int(n_bad) == 0
        gap = np.abs(rta(tu.numpy(), tdn.numpy(), tv.numpy(), tn)
                     - rta(fu, fd, vol, tn))
        assert gap.max() < RTA_GAP, gap
    assert rk.ineligibility_reasons(dom, lam, illumination.flux(), True,
                                    False, 0, False) == [
        "lw_mode without an emission source"]
    four = dataclasses.replace(dom, cum_ext=torch.zeros(32, 1, 32, 4))
    assert any("n_components=4 > 3" in r for r in rk.ineligibility_reasons(
        four, lam, illumination.flux(), False, False, 0, False))
