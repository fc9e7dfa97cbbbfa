"""PyTorch port: the column kernel's thermal emission (K3-b), the column
BBEmission refill and its lw_mode pre-credits.

The plain PyTorch step (what ``col_launch`` runs on the CPU) against the JAX
column kernel in Pallas interpret mode, path for path: both draw the same
counter uniforms from the same folded seed, the column scales are
bfloat16-exact and the emission tables are equal, so the births and the
photon paths coincide. Two differences remain, both the JAX kernel's:

* the alias acceptance: JAX compares the uniform with the probability's
  bfloat16 hi/lo reconstruction (within ~2^-16 of the float32 value), the
  port with the float32 value. A birth whose uniform falls between the two
  starts in another column there. ``parted_births`` counts such births
  among every refill of a run; the parity tests allow
  PARTED_PER_BIRTH of the births (none parted on the seeds here) and widen
  the per-column limits by the weight a parted photon moves.
* the level pre-credits: JAX's kernel reassigns ``z_b`` (the birth level,
  pallas_col.py:442) to the boundary plane (:564) before its profile and
  3D pre-credits read it (:1039, :1050), so it credits level 0 (or, when
  the birth's first step leaves the top, nothing) instead of the birth
  level; its column pre-credit and its XLA path are right. The port
  credits the birth level, so the tests hold the port's gross profile and
  3D field (lw_mode off: the same paths, no pre-credits) against JAX's
  above level 0, and its net column absorption against JAX's.

The tolerances are tests/test_torch_col_kernel.py's: exits 4e-3 (JAX's
bf16 exit weights), absorption 1e-4 (its bf16 hi/lo pairs) of the largest
column or level (net values cancel towards zero), the 3D field 1e-5.

Also: the column predicate against JAX's ``pallas_col_eligible``, the
``col_em_*`` tables against the JAX ``build_domain``, ``run_batch`` at 64 x
32 x 32 (past the record kernel's 36,864 cells) against JAX's
``run_batch(use_pallas="on")``, and invariants of the port's refill: the
level histogram against the truncated Planck density, the column marginal
of a thin atmosphere, the pre-credit count and the net tallies' marginals.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.core.grid import Grid as JGrid
from mcbrat3d_tpu.domain.domain import OpticalComponent as JComponent
from mcbrat3d_tpu.domain.domain import build_domain as jbuild
from mcbrat3d_tpu.physics.phase_function import PhaseFunction as JPF
from mcbrat3d_tpu.physics.phase_function import PhaseFunctionTable as JPFT
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.spectral import weights as jweights
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu_torch.core import planck, rng
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent, build_domain,
                                              domain_from_numpy)
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import weights
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig, run_batch,
                                                     select_kernel)

torch.set_num_threads(1)

EXIT_RTOL, ABS_RTOL, VOL_RTOL = 4e-3, 1e-4, 1e-5
# Parted births allowed per birth: the acceptance uniform must fall in the
# gap between the float32 probability and its bf16 hi/lo reconstruction,
# at most ~2^-16 of it, so a few per 10^5 births.
PARTED_PER_BIRTH = 5e-5
# Weight one parted photon can move between tallies (its start, -1, and
# its end, +1, each reflection off the 0.05 albedo adding a little more).
PARTED_WEIGHT = 2.2


def column_field(nx, ny, nz, seed=0, max_scale=0.05):
    """Broken-cloud extinction [nx, ny, nz] with bfloat16-exact column
    scales (tests/test_torch_col_kernel.py's scene)."""
    rs = np.random.RandomState(seed)
    f = rs.rand(nx, ny)
    for _ in range(3):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    scale = rs.rand(nx, ny) * max_scale * (f > np.quantile(f, 0.55))
    scale = torch.tensor(scale, dtype=torch.float32).to(
        torch.bfloat16).double().numpy()
    h = np.ceil(f * nz).astype(int) * (scale > 0)
    return np.where(np.arange(nz)[None, None, :] < h[:, :, None],
                    scale[:, :, None], 0.0)


def lapse_temps(nx, ny, nz, dz_km=0.05):
    """The lapse-rate profile 288 K - 6.5 K/km at the cell centres, the
    same in every column (so the column emission tables build)."""
    tz = 288.0 - 6.5 * (np.arange(nz) + 0.5) * dz_km
    return np.broadcast_to(tz, (nx, ny, nz)).copy()


def lw_domains(shape, macro_factor, ssa=0.6, temps=None, max_scale=0.05):
    """(JAX domain, port domain, temps) of one HG component with the
    temperatures and lambda 10 um."""
    nx, ny, nz = shape
    ext = column_field(nx, ny, nz, max_scale=max_scale)
    temps = lapse_temps(nx, ny, nz) if temps is None else temps
    args = (ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32))
    kw = dict(n_cdf_steps=201, macro_factor=macro_factor, temps=temps,
              lambda_um=10.0)
    jd = jbuild(JGrid.regular(nx, ny, nz, 100.0, 100.0, 50.0),
                [JComponent("cloud", *args,
                            JPFT([JPF.henyey_greenstein(0.85, 64)],
                                 key=[1.0]))], **kw)
    td = build_domain(Grid.regular(nx, ny, nz, 100.0, 100.0, 50.0,
                                   device="cpu"),
                      [OpticalComponent("cloud", *args, PhaseFunctionTable(
                          [PhaseFunction.henyey_greenstein(0.85, 64)],
                          key=[1.0]))], **kw)
    return jd, td, temps


def emission_sources(jd, td, temps, emissivity=0.95):
    """(JAX source, port source): the per-voxel emission of the domain's
    absorption (surface 288 K)."""
    kabs = np.asarray(jd.total_ext) * (1.0 - np.asarray(jd.ssa)[..., 0])
    jw = jweights.emission_weighting(jd.grid, temps, kabs, 288.0,
                                     emissivity, 10.0)
    tw = weights.emission_weighting(td.grid, temps, kabs, 288.0, emissivity,
                                    10.0)
    return (jill.emission(jw.voxel_cdf, jw.frac_atms_power, jd.grid.shape),
            illumination.emission(tw.voxel_cdf, tw.frac_atms_power,
                                  td.grid.shape, device="cpu"))


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas_col folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def jax_probability(prob: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's acceptance probability: the bf16 hi part plus the
    bf16 rounding of the residual, summed in float32
    (pallas_col.py:1156-1165)."""
    hi = prob.to(torch.bfloat16).float()
    return hi + (prob - hi).to(torch.bfloat16).float()


@pytest.fixture
def parted_births(monkeypatch):
    """Counts, over every plain step run while the fixture is active, the
    atmospheric births whose alias decision differs under the JAX kernel's
    acceptance probability; returns a dict with ``parted`` and
    ``births``."""
    counts = {"parted": 0, "births": 0}
    step = ck.col_step_plain

    def counting(st, tab, prm, lane, seed, ctr, tally):
        if ck.SOURCE_KINDS[prm.source_kind] == illumination.EMISSION:
            u = rng.make_uniform(lane, seed)
            need = (st.alive == 0) & (st.quota > 0)
            atm = need & (u(ctr, ck.SITE_EM_SPLIT) < prm[ck.C_ATMS])
            nxy = prm.nx * prm.ny
            jbin = torch.clamp((u(ctr, ck.SITE_EM_BIN) * float(nxy)).to(
                torch.int32), max=nxy - 1).long()
            acc = u(ctr, ck.SITE_EM_ACCEPT)
            part = ((acc >= tab.em_prob[jbin])
                    != (acc >= jax_probability(tab.em_prob)[jbin]))
            counts["parted"] += int((atm & part).sum())
            counts["births"] += int(atm.sum())
        return step(st, tab, prm, lane, seed, ctr, tally)

    monkeypatch.setattr(ck, "col_step_plain", counting)
    return counts


def assert_close(port, ref, rtol, name, scale=None, atol=0.0):
    """Every entry within rtol of the largest |ref| (``scale``, else the
    entry's own |ref|) plus ``atol``."""
    port = port.cpu().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    lim = rtol * (np.abs(ref) if scale is None else scale) + atol
    gap = np.abs(port - ref)
    assert not (gap > lim).any(), (name, int((gap > lim).sum()),
                                   float(gap.max()))


# ---------------------------------------------------------------------------
# The column predicate and the emission tables
# ---------------------------------------------------------------------------

PREDICATE_CASES = ["emission", "lw_without_emission", "per_pixel",
                   "per_pixel_emission", "per_pixel_lw", "untiled_grid",
                   "uniform", "emission_without_tables"]


@pytest.mark.parametrize("case", PREDICATE_CASES)
def test_column_predicate_matches_jax(case):
    """col_ineligibility_reasons is empty exactly where JAX's
    pallas_col_eligible holds, and no reason says a part is not ported."""
    shape = (24, 16, 8)
    temps = None
    if case == "emission_without_tables":  # temperatures vary by column
        temps = lapse_temps(*shape) + np.random.RandomState(1).rand(*shape)
    jd, td, temps = lw_domains(shape, 4, temps=temps)
    jsrc, tsrc = emission_sources(jd, td, temps)
    emission = case in ("emission", "per_pixel_emission",
                        "emission_without_tables")
    if not emission:
        jsrc, tsrc = jill.directional(0.5, 0.0), illumination.directional(
            0.5, 0.0)
    lw = case in ("emission", "lw_without_emission", "per_pixel_lw",
                  "emission_without_tables")
    grid = {"per_pixel": (4, 4), "per_pixel_emission": (4, 4),
            "per_pixel_lw": (8, 4), "untiled_grid": (5, 4)}.get(case)
    if grid is None:
        jsfc, tsfc = JSurface.lambertian(0.2), Surface.lambertian(0.2)
    else:
        p = np.full(grid + (1,), 0.3, np.float32)
        jsfc, tsfc = JSurface(params=p), Surface(params=p)
    kw = dict(lw_mode=lw, compute_intensity=False,
              record_scattering_orders=0, use_ray_tracing=False,
              need_volume_absorption=True)
    want = jpc.pallas_col_eligible(jd, jsfc, jsrc, **kw)
    reasons = ck.col_ineligibility_reasons(td, tsfc, tsrc, **kw)
    assert (not reasons) == want, reasons
    assert want == (case in ("emission", "per_pixel", "uniform"))
    assert not any("not ported" in r for r in reasons), reasons


@pytest.mark.parametrize("shape,macro_factor", [((24, 16, 8), 4),
                                                ((16, 20, 12), 0)])
def test_emission_tables_match_jax(shape, macro_factor):
    """The col_em_* tables equal the JAX build_domain's: the alias
    probabilities, targets and target heights exactly, the cumulative
    Planck table to 1 ulp; h[alias[col]] is the target's height."""
    jd, td, _ = lw_domains(shape, macro_factor)
    for name in ("col_em_prob", "col_em_alias", "col_em_halias"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    np.testing.assert_array_max_ulp(td.col_em_fcum.numpy(),
                                    np.asarray(jd.col_em_fcum), maxulp=1)
    alias = td.col_em_alias.numpy().astype(np.int64)
    np.testing.assert_array_equal(td.col_em_halias.numpy(),
                                  td.col_height.numpy()[alias])
    assert td.col_em_fcum.shape == (shape[2],)


def test_no_emission_tables_where_jax_builds_none():
    """Temperatures that vary across columns, or no temperatures, give no
    column emission tables, as in JAX."""
    shape = (16, 16, 8)
    temps = lapse_temps(*shape)
    temps[3, 5, :] += 1.0
    jd, td, _ = lw_domains(shape, 4, temps=temps)
    assert jd.col_em_prob is None and td.col_em_prob is None
    assert td.col_template


def test_domain_from_numpy_carries_the_jax_tables():
    """domain_from_numpy takes the JAX domain's column and emission fields
    as they are: the port then runs the same batch bit for bit as on its
    own build."""
    jd, td, temps = lw_domains((16, 12, 8), 4)
    xe, ye, ze = (np.asarray(e) for e in (jd.grid.x_edges, jd.grid.y_edges,
                                          jd.grid.z_edges))
    names = ("total_ext", "cum_ext", "ssa", "phase_index", "cell_records",
             "col_scale", "col_height", "macro_table", "col_em_prob",
             "col_em_alias", "col_em_halias", "col_em_fcum")
    arrays = {k: np.asarray(getattr(jd, k)) for k in names}
    arrays.update(
        x_edges=xe, y_edges=ye, z_edges=ze, xy_regular=jd.grid.xy_regular,
        z_regular=jd.grid.z_regular, col_template=jd.col_template,
        inverse=np.asarray(jd.tables.inverse),
        forward=np.asarray(jd.tables.forward),
        forward_orig=np.asarray(jd.tables.forward_orig),
        offsets=np.asarray(jd.tables.offsets), all_hg=jd.all_hg,
        uniform_ssa=jd.uniform_ssa, uniform_hg=jd.uniform_hg,
        macro_factor=jd.macro_factor, temps=temps, lambda_um=10.0)
    fed = domain_from_numpy(arrays, device="cpu")
    tsrc = emission_sources(jd, td, temps)[1]
    ccfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=20_000,
                           vol_tally=True)
    a, b = (ck.run_batch_col(d, Surface.lambertian(0.05), tsrc, 23, ccfg, 1,
                             lw_mode=True) for d in (td, fed))
    for name in ("flux_up", "flux_down", "flux_absorbed",
                 "absorption_profile", "volume_absorption"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# The plain step against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("macro_factor", [8, 0])
def test_plain_step_matches_jax_interpret_kernel(macro_factor,
                                                 parted_births):
    """24 x 16 x 8 (nx != ny, so an axis swap of the birth column shows),
    ssa 0.6, albedo 0.05, lw_mode with the 3D tally: equal births and
    steps, parted births within their bound, exits, the net column
    absorption and (with lw_mode off, the same paths) the gross profile and
    3D field above level 0 as JAX's; the port's pre-credits are -1 per
    atmospheric birth at its column, level and cell."""
    jd, td, temps = lw_domains((24, 16, 8), macro_factor)
    jsrc, tsrc = emission_sources(jd, td, temps)
    key = jrng.batch_key(3, macro_factor)
    fu, fd, ac, az, vol, n, n_bad, n_calls = jpc.run_batch_pallas_col(
        jd, JSurface.lambertian(0.05), jsrc, key,
        jpk.PallasConfig(rows=8, block_rows=8, steps_per_call=32,
                         max_steps=20_000, interpret=True),
        2, need_vol=True, lw_mode=True)
    ccfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=20_000,
                           vol_tally=True)
    runs = {lw: ck.run_batch_col(td, Surface.lambertian(0.05), tsrc,
                                 folded_seed(key), ccfg, 2, lw_mode=lw)
            for lw in (True, False)}
    t, gross = runs[True], runs[False]
    assert t.n_photons == gross.n_photons == int(n) == 8 * 128 * 2
    assert t.n_bad == int(n_bad) == 0
    assert t.n_steps == gross.n_steps == int(n_calls) * 32
    assert t.n_lane_steps == gross.n_lane_steps
    births = parted_births["births"] // 2  # both runs counted
    assert t.n_atm_births == gross.n_atm_births == births
    assert births > 0.5 * t.n_photons
    parted = parted_births["parted"] // 2
    assert parted <= PARTED_PER_BIRTH * births + 1, parted
    slack = PARTED_WEIGHT * parted
    assert_close(t.flux_up, fu, EXIT_RTOL, "flux_up", atol=slack)
    assert_close(t.flux_down, fd, EXIT_RTOL, "flux_down", atol=slack)
    ac = np.asarray(ac)
    assert_close(t.flux_absorbed, ac, ABS_RTOL, "net column absorption",
                 scale=np.abs(ac).max(), atol=slack)
    az, vol = np.asarray(az), np.asarray(vol)
    assert_close(gross.absorption_profile[1:], az[1:], ABS_RTOL,
                 "profile above level 0", scale=np.abs(az).max(),
                 atol=slack)
    assert_close(gross.volume_absorption[:, :, 1:], vol[:, :, 1:],
                 VOL_RTOL, "3D field above level 0",
                 scale=np.abs(vol).max(), atol=slack)
    # the port's pre-credits: -1 per atmospheric birth, at its column, at
    # its level and in its cell; JAX's column pre-credits match
    credit_col = (t.flux_absorbed - gross.flux_absorbed).double()
    credit_vol = (t.volume_absorption - gross.volume_absorption).double()
    credit_prof = (t.absorption_profile - gross.absorption_profile).double()
    for credit in (credit_col, credit_vol, credit_prof):
        assert abs(float(credit.sum()) + births) < 1e-2 * births
        assert float(credit.max()) < 1e-3
    torch.testing.assert_close(credit_vol.sum(dim=2), credit_col,
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(credit_vol.sum(dim=(0, 1)), credit_prof,
                               rtol=0, atol=2e-3)
    assert int((credit_prof < -0.5).sum()) > 1  # spread over the levels


# ---------------------------------------------------------------------------
# run_batch past the record kernel, against JAX's run_batch
# ---------------------------------------------------------------------------

def test_run_batch_matches_jax_past_the_record_kernel(monkeypatch,
                                                      parted_births):
    """64 x 32 x 32 (65,536 cells: past the record kernel's 36,864) with
    lw_mode and the profile: both packages' run_batch take the column
    kernel; the same folded seed and lane geometry give the same paths, so
    up and down fluxes and the net column absorption are JAX's to the
    plain-step test's tolerances, widened only by the weight of parted
    births (within their bound). The port's column kernel runs the JAX
    package's launch geometry here (``rk.jax_geometry``), where its lanes
    carry JAX's photons; by default it runs the refill schedule."""
    jd, td, temps = lw_domains((64, 32, 32), 8, ssa=0.5)
    jsrc, tsrc = emission_sources(jd, td, temps)
    key = jrng.batch_key(5, 0)
    kw = dict(n_lanes=1024, photons_per_lane=2, max_steps=20_000,
              lw_mode=True, need_volume_absorption=False,
              need_absorption_profile=True)
    cfg = KernelConfig(**kw)
    assert select_kernel(td, Surface.lambertian(0.05), tsrc, cfg)[0] == "col"
    monkeypatch.setattr(ck, "run_batch_col_tallies", functools.partial(
        ck.run_batch_col_tallies, ccfg=rk.jax_geometry(cfg)))
    picked = []
    orig = jpc.run_batch_pallas_col_tallies

    def record(*args, **kwargs):
        picked.append("column")
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpc, "run_batch_pallas_col_tallies", record)
    tj = jintegrator.run_batch(
        jd, JSurface.lambertian(0.05), jsrc, key,
        jintegrator.KernelConfig(use_pallas="on", **kw))
    assert picked == ["column"]
    t = run_batch(td, Surface.lambertian(0.05), tsrc, folded_seed(key), cfg)
    assert t.n_photons == int(tj.n_photons) == 2048
    assert t.n_bad == int(tj.n_bad) == 0
    births, parted = parted_births["births"], parted_births["parted"]
    assert births > 0.5 * t.n_photons
    assert parted <= PARTED_PER_BIRTH * births + 1, parted
    slack = PARTED_WEIGHT * parted
    assert_close(t.flux_up, tj.flux_up, EXIT_RTOL, "flux_up", atol=slack)
    assert_close(t.flux_down, tj.flux_down, EXIT_RTOL, "flux_down",
                 atol=slack)
    ac = np.asarray(tj.flux_absorbed)
    assert_close(t.flux_absorbed, ac, ABS_RTOL, "net column absorption",
                 scale=np.abs(ac).max(), atol=slack)
    assert float(t.flux_absorbed.sum()) < 0  # net of the pre-credits


# ---------------------------------------------------------------------------
# Invariants of the port's refill
# ---------------------------------------------------------------------------

def _refill(td, tsrc, n=1 << 16, ctr=0, seed=9):
    prm = ck.ColParams.make(td, Surface.lambertian(0.05), tsrc, True, 1.0,
                            False, lw_mode=True)
    tab = ck.ColTables.from_domain(td, emission=True)
    u = rng.make_uniform(torch.arange(n, dtype=torch.int64), seed)
    return prm, ck.col_emission_refill(u, ctr, tab, prm)


def test_birth_level_follows_the_truncated_planck_density():
    """Over 2^16 refills the atmospheric births' (column, level) pairs
    follow the emission density scale[col] * B(T(z)) below the column's
    top: the level histogram against the mixture of the truncated
    cumulative-Planck densities, within 5 sigma per level; births lie in
    their column and level (but for a birth whose float32 position rounds
    onto the next cell's face: at most two here), inside the domain."""
    jd, td, temps = lw_domains((24, 16, 12), 4)
    tsrc = emission_sources(jd, td, temps)[1]
    prm, (x, y, z, mu, from_atm, col_b, lvl) = _refill(td, tsrc)
    nx, ny, nz = td.grid.shape
    scale = td.col_scale.double().numpy()
    h = td.col_height.numpy().astype(np.int64)
    b = planck.planck_radiance(10.0, temps[0, 0])
    w_col = scale[:, None] * b[None, :] * (np.arange(nz)[None, :]
                                           < h[:, None])
    expect = w_col.sum(axis=0) / w_col.sum()
    atm = from_atm.numpy()
    n_atm = int(atm.sum())
    got = np.bincount(lvl.numpy()[atm], minlength=nz)[:nz]
    sigma = np.sqrt(n_atm * expect * (1 - expect)) + 1.0
    assert np.all(np.abs(got - n_atm * expect) < 5 * sigma), (got,
                                                               n_atm * expect)
    cols = col_b.numpy()[atm]
    assert int((lvl.numpy()[atm] >= h[cols]).sum()) <= 2
    dx, dz = 100.0, 50.0
    ix = (x.numpy()[atm] / dx).astype(np.int64)
    iy = (y.numpy()[atm] / dx).astype(np.int64)
    assert int((ix * ny + iy != cols).sum()) <= 2
    iz = (z.numpy()[atm] / dz).astype(np.int64)
    assert int((iz != lvl.numpy()[atm]).sum()) <= 2
    assert np.all(np.abs(mu.numpy()[atm]) >= 1e-4)
    sfc = ~atm
    assert np.all(mu.numpy()[sfc] > 0)
    assert np.all(z.numpy()[sfc] == prm[ck.C_ZBOT])


def test_thin_atmosphere_net_column_is_the_emission_marginal():
    """An optically thin, all-atmosphere run (emissivity 0): nearly every
    emitted photon escapes, so minus the net column absorption follows
    the column marginal scale[col] * Fcum[h - 1] (correlation > 0.95,
    JAX's test_emission_spatial_distribution); the pre-credits sum to minus
    the photons started."""
    jd, td, temps = lw_domains((16, 16, 8), 4, ssa=0.3, max_scale=0.001)
    tsrc = emission_sources(jd, td, temps, emissivity=0.0)[1]
    assert tsrc.atms_fraction == 1.0
    t = ck.run_batch_col(td, Surface.lambertian(0.05), tsrc, 61,
                         rk.RecordConfig(rows=8, steps_per_call=32,
                                         max_steps=20_000), 16, lw_mode=True)
    n = t.n_photons
    got = -t.flux_absorbed.double().numpy().reshape(-1) / n
    scale = td.col_scale.double().numpy()
    h = td.col_height.numpy().astype(np.int64)
    fcum = td.col_em_fcum.double().numpy()
    dens = scale * np.where(h > 0, fcum[np.maximum(h - 1, 0)], 0.0)
    dens /= dens.sum()
    assert np.corrcoef(dens, got)[0, 1] > 0.95
    assert 0.7 * dens.sum() < got.sum() <= 1.0 + 1e-6


def test_net_marginals_and_the_precredit_count():
    """With lw_mode and the 3D tally the net 3D field sums to the net
    column absorption and to the net profile; the pre-credits (lw_mode on
    minus off, the same paths) count the atmospheric births, a binomial
    share atms_fraction of the photons within 5 sigma, as the launch
    counter does."""
    jd, td, temps = lw_domains((16, 16, 8), 0)
    tsrc = emission_sources(jd, td, temps)[1]
    ccfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=20_000,
                           vol_tally=True)
    t, gross = (ck.run_batch_col(td, Surface.lambertian(0.05), tsrc, 17,
                                 ccfg, 4, lw_mode=lw) for lw in (True, False))
    # float32 sums of thousands of weights per level, in other orders; a
    # misplaced pre-credit moves a level or column by whole units
    torch.testing.assert_close(t.volume_absorption.sum(dim=2),
                               t.flux_absorbed, rtol=0, atol=1e-2)
    torch.testing.assert_close(t.volume_absorption.sum(dim=(0, 1)),
                               t.absorption_profile, rtol=0, atol=1e-2)
    n = t.n_photons
    births = -float((t.flux_absorbed - gross.flux_absorbed).double().sum())
    f = tsrc.atms_fraction
    assert abs(births - n * f) < 5 * np.sqrt(n * f * (1 - f)) + 1
    assert abs(round(births) - births) < 1e-2
    assert t.n_atm_births == gross.n_atm_births == round(births)
