"""PyTorch port: the separable-template kernel (K4).

The plain PyTorch step (what ``sep_launch`` runs on the CPU) against the JAX
separable kernel in Pallas interpret mode, the separable detection, block
ceilings and emission tables against the JAX ``build_domain``, the Walker
alias tables against ``native/alias.cpp`` and the LW energy identity (the
dispatch against the JAX package's own choice is in
``test_torch_sep_dispatch.py``). The CUDA kernel is held against the
plain step on the card by chip_smoke.py (phase 2e).

Parity tolerances. Both packages draw the same counter uniforms from the
same folded seed, and the test scenes' amplitudes and z profiles are
bfloat16-exact, so the JAX kernel's bf16 hi/lo gathers of amp, p and q are
exact and the photon paths coincide up to float rounding. What remains:

* the JAX kernel's tally rounding: each exit weight is tallied as a
  bfloat16 (at most 2^-9 relative, so a column sum differs by at most
  2^-9 relative -> EXIT_RTOL 4e-3); absorption and the z profile as a bf16
  hi/lo pair (about 2^-16 relative per weight -> ABS_RTOL 1e-4 of the
  column's value, plus ABS_ATOL 1e-4 of a weight per photon of the column,
  because LW net absorption sums positive weights and -1 pre-credits to
  values near zero);
* photons whose paths part: XLA's CPU compiler contracts a*b + c into fused
  multiply-adds inside the jitted interpret-mode kernel, while the plain
  step (like the CUDA kernel, built with -fmad=false) rounds the product.
  The clip nudge is about one ulp of z, so a photon clipped onto a slab
  plane can land on the other side of it and then follows another path;
  with the tabulated phase row every scattering angle a0 + frac * dd is
  such an FMA, so scattered photons carry ulp-different directions to
  their next plane. Each parted photon moves at most its own weight and
  its pre-credit, so beyond the bounds above a tally may differ by at most
  2 x DIVERGED_SHARE of the photons' weight (0.5%: at most 10 parted
  photons of 2,048). On the seeds and scenes used the excess is 0 to 1.1
  with analytic HG and up to 8 with the tabulated row; a wrong branch moves
  hundreds (the flux source's configuration keeps the slab up to the
  domain top: entering it from above, every photon's first clip is such a
  coin toss).

The JAX kernel's z aliases are bf16 hi/lo pairs too (2^-16), so a birth
level could in principle differ; on these seeds it does not.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.domain.domain import build_domain as jbuild
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.collection import lw_flagship_scene as jscene
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import lw_flagship_scene
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport import sep_kernel as sk

torch.set_num_threads(1)

EXIT_RTOL, ABS_RTOL, ABS_ATOL = 4e-3, 1e-4, 1e-4
DIVERGED_SHARE = 0.005
SEP_FIELDS = ("sep_amp", "sep_pz", "sep_qz", "sep_block", "sep_tz",
              "sep_scalars", "sep_em_zpa", "sep_em_pb")
FLAGS = ("sep_template", "sep_zb", "sep_zt", "sep_analytic_hg",
         "sep_inv_row", "sep_tz_uniform", "n_components")


def _value(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas_sep folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


# ---------------------------------------------------------------------------
# Host tables: Walker alias, detection, block ceilings, emission tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "sparse", "spiky", "flat"])
def test_walker_alias_matches_native(case):
    """The port's Vose construction builds native/alias.cpp's tables (the
    JAX package's ``_walker_alias`` uses that library when g++ builds
    it)."""
    r = np.random.RandomState(4)
    p = {"random": r.rand(5000),
         "sparse": r.rand(3000) * (r.rand(3000) > 0.9),
         "spiky": np.r_[r.rand(999) * 1e-6, 1.0],
         "flat": np.full(826, 0.25)}[case]
    assert jill._walker_alias(np.ones(2))[0] is not None
    assert jill._ALIAS_NATIVE is not None, "native/alias.cpp did not build"
    prob, alias = illumination._walker_alias(p)
    jprob, jalias = jill._walker_alias(p)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(alias, jalias)


@pytest.mark.parametrize("nx,macro_factor,fields", [
    (16, 8, "full"), (16, 8, "compact"),
    (20, 8, "full"),       # 20 is not a multiple of 8: partial last blocks
    (20, 8, "compact"), (16, 0, "compact")])
def test_separable_detection_matches_jax(nx, macro_factor, fields):
    """sep_* fields, the bf16-bumped block ceilings, the emission z aliases
    and the atmosphere/surface split bit-equal to the JAX package's on the
    flagship scene at nx x nx x 150."""
    kw = dict(macro_factor=macro_factor, n_cdf_steps=201, lambda_um=10.0,
              device_fields=fields)
    jg, jc, jt = jscene(nx=nx, ny=nx, nz=150)
    tg, tc, tt = lw_flagship_scene(nx=nx, ny=nx, nz=150, device="cpu")
    jd, td = jbuild(jg, jc, temps=jt, **kw), build_domain(tg, tc, temps=tt,
                                                          **kw)
    assert td.sep_template and (td.cell_records is None) == (
        fields == "compact")
    for f in SEP_FIELDS:
        np.testing.assert_array_equal(_value(getattr(td, f)),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    for f in FLAGS:
        assert getattr(td, f) == getattr(jd, f), f
    assert td.sep_em_atm == jd.sep_em_atm
    np.testing.assert_array_equal(td.sep_amp_np, jd._sep_amp_np)
    # the stored block ceiling bounds the in-slab extinction of its block
    f = macro_factor or nx
    nb = -(-nx // f)
    amp = td.sep_amp.numpy().reshape(nx, nx)
    beta_max = (amp * td.sep_pz.numpy().max()
                + td.sep_qz.numpy()[td.sep_zb:td.sep_zt].max())
    blk = (np.arange(nx)[:, None] // f) * nb + np.arange(nx)[None, :] // f
    assert np.all(td.sep_block.numpy()[blk] >= beta_max)
    src, jsrc = (illumination.emission_separable(td, 288.0, 0.95),
                 jill.emission_separable(jd, 288.0, 0.95))
    assert src.em_sep and src.atms_fraction == float(jsrc.atms_fraction)
    np.testing.assert_array_equal(
        sk.sep_emission_groups(td.sep_amp_np),
        np.asarray(jsep._pack_sep_emission_groups(jd)).reshape(3, 1024)[
            :, :-(-nx * nx // 128)])


def test_non_separable_is_rejected():
    """A full-rank field is not separable: the full build carries no sep
    fields and the compact build raises, in the port as in JAX."""
    r = np.random.RandomState(3)
    ext = 0.5 + r.rand(8, 8, 12)
    args = (ext, np.full_like(ext, 0.9), np.zeros(ext.shape, np.int32))
    from mcbrat3d_tpu.core.grid import Grid as JGrid
    from mcbrat3d_tpu.domain.domain import OpticalComponent as JComp
    from mcbrat3d_tpu.physics.phase_function import PhaseFunction as JPF
    from mcbrat3d_tpu.physics.phase_function import PhaseFunctionTable as JPFT
    tg = Grid.regular(8, 8, 12, 0.1, 0.1, 0.1, device="cpu")
    jg = JGrid.regular(8, 8, 12, 0.1, 0.1, 0.1)
    tc = [OpticalComponent("random", *args, PhaseFunctionTable(
        [PhaseFunction.henyey_greenstein(0.85, 32)], key=[1.0]))]
    jc = [JComp("random", *args, JPFT([JPF.henyey_greenstein(0.85, 32)],
                                      key=[1.0]))]
    assert not build_domain(tg, tc).sep_template
    assert not jbuild(jg, jc).sep_template
    for fn, g, c in ((build_domain, tg, tc), (jbuild, jg, jc)):
        with pytest.raises(ValueError, match="separable"):
            fn(g, c, device_fields="compact")


# ---------------------------------------------------------------------------
# The plain step against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

def _bf16(v):
    return torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16).double().numpy()


def exact_scenes(nx, nz, cloud_base_level, cloud_top_level):
    """(JAX, port) (grid, components, temps) of the flagship scene with
    bf16-exact amplitudes (the strongest column exactly 1) and z profiles,
    so the JAX kernel's bf16 hi/lo gathers are exact."""
    kw = dict(nx=nx, ny=nx, nz=nz, cloud_base_level=cloud_base_level,
              cloud_top_level=cloud_top_level, cloud_beta_max=8.0)
    (jg, jc, jt) = jscene(**kw)
    (tg, tc, tt) = lw_flagship_scene(**kw, device="cpu")
    e = jc[0].extinction
    i, j = np.unravel_index(np.argmax(e.sum(axis=2)), e.shape[:2])
    prof = _bf16(e[i, j, :])
    amp = _bf16(e[:, :, -1] / e[i, j, -1])
    amp[i, j] = 1.0
    for comps in (jc, tc):
        comps[0].extinction = amp[:, :, None] * prof[None, None, :]
        comps[1].extinction = _bf16(jc[1].extinction)
    return (jg, jc, jt), (tg, tc, tt)


SOURCES = {
    "emission": (lambda d: illumination.emission_separable(d, 288.0, 0.95),
                 lambda d: jill.emission_separable(d, 288.0, 0.95)),
    "directional": (lambda d: illumination.directional(0.5, 0.0),
                    lambda d: jill.directional(0.5, 0.0)),
    "random_azimuth": (lambda d: illumination.random_azimuth(0.5),
                       lambda d: jill.random_azimuth(0.5)),
    "flux": (lambda d: illumination.flux(), lambda d: jill.flux()),
}


def assert_tally(port, ref, rtol, atol, n_photons, name):
    port = port.cpu().numpy().astype(np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    assert port.shape == ref.shape, name
    excess = np.maximum(np.abs(port - ref) - rtol * np.abs(ref) - atol, 0.0)
    assert excess.sum() <= 2.0 * DIVERGED_SHARE * n_photons, (
        name, int((excess > 0).sum()), float(excess.sum()))


@pytest.mark.parametrize(
    "source,nx,macro_factor,use_rr,analytic,slab",
    [("emission", 16, 8, True, True, (55, 85)),
     ("emission", 16, 0, False, False, (55, 85)),
     ("directional", 20, 8, True, False, (55, 85)),
     ("random_azimuth", 16, 8, False, True, (55, 85)),
     ("flux", 16, 0, True, True, (55, 150)),
     ("emission", 20, 8, True, False, (40, 120))],
    ids=["lw-roulette-hg", "lw-no-roulette-table-macro0",
         "directional-table-seam", "random-azimuth-no-roulette",
         "flux-slab-to-top", "lw-table-seam"])
def test_plain_step_matches_jax_interpret_kernel(source, nx, macro_factor,
                                                 use_rr, analytic, slab):
    (jg, jc, jt), (tg, tc, tt) = exact_scenes(nx, 150, *slab)
    kw = dict(macro_factor=macro_factor, n_cdf_steps=201, lambda_um=10.0,
              device_fields="compact")
    jd, td = jbuild(jg, jc, temps=jt, **kw), build_domain(tg, tc, temps=tt,
                                                          **kw)
    lw = source == "emission"
    # the JAX emission source reads the domain's sep_em_atm, which is not a
    # dataclass field: make the sources before dataclasses.replace
    tsrc, jsrc = (make(d) for make, d in zip(SOURCES[source], (td, jd)))
    if not analytic:  # the tabulated row, as an SSP table gives it
        jd = dataclasses.replace(jd, sep_analytic_hg=False)
        td = dataclasses.replace(td, sep_analytic_hg=False)
    key = jrng.batch_key(3, 0)
    fu, fd, ac, az, n, n_bad, _ = jsep.run_batch_pallas_sep(
        jd, JSurface.lambertian(0.05), jsrc, key,
        jpk.PallasConfig(rows=8, block_rows=8, steps_per_call=32,
                         max_steps=4096, interpret=True),
        2, use_russian_roulette=use_rr, lw_mode=lw)
    t = sk.run_batch_sep(td, Surface.lambertian(0.05), tsrc,
                         folded_seed(key),
                         rk.RecordConfig(rows=8, steps_per_call=32,
                                         max_steps=4096), 2,
                         use_russian_roulette=use_rr, lw_mode=lw)
    assert t.n_photons == int(n) == 8 * 128 * 2
    assert t.n_bad == int(n_bad) == 0
    n = t.n_photons
    assert_tally(t.flux_up, fu, EXIT_RTOL, 0.0, n, "flux_up")
    assert_tally(t.flux_down, fd, EXIT_RTOL, 0.0, n, "flux_down")
    assert_tally(t.flux_absorbed, ac, ABS_RTOL, ABS_ATOL * n / (nx * nx), n,
                 "flux_absorbed")
    assert_tally(t.absorption_profile, az, ABS_RTOL, ABS_ATOL * n / 150, n,
                 "absorption_profile")
    if lw:  # every photon was emitted: the pre-credits sum to -n_atm
        assert float(t.flux_absorbed.sum()) < 0


# ---------------------------------------------------------------------------
# Invariants of the port's step
# ---------------------------------------------------------------------------

def test_lw_energy_identity_on_the_plain_step():
    """Thin all-atmosphere LW (tests/test_pallas_sep.py:259-265): every
    emitted photon carries weight 1, ending up out the top, absorbed by
    the surface (1 - albedo of the downward weight) or absorbed in the
    domain, and the net column field is absorbed minus emitted, so
    sum(flux_up) + 0.95 sum(flux_down) == -sum(net absorption) exactly
    without roulette (float32 sums)."""
    grid, comps, temps = lw_flagship_scene(
        nx=16, ny=16, nz=60, cloud_base_level=20, cloud_top_level=35,
        cloud_beta_max=0.3, gas_beta0=0.006, device="cpu")
    dom = build_domain(grid, comps, temps=temps, macro_factor=8,
                       n_cdf_steps=201, lambda_um=10.0,
                       device_fields="compact")
    src = illumination.emission_separable(dom, 288.0, 0.0)
    assert src.atms_fraction == 1.0
    t = sk.run_batch_sep(dom, Surface.lambertian(0.05), src, 71,
                         rk.RecordConfig(rows=8, steps_per_call=32,
                                         max_steps=20_000), 4,
                         use_russian_roulette=False, lw_mode=True)
    n = t.n_photons
    assert n == 8 * 128 * 4 and t.n_bad == 0
    lhs = float(t.flux_up.double().sum() + 0.95 * t.flux_down.double().sum())
    net = -float(t.flux_absorbed.double().sum())
    assert lhs / n == pytest.approx(net / n, abs=1e-5)
    assert float(t.absorption_profile.double().sum()) == pytest.approx(
        -net, rel=1e-5)


def test_n_photons_clamp_and_determinism():
    grid, comps, temps = lw_flagship_scene(nx=16, ny=16, nz=150, device="cpu")
    dom = build_domain(grid, comps, temps=temps, macro_factor=8,
                       n_cdf_steps=201, lambda_um=10.0,
                       device_fields="compact")
    src = illumination.emission_separable(dom, 288.0, 0.95)
    cfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=4096)
    t1, t2 = (sk.run_batch_sep(dom, Surface.lambertian(0.05), src, 9, cfg,
                               2, n_photons=777, lw_mode=True)
              for _ in range(2))
    assert t1.n_photons == 777 and t1.n_bad == 0
    assert torch.equal(t1.flux_absorbed, t2.flux_absorbed)
    assert t1.n_lane_steps == t2.n_lane_steps > 777


def test_wrapper_refuses_other_devices():
    """CPU tensors take the plain step; a CUDA tensor goes to the kernel
    (checked on the card by chip_smoke.py); anything else raises."""
    grid, comps, temps = lw_flagship_scene(nx=16, ny=16, nz=150, device="cpu")
    dom = build_domain(grid, comps, temps=temps, macro_factor=8,
                       n_cdf_steps=201, lambda_um=10.0,
                       device_fields="compact")
    src = illumination.directional(0.5, 0.0)
    prm = sk.SepParams.make(dom, Surface.lambertian(0.0), src, True, 1.0,
                            False)
    st = sk.SepState.initial(
        torch.ones(128, dtype=torch.int32, device="meta"), 1.0)
    with pytest.raises(ValueError, match="meta"):
        sk.sep_launch(st, sk.SepTables.from_domain(dom, src), prm, 0, 0, 1,
                      sk.SepTally.zeros(prm, "cpu"))
