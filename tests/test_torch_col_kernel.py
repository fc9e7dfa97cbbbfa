"""PyTorch port: the column-template kernel (K3).

The plain PyTorch step (what ``col_launch`` runs on the CPU) against the JAX
column kernel in Pallas interpret mode and the column-template detection
against the JAX ``build_domain`` (the dispatch order and the Landsat-scale
decks through the command line are in ``test_torch_col_dispatch.py``). The
CUDA kernel is held against the plain step on the card by chip_smoke.py.

Parity tolerances, per column. Both packages draw the same counter uniforms
from the same folded seed, and the test scenes' column scales are
bfloat16-exact, so the JAX kernel's bf16 hi/lo gather of col_scale is exact
and the photon paths coincide up to float rounding: XLA's and PyTorch's
float32 cos, sin, log1p and sqrt differ in the last bit for a few percent
of arguments, and near the forward peak sin(theta) = sqrt(1 - cos^2)
turns one ulp of cos into ~1e-3 of the new direction. A photon that
scatters hundreds of times can so drift until a decision flips: at the
deck's optical depths (up to 64) a few photons of 4,096 take another path
on most seeds. The scenes here keep paths short enough (optical depths up
to 6.4 at the deck's width) that no decision flips on the seeds used, and
what remains is the JAX kernel's tally rounding:

* exit fluxes: each exit weight is tallied as a bfloat16, at most 2^-9
  relative, so a column sum differs by at most 2^-9 relative -> 4e-3;
* column absorption and the z profile: tallied as a bf16 hi/lo pair, about
  2^-16 relative per weight -> 1e-4;
* the 3D field: exact float32 in both, summed in another order -> 1e-5.
"""

import dataclasses
import os

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
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
EXIT_RTOL, ABS_RTOL, VOL_RTOL = 4e-3, 1e-4, 1e-5

SOURCES = {
    "directional": (lambda: illumination.directional(0.5, 0.0),
                    lambda: jill.directional(0.5, 0.0)),
    "random_azimuth": (lambda: illumination.random_azimuth(0.5),
                       lambda: jill.random_azimuth(0.5)),
    "flux": (illumination.flux, jill.flux),
}


def column_field(nx, ny, nz, seed=0, bf16_exact=True, max_scale=0.05):
    """Broken-cloud extinction [nx, ny, nz] (the Landsat shape of
    tests/test_pallas_col.py), with bfloat16-exact column scales unless
    ``bf16_exact`` is False."""
    rs = np.random.RandomState(seed)
    f = rs.rand(nx, ny)
    for _ in range(3):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    scale = rs.rand(nx, ny) * max_scale * (f > np.quantile(f, 0.55))
    if bf16_exact:
        scale = torch.tensor(scale, dtype=torch.float32).to(
            torch.bfloat16).double().numpy()
    h = np.ceil(f * nz).astype(int) * (scale > 0)
    return np.where(np.arange(nz)[None, None, :] < h[:, :, None],
                    scale[:, :, None], 0.0)


def both_domains(ext, macro_factor, analytic=True, n_cdf_steps=201,
                 dx=100.0, dz=50.0):
    """(JAX domain, port domain) of one HG component over ``ext``; with
    ``analytic`` False both sample the tabulated inverse CDF, as a domain
    read from a file does."""
    nx, ny, nz = ext.shape
    args = (ext, np.full_like(ext, 0.99), np.zeros(ext.shape, np.int32))
    jd = jbuild(JGrid.regular(nx, ny, nz, dx, dx, dz),
                [JComponent("cloud", *args,
                            JPFT([JPF.henyey_greenstein(0.85, 64)],
                                 key=[1.0]))],
                n_cdf_steps=n_cdf_steps, macro_factor=macro_factor)
    td = build_domain(Grid.regular(nx, ny, nz, dx, dx, dz, device="cpu"),
                      [OpticalComponent(
                          "cloud", *args, PhaseFunctionTable(
                              [PhaseFunction.henyey_greenstein(0.85, 64)],
                              key=[1.0]))],
                      n_cdf_steps=n_cdf_steps, macro_factor=macro_factor)
    if not analytic:
        jd = dataclasses.replace(jd, all_hg=False)
        td = dataclasses.replace(td, all_hg=False)
    return jd, td


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas_col folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def assert_columns(port, ref, rtol, name):
    port = port.cpu().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    gap = np.abs(port - ref)
    bad = gap > rtol * np.abs(ref)
    assert not bad.any(), (name, int(bad.sum()), float(gap.max()))


# ---------------------------------------------------------------------------
# Detection and the block table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,macro_factor,bf16_exact", [
    ((16, 16, 8), 4, True),
    ((18, 20, 8), 4, False),    # partial last blocks; bf16 round-up bumps
    ((16, 12, 6), 0, False),
    ((36, 20, 12), 8, False),
])
def test_detection_and_block_table_match_jax(shape, macro_factor,
                                             bf16_exact):
    ext = column_field(*shape, seed=3, bf16_exact=bf16_exact)
    jd, td = both_domains(ext, macro_factor)
    assert jd.col_template and td.col_template
    np.testing.assert_array_equal(td.col_scale.numpy(),
                                  np.asarray(jd.col_scale))
    np.testing.assert_array_equal(td.col_height.numpy(),
                                  np.asarray(jd.col_height))
    if macro_factor:
        table = td.macro_table.numpy()
        np.testing.assert_array_equal(table, np.asarray(jd.macro_table))
        nx, ny, _ = shape
        f = macro_factor
        assert table.shape == (-(-nx // f) * -(-ny // f), 2)
        # the stored majorant bounds every column scale of its block
        s = td.col_scale.numpy().reshape(nx, ny)
        bx = np.arange(nx)[:, None] // f * -(-ny // f) + np.arange(ny) // f
        assert np.all(table[bx, 0] >= s)
    else:
        assert td.macro_table is None and jd.macro_table is None


def test_non_template_is_not_detected():
    ext = np.zeros((4, 4, 6))
    ext[:, :, 2:4] = 0.01      # elevated layer, clear below
    jd, td = both_domains(ext, 2)
    assert not td.col_template and not jd.col_template
    assert td.col_scale is None and td.macro_table is None


# ---------------------------------------------------------------------------
# The plain step against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

def run_both(jd, td, source, macro_rr_vol, seed=0, rows=8, ppl=2):
    use_rr, need_vol = macro_rr_vol
    tsrc, jsrc = SOURCES[source]
    key = jrng.batch_key(seed, 0)
    jout = jpc.run_batch_pallas_col(
        jd, JSurface.lambertian(0.2), jsrc(), key,
        jpk.PallasConfig(rows=rows, block_rows=8, steps_per_call=32,
                         max_steps=4096, interpret=True),
        ppl, use_russian_roulette=use_rr, need_vol=need_vol)
    t = ck.run_batch_col(
        td, Surface.lambertian(0.2), tsrc(), folded_seed(key),
        rk.RecordConfig(rows=rows, steps_per_call=32, max_steps=4096,
                        vol_tally=need_vol), ppl,
        use_russian_roulette=use_rr)
    return jout, t


def assert_parity(jout, t, need_vol):
    fu, fd, ac, az, vol, n, n_bad, _ = jout
    assert t.n_photons == int(n) and t.n_bad == int(n_bad) == 0
    assert_columns(t.flux_up, fu, EXIT_RTOL, "flux_up")
    assert_columns(t.flux_down, fd, EXIT_RTOL, "flux_down")
    assert_columns(t.flux_absorbed, ac, ABS_RTOL, "flux_absorbed")
    assert_columns(t.absorption_profile, az, ABS_RTOL, "absorption_profile")
    if need_vol:
        assert_columns(t.volume_absorption, vol, VOL_RTOL,
                       "volume_absorption")
    else:
        assert t.volume_absorption is None and vol is None


@pytest.mark.parametrize("macro_factor,analytic,use_rr,source,need_vol", [
    (0, True, True, "directional", False),
    (0, False, True, "directional", False),
    (4, True, False, "directional", True),
    (4, True, True, "random_azimuth", False),
    (4, False, False, "flux", True),
])
def test_plain_step_matches_jax_interpret_kernel(macro_factor, analytic,
                                                 use_rr, source, need_vol):
    jd, td = both_domains(column_field(16, 16, 8), macro_factor, analytic)
    jout, t = run_both(jd, td, source, (use_rr, need_vol))
    assert t.n_photons == 8 * 128 * 2
    assert_parity(jout, t, need_vol)


def test_plain_step_matches_jax_at_the_deck_width():
    """128 x 128 x 64 columns (the Landsat deck's grid, 30 m x 20 m cells)
    with the deck's configuration: macro factor 8, the tabulated phase row,
    roulette, a directional beam; the scales are a tenth of the deck's
    (see the module docstring)."""
    jd, td = both_domains(column_field(128, 128, 64, max_scale=0.005), 8,
                          analytic=False, dx=30.0, dz=20.0)
    jout, t = run_both(jd, td, "directional", (True, False), ppl=4)
    assert t.n_photons == 8 * 128 * 4
    assert_parity(jout, t, False)


# ---------------------------------------------------------------------------
# Invariants of the port's step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def col_domain():
    return both_domains(column_field(16, 16, 8), 4)[1]


SMALL = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=4096)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_energy_balance_without_roulette(col_domain, source):
    """Every started weight is accounted for: with surface albedo rho,
    R + (1 - rho) T + A == 1 to float32 rounding; the profile and the 3D
    field sum to the column absorption."""
    rho = 0.2
    t = ck.run_batch_col(col_domain, Surface.lambertian(rho),
                         SOURCES[source][0](), 11, SMALL, 2,
                         use_russian_roulette=False)
    n = t.n_photons
    assert n == 8 * 128 * 2 and t.n_bad == 0
    balance = float(t.flux_up.sum() + (1 - rho) * t.flux_down.sum()
                    + t.flux_absorbed.sum()) / n
    assert abs(balance - 1.0) < 2e-4
    total = float(t.flux_absorbed.sum())
    assert float(t.absorption_profile.sum()) == pytest.approx(total,
                                                              rel=1e-5)
    assert float(t.volume_absorption.sum()) == pytest.approx(total,
                                                             rel=1e-5)
    torch.testing.assert_close(t.volume_absorption.sum(dim=2),
                               t.flux_absorbed, rtol=1e-5, atol=1e-5)


def test_n_photons_clamp_and_determinism(col_domain):
    sfc = Surface.lambertian(0.0)
    src = illumination.directional(0.5, 0.0)
    t1 = ck.run_batch_col(col_domain, sfc, src, 7, SMALL, 2, n_photons=777)
    t2 = ck.run_batch_col(col_domain, sfc, src, 7, SMALL, 2, n_photons=777)
    assert t1.n_photons == 777 and t1.n_bad == 0
    assert torch.equal(t1.flux_up, t2.flux_up)
    assert torch.equal(t1.absorption_profile, t2.absorption_profile)
    assert t1.n_lane_steps == t2.n_lane_steps > 777


def test_wrapper_refuses_other_devices(col_domain):
    """CPU tensors take the plain step; a CUDA tensor goes to the kernel
    (checked on the card by chip_smoke.py); anything else raises."""
    prm = ck.ColParams.make(col_domain, Surface.lambertian(0.0),
                            illumination.directional(0.5, 0.0), True, 1.0,
                            False)
    st = ck.ColState.initial(
        torch.ones(128, dtype=torch.int32, device="meta"), 1.0, 8)
    with pytest.raises(ValueError, match="meta"):
        ck.col_launch(st, ck.ColTables.from_domain(col_domain), prm, 0, 0, 1,
                      ck.ColTally.zeros(prm, "cpu"))


# ---------------------------------------------------------------------------
# What is not ported
# ---------------------------------------------------------------------------

def test_unported_parts_are_named(col_domain):
    """What K3 refuses raises NotImplementedError naming its predicate, all
    of them JAX's own: every part of K3 is ported (the gas template, the
    radiance, the column emission and the per-pixel albedo are named no
    more), so a per-pixel surface is refused only with an emission source,
    an emission source only without its tables."""
    sfc, src = Surface.lambertian(0.2), illumination.directional(0.5, 0.0)
    px = Surface(params=np.full((2, 2, 1), 0.2, np.float32))
    reasons = ck.col_ineligibility_reasons(
        col_domain, px, illumination.Source(kind=illumination.EMISSION),
        lw_mode=True, compute_intensity=True, record_scattering_orders=0,
        use_ray_tracing=False, need_volume_absorption=False)
    text = "; ".join(reasons)
    assert len(reasons) == 3, reasons
    for part in ("per-pixel Lambertian grid", "without its per-voxel alias",
                 "compute_intensity"):
        assert part in text, part
    assert "not ported" not in text and "lw_mode without" not in text
    assert "gas template" not in text and "slab-scan" not in text
    assert ck.col_ineligibility_reasons(col_domain, px, src, False, False, 0,
                                        False, False) == []
    # two components without the gas template's fields
    two = dataclasses.replace(col_domain, cum_ext=torch.zeros(16, 16, 8, 2))
    assert any("without the gas template" in r
               for r in ck.col_ineligibility_reasons(
                   two, sfc, src, False, False, 0, False, False))
    with pytest.raises(NotImplementedError, match="without the gas template"):
        ck.run_batch_col(two, sfc, src, 0, SMALL, 1)
    # radiance on a column-template domain outside the record kernel runs
    # on the column kernel's local estimate
    big = both_domains(column_field(64, 32, 32), 8, n_cdf_steps=101)[1]
    dirs = le.make_intensity_directions([1.0], [0.0], device="cpu")
    t = run_batch(big, sfc, src, 0, KernelConfig(n_lanes=128,
                                                 photons_per_lane=1,
                                                 need_volume_absorption=False),
                  intensity_config=le.IntensityConfig(
                      n_dirs=1, use_russian_roulette=False,
                      use_hybrid_phase=False),
                  intensity_dirs=dirs)
    assert t.intensity.shape == (64, 32, 1) and t.n_le_events > 0
