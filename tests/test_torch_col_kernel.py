"""PyTorch port: the column-template kernel (K3).

The plain PyTorch step (what ``col_launch`` runs on the CPU) against the JAX
column kernel in Pallas interpret mode, the column-template detection
against the JAX ``build_domain``, the dispatch order against the JAX
package's own choice, and the Landsat-scale flux and radiance decks through
the port's command line. The CUDA kernel is held against the plain step on the card by
chip_smoke.py.

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
import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.core.grid import Grid as JGrid
from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.domain.domain import OpticalComponent as JComponent
from mcbrat3d_tpu.domain.domain import build_domain as jbuild
from mcbrat3d_tpu.driver import output as joutput
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.driver.run import Results as JResults
from mcbrat3d_tpu.physics.phase_function import PhaseFunction as JPF
from mcbrat3d_tpu.physics.phase_function import PhaseFunctionTable as JPFT
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.tools import scene_cli as jscene_cli
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu.transport import pallas_tile as jtile
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene
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
# Dispatch and what is not ported
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The domain file and the Landsat deck through the command line
# ---------------------------------------------------------------------------

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
