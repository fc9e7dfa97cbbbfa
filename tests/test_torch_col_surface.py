"""PyTorch port: the column kernel's per-pixel Lambertian albedo (K3-c), and
the dispatch of per-pixel surfaces between the record and column kernels.

The plain PyTorch step against the JAX column kernel in Pallas interpret
mode, path for path (same counter uniforms from the same folded seed,
bfloat16-exact column scales). The per-pixel albedo is an albedo per
column, read at the column where the photon reaches the surface; JAX packs
it as a bfloat16 hi/lo pair, which reconstructs an albedo to ~2^-16 of its
value, so reflected weights differ by that much and the tolerances of
tests/test_torch_col_kernel.py hold (exits 4e-3 from JAX's bf16 exit
weights, absorption 1e-4, the 3D field 1e-5). Bright pixels (albedo up to
0.8) keep photons bouncing between the surface and the cloud, and such
long paths can part after a last-bit difference of XLA's and PyTorch's
transcendentals (a uniform albedo of 0.8 parts one photon of 4,096 on the
seed here, as the per-pixel grid does, with JAX's rounded albedos or the
exact ones): the per-column excess over the tolerances may sum to
PARTED_WEIGHT per parted photon, PARTED_SHARE of the photons at most. A
grid of one value everywhere equals the scalar albedo bit for bit,
radiance included (the reflection's local estimate carries the reflected
weight).

Dispatch: JAX's record kernel takes a per-pixel grid up to 4,096 columns
(K1-d, not ported yet); there the port picks the record kernel too, and
raises NotImplementedError naming K1-d instead of running it, never
handing the batch to the column kernel. Past the record kernel both take
the column kernel.
"""

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
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu.transport import pallas_tile as jtile
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import weights
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

EXIT_RTOL, ABS_RTOL, VOL_RTOL = 4e-3, 1e-4, 1e-5
# Parted photons allowed per photon, and the tally weight one can move
# (its surface hits at albedo 0.8 sum to at most 1 / (1 - 0.8)).
PARTED_SHARE = 1e-3
PARTED_WEIGHT = 5.0


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


def both_domains(shape, macro_factor=4, temps=None, **kw):
    """(JAX domain, port domain) of one HG component (ssa 0.99) over the
    broken cloud; ``temps`` with lambda 10 um builds the emission
    tables."""
    nx, ny, nz = shape
    ext = column_field(nx, ny, nz)
    args = (ext, np.full_like(ext, 0.99), np.zeros(ext.shape, np.int32))
    kw = dict(n_cdf_steps=201, macro_factor=macro_factor, **kw)
    if temps is not None:
        kw.update(temps=temps, lambda_um=10.0)
    jd = jbuild(JGrid.regular(nx, ny, nz, 100.0, 100.0, 50.0),
                [JComponent("cloud", *args,
                            JPFT([JPF.henyey_greenstein(0.85, 64)],
                                 key=[1.0]))], **kw)
    td = build_domain(Grid.regular(nx, ny, nz, 100.0, 100.0, 50.0,
                                   device="cpu"),
                      [OpticalComponent("cloud", *args, PhaseFunctionTable(
                          [PhaseFunction.henyey_greenstein(0.85, 64)],
                          key=[1.0]))], **kw)
    return jd, td


def albedo_grid(nxs, nys, seed=4):
    """A varied albedo grid, 0.1 + 0.7 * rand, float32 [nxs, nys, 1]."""
    rs = np.random.RandomState(seed)
    return (0.1 + 0.7 * rs.rand(nxs, nys, 1)).astype(np.float32)


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas_col folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def assert_columns(port, ref, rtol, name, n_photons):
    """Every entry within rtol of JAX's, but for the weight of parted
    photons."""
    port = port.cpu().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    excess = np.maximum(np.abs(port - ref) - rtol * np.abs(ref), 0.0)
    assert excess.sum() <= PARTED_WEIGHT * PARTED_SHARE * n_photons, (
        name, int((excess > 0).sum()), float(excess.sum()))


SMALL = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=20_000,
                        vol_tally=True)


# ---------------------------------------------------------------------------
# The per-pixel albedo
# ---------------------------------------------------------------------------

def test_column_albedo_repeats_each_pixel_over_its_columns():
    """The albedo per column is JAX's _build_alb without its bf16 split:
    pixel (i, j) of an nxs x nys grid covers columns ix // (nx / nxs) == i,
    iy // (ny / nys) == j, in column order ix * ny + iy."""
    p = albedo_grid(3, 2)
    alb = ck.column_albedo(Surface(params=p), 12, 8, "cpu").numpy()
    ix, iy = np.meshgrid(np.arange(12), np.arange(8), indexing="ij")
    want = p[ix // 4, iy // 4, 0].reshape(-1)
    np.testing.assert_array_equal(alb, want)


@pytest.mark.parametrize("radiance", [False, True])
def test_uniform_grid_equals_the_scalar_albedo_bit_for_bit(radiance):
    """A 2 x 2 grid of one value takes the per-pixel path (its own launch
    argument) and reproduces the scalar albedo's tallies bit for bit, the
    radiance image included (JAX's test_uniform_grid_bitwise_equals_scalar,
    there for the fluxes of a bf16-exact value; here the albedo is exact
    float32)."""
    td = both_domains((16, 16, 8), compute_intensity_tables=radiance,
                      hybrid_width_deg=10.0 if radiance else 0.0)[1]
    src = illumination.directional(0.5, 30.0)
    kw = {}
    if radiance:
        kw = dict(intensity_config=le.IntensityConfig(
            n_dirs=3, pallas_min_mu=0.4),
            intensity_dirs=le.make_intensity_directions(
                [1.0, 0.6, 0.6], [0.0, 135.0, 270.0], device="cpu"))
    grid_sfc = Surface(params=np.full((2, 2, 1), 0.3, np.float32))
    t_px, t_u = (ck.run_batch_col(td, sfc, src, 7, SMALL, 1, **kw)
                 for sfc in (grid_sfc, Surface.lambertian(0.3)))
    assert t_px.n_photons == t_u.n_photons == 8 * 128
    assert t_px.n_lane_steps == t_u.n_lane_steps
    for name in ("flux_up", "flux_down", "flux_absorbed",
                 "absorption_profile", "volume_absorption", "intensity"):
        a, b = getattr(t_px, name), getattr(t_u, name)
        assert (a is None) == (b is None) == (name == "intensity"
                                              and not radiance)
        if a is not None:
            assert torch.equal(a, b), name
    if radiance:
        assert t_px.n_le_events == t_u.n_le_events > 0


@pytest.fixture(scope="module")
def varied_grid_runs():
    """One batch over a 4 x 4 grid of albedos 0.1 to 0.8 on 24 x 16 x 8
    columns (nx != ny; 6 x 4 columns per pixel) with the 3D tally and the
    local estimate toward 3 directions (hybrid row, roulette), in the JAX
    kernel (interpret mode) and the port's plain step: (JAX tallies, port
    tallies). The estimate moves no photon, so both tests below read one
    pair of runs."""
    jd, td = both_domains((24, 16, 8), compute_intensity_tables=True,
                          hybrid_width_deg=10.0)
    p = albedo_grid(4, 4)
    mus, phis = [1.0, 0.6, 0.6], [0.0, 135.0, 270.0]
    kw = dict(n_lanes=1024, photons_per_lane=4, max_steps=20_000,
              need_volume_absorption=True)
    key = jrng.batch_key(9, 2)
    tj = jpc.run_batch_pallas_col_tallies(
        jd, JSurface(params=p), jill.directional(0.5, 30.0), key,
        jintegrator.KernelConfig(**kw), interpret=True,
        intensity_config=JIcfg(n_dirs=3, pallas_min_mu=0.4),
        intensity_dirs=jdirections(mus, phis))
    t = ck.run_batch_col_tallies(
        td, Surface(params=p), illumination.directional(0.5, 30.0),
        folded_seed(key), KernelConfig(**kw),
        intensity_config=le.IntensityConfig(n_dirs=3, pallas_min_mu=0.4),
        intensity_dirs=le.make_intensity_directions(mus, phis,
                                                    device="cpu"))
    return tj, t


def test_varied_grid_matches_jax_interpret_kernel(varied_grid_runs):
    """Over the varied grid (varied_grid_runs): photon for photon as JAX's
    kernel, the fluxes, the column absorption, the profile and the 3D
    field."""
    tj, t = varied_grid_runs
    assert t.n_photons == int(tj.n_photons) == 8 * 128 * 4
    assert t.n_bad == int(tj.n_bad) == 0
    assert t.n_steps == int(tj.n_steps)
    n = t.n_photons
    assert_columns(t.flux_up, tj.flux_up, EXIT_RTOL, "flux_up", n)
    assert_columns(t.flux_down, tj.flux_down, EXIT_RTOL, "flux_down", n)
    assert_columns(t.flux_absorbed, tj.flux_absorbed, ABS_RTOL,
                   "flux_absorbed", n)
    assert_columns(t.absorption_profile, tj.absorption_profile, ABS_RTOL,
                   "absorption_profile", n)
    assert_columns(t.volume_absorption, tj.volume_absorption, VOL_RTOL,
                   "volume_absorption", n)


def test_radiance_over_a_varied_grid_matches_jax_interpret_kernel(
        varied_grid_runs):
    """The local estimate over the varied grid (varied_grid_runs): the
    surface term carries the landing pixel's albedo in the reflected
    weight; per-direction domain means within 1e-4 and every pixel within
    1e-3 of its direction's largest (tests/test_torch_col_radiance.py's
    limits) of JAX's kernel."""
    tj, t = varied_grid_runs
    assert t.n_photons == int(tj.n_photons) and t.n_bad == 0
    img = t.intensity.double().numpy()
    ref = np.asarray(tj.intensity, np.float64)
    for d in range(3):
        assert abs(img[..., d].sum() / ref[..., d].sum() - 1) < 1e-4, d
        gap = np.abs(img[..., d] - ref[..., d]).max()
        assert gap < 1e-3 * np.abs(ref[..., d]).max(), d


# ---------------------------------------------------------------------------
# Dispatch: the record kernel's per-pixel surfaces stay JAX's K1 (K1-d)
# ---------------------------------------------------------------------------

class _Picked(Exception):
    pass


def _picker(name):
    def pick(*args, **kwargs):
        raise _Picked(name)
    return pick


DISPATCH_CASES = [
    # (shape, surface grid or None, source, radiance): JAX's choice
    ("k1_per_pixel", (24, 16, 8), (4, 4), "directional", False, "record"),
    ("k1_per_pixel_radiance", (24, 16, 8), (4, 4), "directional", True,
     "record"),
    ("k1_per_pixel_emission", (24, 16, 8), (4, 4), "emission", False,
     "record"),
    ("k1_per_pixel_past_tile_threshold", (24, 24, 40), (4, 4),
     "directional", False, "record"),
    ("per_pixel_past_k1_columns", (72, 64, 4), (8, 8), "directional", False,
     "column"),
    ("per_pixel_past_k1_cells", (64, 32, 32), (16, 16), "directional",
     False, "column"),
    ("per_pixel_radiance_past_k1_cells", (64, 32, 32), (16, 16),
     "directional", True, "column"),
    ("emission_past_tile_threshold", (24, 24, 40), None, "emission", False,
     "record"),
    ("emission_past_k1_cells", (64, 32, 32), None, "emission", False,
     "column"),
]


@pytest.mark.parametrize("case,shape,grid,source,radiance,want",
                         DISPATCH_CASES)
def test_dispatch_follows_jax_and_refuses_k1d(monkeypatch, case, shape,
                                              grid, source, radiance, want):
    """Where the JAX package takes its record kernel for a per-pixel
    surface (the grid within 4,096 columns, 36,864 cells, flux or
    radiance, not lw_mode) the port raises NotImplementedError naming
    K1-d and runs no kernel; past the record kernel both take the column
    kernel. An emission source between K5's 16,384-cell threshold and K1's
    envelope stays on the record kernel (K1-c) in both (lw_mode, 3D
    tally)."""
    nx, ny, nz = shape
    temps = None
    lw = source == "emission"
    if lw:
        tz = 288.0 - 6.5 * (np.arange(nz) + 0.5) * 0.05
        temps = np.broadcast_to(tz, shape).copy()
    jd, td = both_domains(shape, 8, temps=temps,
                          compute_intensity_tables=radiance,
                          hybrid_width_deg=10.0 if radiance else 0.0)
    if lw:
        kabs = np.asarray(jd.total_ext) * 0.01
        jw = jweights.emission_weighting(jd.grid, temps, kabs, 288.0, 0.95,
                                         10.0)
        tw = weights.emission_weighting(td.grid, temps, kabs, 288.0, 0.95,
                                        10.0)
        jsrc = jill.emission(jw.voxel_cdf, jw.frac_atms_power, shape)
        tsrc = illumination.emission(tw.voxel_cdf, tw.frac_atms_power, shape,
                                     device="cpu")
        lw = grid is None  # a per-pixel surface is refused in lw_mode
    else:
        jsrc = jill.directional(0.5, 0.0)
        tsrc = illumination.directional(0.5, 0.0)
    if grid is None:
        jsfc, tsfc = JSurface.lambertian(0.05), Surface.lambertian(0.05)
    else:
        p = albedo_grid(*grid)
        jsfc, tsfc = JSurface(params=p), Surface(params=p)
    for mod, fn, name in ((jpk, "run_batch_pallas_tallies", "record"),
                          (jpc, "run_batch_pallas_col_tallies", "column"),
                          (jsep, "run_batch_pallas_sep_tallies", "separable"),
                          (jtile, "run_batch_pallas_tile_tallies", "tiled"),
                          (rk, "run_batch_record_tallies", "record"),
                          (ck, "run_batch_col_tallies", "column")):
        monkeypatch.setattr(mod, fn, _picker(name))
    kw = dict(n_lanes=1024, photons_per_lane=1, lw_mode=lw,
              need_volume_absorption=not radiance)
    jkw, tkw = {}, {}
    if radiance:
        mus, phis = [1.0, 0.6], [0.0, 135.0]
        jkw = dict(intensity_config=JIcfg(n_dirs=2, pallas_min_mu=0.4),
                   intensity_dirs=jdirections(mus, phis))
        tkw = dict(intensity_config=le.IntensityConfig(n_dirs=2,
                                                       pallas_min_mu=0.4),
                   intensity_dirs=le.make_intensity_directions(
                       mus, phis, device="cpu"))
    with pytest.raises(_Picked) as jax_pick:
        jintegrator.run_batch(jd, jsfc, jsrc, jrng.batch_key(0, 0),
                              jintegrator.KernelConfig(use_pallas="on", **kw),
                              **jkw)
    assert str(jax_pick.value) == want
    port = KernelConfig(**kw)
    if want == "record" and grid is not None:
        with pytest.raises(NotImplementedError, match="K1-d"):
            run_batch(td, tsfc, tsrc, 0, port, **tkw)
    else:
        with pytest.raises(_Picked) as port_pick:
            run_batch(td, tsfc, tsrc, 0, port, **tkw)
        assert str(port_pick.value) == want
