"""PyTorch port: the column kernel's gas template (K3-a) and its local
estimate of top-of-domain radiances (K3-d).

The plain PyTorch step (what ``col_launch`` runs on the CPU) against the JAX
column kernel in Pallas interpret mode, path for path: both draw the same
counter uniforms from the same folded seed, both march the directions in
the same sorted order (so direction d draws its Iwabuchi roulette at the
same sites), and the column scales are bfloat16-exact, so the photon paths
coincide up to float rounding (tests/test_torch_col_kernel.py explains the
flux tolerances, reused here). The radiance images differ by:

* the walk: the JAX kernel sums the column segments by fast-axis slab, the
  port walks them in order of distance -- the same segments in another
  rounding order (~1e-6 of tau);
* the tally: the JAX kernel adds each contribution as a bf16 hi/lo pair
  (~2^-17 relative), the port in float32.

The walk finds its first column by the JAX kernel's rule (the cell entered
at a face on the fast axis, a 1e-4-cell nudge along the direction on the
slow one), so both attribute every segment to the same column. On the
three radiance cases here (the gas case with a direction at the floor mu
0.4, whose walks are the longest) the per-direction domain means agreed
to 2.6e-6 relative and every pixel to 1.3e-4 of its direction's largest
pixel.
RAD_GAP and RAD_PIXEL_GAP leave room for an Iwabuchi decision parted by a
1-ulp difference of tau (one pixel moves by one w * zeta / pi), while a
contribution tallied in a wrong column, a wrong phase value or a wrong
roulette site moves a direction's mean by whole percents. No photon path
parted on these seeds.

Also: the gas-template detection against the JAX ``build_domain``, the
direction order against ``plan_col_march``, a column walk across the
periodic seam against a float64 integral, the gas template's majorant at
the seam (the dispatch, each refusal by name and
``IntensityConfig.pallas_min_mu`` are in
``test_torch_col_radiance_dispatch.py``).
"""

import dataclasses

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
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

torch.set_num_threads(1)

EXIT_RTOL, ABS_RTOL, VOL_RTOL = 4e-3, 1e-4, 1e-5
RAD_GAP = 1e-4
RAD_PIXEL_GAP = 1e-3

# bench.py:555-559's 16 directions, and two sets of 8 with one direction in
# every octant of azimuth and both fast axes; MUS8_FLOOR puts one at the
# floor mu 0.4 (the longest walks)
MUS16 = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4] * 2
PHIS16 = [(i * 45.0 + 15.0) % 360.0 for i in range(16)]
MUS8 = [1.0, 0.8, 0.6, 0.45, 0.8, 0.6, 0.45, 0.7]
MUS8_FLOOR = [1.0, 0.8, 0.6, 0.4, 0.8, 0.6, 0.45, 0.7]
PHIS8_A = [20.0, 70.0, 110.0, 160.0, 200.0, 250.0, 290.0, 340.0]
PHIS8_B = [10.0, 80.0, 100.0, 170.0, 190.0, 260.0, 280.0, 350.0]


def column_field(nx, ny, nz, seed=3, max_scale=0.05):
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


def gas_profile(nz, dz, beta0=2e-3):
    """A horizontally uniform pure absorber, q = beta0 exp(-z_c / 2000)."""
    return beta0 * np.exp(-(np.arange(nz) + 0.5) * dz / 2000.0)


def components(pkg, ext, gas=None, gas_first=False, cloud_entry=0,
               tabulated=False):
    """The cloud (+ gas) components for the JAX package (``pkg`` = "jax")
    or the port: HG 0.85 (a Legendre-moment phase function when
    ``tabulated``), entry ``cloud_entry`` of a two-entry table."""
    comp, pf, pft = ((JComponent, JPF, JPFT) if pkg == "jax" else
                     (OpticalComponent, PhaseFunction, PhaseFunctionTable))
    entries = [pf.henyey_greenstein(0.7, 64), pf.henyey_greenstein(0.85, 64)]
    if tabulated:
        entries[1] = pf(coefficients=entries[1].coefficients)
    table = pft(entries[:cloud_entry + 1], key=list(range(cloud_entry + 1)))
    cloud = comp("cloud", ext, np.full_like(ext, 0.99),
                 np.full(ext.shape, cloud_entry, np.int32), table)
    if gas is None:
        return [cloud]
    q = np.asarray(gas, np.float64).reshape(1, 1, -1)
    absorber = comp("gas", q, np.zeros_like(q), np.zeros(q.shape, np.int32),
                    pft([pf.isotropic()], key=[1.0]))
    return [absorber, cloud] if gas_first else [cloud, absorber]


def both_domains(ext, gas=None, dx=100.0, dz=50.0, macro_factor=4,
                 tables=False, hybrid=10.0, **comp_kw):
    """(JAX domain, port domain) of the same components."""
    nx, ny, nz = ext.shape
    kw = dict(n_cdf_steps=201, macro_factor=macro_factor,
              compute_intensity_tables=tables,
              hybrid_width_deg=hybrid if tables else 0.0)
    jd = jbuild(JGrid.regular(nx, ny, nz, dx, dx, dz),
                components("jax", ext, gas, **comp_kw), **kw)
    td = build_domain(Grid.regular(nx, ny, nz, dx, dx, dz, device="cpu"),
                      components("port", ext, gas, **comp_kw), **kw)
    return jd, td


def folded_seed(key) -> int:
    """The uint32 seed the JAX column kernel folds from a JAX key."""
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
# Gas-template detection
# ---------------------------------------------------------------------------

DETECTION_CASES = {
    # cloud then gas, analytic HG
    "cloud_gas": dict(shape=(16, 16, 8), comp=dict()),
    # gas first, the cloud on entry 1 of its table, tabulated phase
    "gas_cloud_tabulated": dict(shape=(18, 12, 10),
                                comp=dict(gas_first=True, cloud_entry=1,
                                          tabulated=True)),
    # a slab of one height over gas: the separable kernel's in both
    "uniform_height_slab": dict(shape=(8, 8, 8), comp=dict(), slab=True),
}


@pytest.mark.parametrize("case", sorted(DETECTION_CASES))
def test_gas_template_detection_matches_jax(case):
    c = DETECTION_CASES[case]
    nx, ny, nz = c["shape"]
    if c.get("slab"):
        amp = (np.random.RandomState(3).rand(nx, ny) > 0.5) * 0.02
        ext = np.zeros((nx, ny, nz))
        ext[:, :, :4] = amp[:, :, None]
    else:
        ext = column_field(nx, ny, nz)
    jd, td = both_domains(ext, gas_profile(nz, 50.0), **c["comp"])
    assert td.col_template == jd.col_template == (not c.get("slab"))
    assert td.sep_template == jd.sep_template == bool(c.get("slab"))
    if not jd.col_template:
        assert td.col_qz is None and td.col_cloud is None
        return
    for name in ("col_scale", "col_height", "macro_table", "col_qz",
                 "col_cloud"):
        np.testing.assert_array_equal(np.asarray(getattr(td, name).cpu()
                                                 if torch.is_tensor(
                                                     getattr(td, name))
                                                 else getattr(td, name)),
                                      np.asarray(getattr(jd, name)), name)
    assert td.col_analytic_hg == jd.col_analytic_hg == (
        not c["comp"].get("tabulated", False))
    assert td.col_inv_row == jd.col_inv_row
    assert not ck.col_ineligibility_reasons(
        td, Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
        False, False, 0, False, True)


# ---------------------------------------------------------------------------
# The plain step against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gas_flux():
    """One JAX interpret-mode K3 flux run on the gas template (tabulated
    cloud phase, the 3D field) and the port's plain step, same key."""
    nz = 8
    jd, td = both_domains(column_field(16, 16, nz), gas_profile(nz, 50.0))
    jd = dataclasses.replace(jd, all_hg=False, col_analytic_hg=False)
    td = dataclasses.replace(td, all_hg=False, col_analytic_hg=False)
    key = jrng.batch_key(11, 0)
    jout = jpc.run_batch_pallas_col(
        jd, JSurface.lambertian(0.2), jill.directional(0.5, 0.0), key,
        jpk.PallasConfig(rows=8, block_rows=8, steps_per_call=32,
                         max_steps=4096, interpret=True), 2, need_vol=True)
    t = ck.run_batch_col(
        td, Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
        folded_seed(key), rk.RecordConfig(rows=8, steps_per_call=32,
                                          max_steps=4096), 2)
    return jout, t


def assert_flux_parity(t, fu, fd, ac, az, n, n_bad):
    assert t.n_photons == int(n) and t.n_bad == int(n_bad) == 0
    assert_columns(t.flux_up, fu, EXIT_RTOL, "flux_up")
    assert_columns(t.flux_down, fd, EXIT_RTOL, "flux_down")
    assert_columns(t.flux_absorbed, ac, ABS_RTOL, "flux_absorbed")
    assert_columns(t.absorption_profile, az, ABS_RTOL, "absorption_profile")


def test_gas_step_matches_jax_interpret_kernel(gas_flux):
    """The gas template's ceiling, collision extinction, effective ssa and
    the cloud's inverse row, path for path: fluxes, column absorption, the
    profile and the 3D field."""
    (fu, fd, ac, az, vol, n, n_bad, _), t = gas_flux
    assert_flux_parity(t, fu, fd, ac, az, n, n_bad)
    assert_columns(t.volume_absorption, vol, VOL_RTOL, "volume")


# case -> (gas, tables, tabulated scattering, hybrid, roulette, mus,
# azimuths)
RADIANCE_CASES = {
    "forward_row_roulette": (False, True, False, True, True, MUS8, PHIS8_A),
    "gas_hg_roulette": (True, False, False, True, True, MUS8_FLOOR,
                        PHIS8_B),
    "original_row_exact": (False, True, True, False, False, MUS8, PHIS8_A),
}


@pytest.fixture(scope="module", params=sorted(RADIANCE_CASES))
def radiance(request):
    """One JAX interpret-mode K3 radiance run and the port's plain step on
    the same 16 x 16 x 8 scene and key, 8 directions."""
    gas, tables, tabulated, hybrid, roulette, mus, phis = RADIANCE_CASES[
        request.param]
    nz = 8
    jd, td = both_domains(column_field(16, 16, nz),
                          gas_profile(nz, 50.0) if gas else None,
                          tables=tables)
    if tabulated:
        jd = dataclasses.replace(jd, all_hg=False, col_analytic_hg=False)
        td = dataclasses.replace(td, all_hg=False, col_analytic_hg=False)
    key = jrng.batch_key(11, 0)
    jicfg = JIcfg(n_dirs=8, use_russian_roulette=roulette,
                  use_hybrid_phase=hybrid, pallas_min_mu=0.4)
    icfg = le.IntensityConfig(n_dirs=8, use_russian_roulette=roulette,
                              use_hybrid_phase=hybrid, pallas_min_mu=0.4)
    jt = jpc.run_batch_pallas_col_tallies(
        jd, JSurface.lambertian(0.2), jill.directional(0.5, 30.0), key,
        jintegrator.KernelConfig(n_lanes=1024, photons_per_lane=1,
                                 max_steps=20_000),
        interpret=True, intensity_config=jicfg,
        intensity_dirs=jdirections(mus, phis))
    t = ck.run_batch_col_tallies(
        td, Surface.lambertian(0.2), illumination.directional(0.5, 30.0),
        folded_seed(key),
        KernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=20_000,
                     need_volume_absorption=False),
        intensity_config=icfg,
        intensity_dirs=le.make_intensity_directions(mus, phis,
                                                    device="cpu"))
    return request.param, jt, t, (jd, td, jicfg, mus, phis)


def test_local_estimate_matches_jax_interpret_kernel(radiance):
    """The fluxes path for path, and the image [nx, ny, 8] in the caller's
    order: per-direction domain means within RAD_GAP, every pixel within
    RAD_PIXEL_GAP of its direction's largest pixel, and the march order
    equal to plan_col_march's."""
    case, jt, t, (jd, td, jicfg, mus, phis) = radiance
    assert_flux_parity(t, jt.flux_up, jt.flux_down, jt.flux_absorbed,
                       jt.absorption_profile, jt.n_photons, jt.n_bad)
    assert t.n_cut == 0 and t.n_le_events > 0 and t.n_walk > 0
    assert ck.col_dir_order(td, le.make_intensity_directions(
        mus, phis, device="cpu")) == jpc.plan_col_march(
            jd.grid, jd, jicfg, jdirections(mus, phis))[3]
    ref = np.asarray(jt.intensity, np.float64)
    img = t.intensity.numpy().astype(np.float64)
    assert img.shape == ref.shape == (16, 16, 8)
    means, ref_means = img.sum(axis=(0, 1)), ref.sum(axis=(0, 1))
    assert np.all(ref_means > 0)
    gap = np.abs(means / ref_means - 1.0)
    assert np.all(gap < RAD_GAP), (case, gap)
    pix = np.abs(img - ref) / ref.max(axis=(0, 1))
    assert np.all(pix < RAD_PIXEL_GAP), (case, pix.max(axis=(0, 1)))


# ---------------------------------------------------------------------------
# Direction order, the column walk and the seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 8), (24, 12, 10)])
@pytest.mark.parametrize("phis", [PHIS16, PHIS8_A, PHIS8_B])
def test_direction_order_matches_plan_col_march(shape, phis):
    mus = MUS16 if len(phis) == 16 else MUS8
    jd, td = both_domains(column_field(*shape))
    icfg = JIcfg(n_dirs=len(phis), pallas_min_mu=0.4)
    perm = jpc.plan_col_march(jd.grid, jd, icfg, jdirections(mus, phis))[3]
    assert ck.col_dir_order(td, le.make_intensity_directions(
        mus, phis, device="cpu")) == perm


def test_permuting_directions_permutes_the_image():
    """The sorted-site rule: direction d of a launch draws its roulette at
    sites 32 + 2d of its SORTED index, so the caller's order does not
    change any direction's estimate -- a permuted grid gives the permuted
    image exactly (directions of distinct sort keys; tied keys keep the
    caller's order, as in the JAX package). With roulette off the sites
    play no part."""
    # four columns a side: the slanted directions wrap the domain a
    # different number of times, so their sort keys differ
    td = both_domains(column_field(4, 4, 6, max_scale=0.002), dx=10.0,
                      dz=30.0)[1]
    mus = [1.0, 0.9, 0.7, 0.5, 0.45, 0.8]
    phis = [0.0, 100.0, 200.0, 300.0, 45.0, 260.0]
    perm = [3, 0, 5, 1, 4, 2]
    dirs = le.make_intensity_directions(mus, phis, device="cpu")
    order = ck.col_dir_order(td, dirs)
    assert order != tuple(range(6))
    cfg = KernelConfig(n_lanes=512, photons_per_lane=1,
                       need_volume_absorption=False)
    src = illumination.directional(0.5, 30.0)
    for roulette in (True, False):
        icfg = le.IntensityConfig(n_dirs=6, use_russian_roulette=roulette,
                                  pallas_min_mu=0.4)
        a = ck.run_batch_col_tallies(td, Surface.lambertian(0.2), src, 5,
                                     cfg, n_photons=256,
                                     intensity_config=icfg,
                                     intensity_dirs=dirs)
        b = ck.run_batch_col_tallies(td, Surface.lambertian(0.2), src, 5,
                                     cfg, n_photons=256,
                                     intensity_config=icfg,
                                     intensity_dirs=dirs[:, perm])
        assert torch.equal(b.intensity, a.intensity[:, :, perm])
        assert torch.equal(b.flux_up, a.flux_up)


def _exact_tau(beta, edges, p, d, z_stop):
    """Float64 integral of the piecewise-constant extinction ``beta``
    [nx, ny, nz] (periodic in x and y) along p + t d from t = 0 until z
    reaches ``z_stop``: every x, y and z face crossing is a breakpoint."""
    xe, ye, ze = edges
    lx, ly = xe[-1] - xe[0], ye[-1] - ye[0]
    t_end = (z_stop - p[2]) / d[2]
    ts = [0.0, t_end]
    for axis, e, length in ((0, xe, lx), (1, ye, ly), (2, ze, None)):
        if abs(d[axis]) < 1e-12:
            continue
        a0, a1 = sorted((p[axis], p[axis] + d[axis] * t_end))
        shifts = [0.0] if length is None else np.arange(
            np.floor((a0 - e[0]) / length) - 1,
            np.ceil((a1 - e[0]) / length) + 1) * length
        for s in shifts:
            face = e + s
            face = face[(face > a0) & (face < a1)]
            ts.extend((face - p[axis]) / d[axis])
    ts = np.unique(np.clip(ts, 0.0, t_end))
    mid = (ts[1:] + ts[:-1]) / 2
    x = xe[0] + np.mod(p[0] + d[0] * mid - xe[0], lx)
    y = ye[0] + np.mod(p[1] + d[1] * mid - ye[0], ly)
    z = p[2] + d[2] * mid
    ix = np.clip(np.searchsorted(xe, x, side="right") - 1, 0, len(xe) - 2)
    iy = np.clip(np.searchsorted(ye, y, side="right") - 1, 0, len(ye) - 2)
    iz = np.clip(np.searchsorted(ze, z, side="right") - 1, 0, len(ze) - 2)
    return float(np.sum(beta[ix, iy, iz] * np.diff(ts)))


@pytest.mark.parametrize("gas", [False, True])
def test_column_walk_across_the_seam_matches_the_integral(gas):
    """One reflection event near each periodic seam, eight directions (all
    octants, both fast axes): the estimate w/pi * exp(-tau) gives back the
    walk's tau, which must equal a float64 integral of beta to the top;
    the pixel is the column where the ray leaves the top."""
    nx, ny, nz = 12, 10, 8
    ext = column_field(nx, ny, nz, seed=5, max_scale=0.01)
    q = gas_profile(nz, 50.0) if gas else None
    td = both_domains(ext, q)[1]
    beta = ext + (q[None, None, :] if gas else 0.0)
    edges = td.grid.edges_np()
    mus, phis = MUS8, PHIS8_A
    dirs = le.make_intensity_directions(mus, phis, device="cpu")
    icfg = le.IntensityConfig(n_dirs=8, use_russian_roulette=False,
                              pallas_min_mu=0.4)
    src = illumination.directional(0.5, 0.0)
    prm = ck.ColParams.make(td, Surface.lambertian(0.2), src, True, 1.0,
                            False, icfg, dirs)
    tab = ck.ColTables.from_domain(td, icfg, dirs)
    lx, ly = edges[0][-1], edges[1][-1]
    for sx, sy in ((lx - 3.0, 250.0), (2.0, ly - 1.5), (lx - 0.5, 1.0)):
        tally = ck.ColTally.zeros(prm, "cpu")
        sz = float(prm[ck.C_ZBOT])
        # one reflection of weight 1 in the queue's layout: lane 0, step 0
        f = torch.tensor([[sx], [sy], [sz], [1.0], [0.0], [0.0], [1.0]],
                         dtype=torch.float32)
        i = torch.tensor([[0], [0], [1]], dtype=torch.int32)
        ck.col_local_estimate_plain(tab, prm, 0, f, i, tally)
        img = tally.img.reshape(8, nx * ny).double()
        assert int(tally.counts[4]) == 0
        for d in range(8):
            (col,) = torch.nonzero(img[d]).reshape(-1).tolist()
            tau = -np.log(float(img[d, col]) * np.pi)
            dvec = dirs[:, d].double().numpy()
            p = np.array([sx, sy, sz], np.float64)
            want = _exact_tau(beta, edges, p, dvec, edges[2][-1])
            assert tau == pytest.approx(want, rel=2e-5, abs=2e-6), (sx, sy, d)
            t_top = (edges[2][-1] - sz) / dvec[2]
            ex = np.mod(p[:2] + dvec[:2] * t_top, [lx, ly])
            assert col == int(ex[0] // 100.0) * ny + int(ex[1] // 100.0)


def test_macro_majorant_at_the_periodic_seam_with_gas():
    """nx = 36 with macro factor 8: the last block is partial and its outer
    face lies past the periodic seam. With the gas template's ceiling
    (bls + qg below the plane, qg above it) the clamped faces keep the
    two-level majorant exact: R, T, A must agree with the global majorant
    (macro factor 0) within 4.5 sigma."""
    nz = 8
    ext = column_field(36, 20, nz, seed=7)
    out = {}
    for mf in (0, 8):
        td = both_domains(ext, gas_profile(nz, 50.0, beta0=4e-3),
                          macro_factor=mf)[1]
        assert td.col_template and td.col_qz is not None
        out[mf] = ck.run_batch_col(
            td, Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
            rng.batch_seed(11, mf), rk.RecordConfig(rows=16,
                                                    steps_per_call=64,
                                                    max_steps=8192), 2,
            use_russian_roulette=False)
    r = {}
    for mf, t in out.items():
        n = t.n_photons
        assert n == 16 * 128 * 2 and t.n_bad == 0
        r[mf] = np.array([float(t.flux_up.sum()), float(t.flux_down.sum()),
                          float(t.flux_absorbed.sum())]) / n
        # without roulette every weight is accounted for (albedo 0.2)
        assert r[mf] @ [1.0, 0.8, 1.0] == pytest.approx(1.0, abs=2e-4)
    sigma = np.sqrt(r[0] * (1 - r[0]) * 2 / out[0].n_photons)
    assert np.all(np.abs(r[8] - r[0]) < 4.5 * sigma), (r[8], r[0])
