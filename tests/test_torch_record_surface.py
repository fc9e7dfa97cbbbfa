"""PyTorch port: the record kernel's uniform RPV surface and per-pixel
Lambertian albedo (K1-d) against the JAX package.

The BRDF functions against JAX's on seeded inputs; the plain record step
over an RPV surface and over a per-pixel albedo grid against the JAX record
kernel (K1, and K2 for radiance) in Pallas interpret mode, path for path
(same counter uniforms from the same folded seed); and the dispatch of
these surfaces. The CUDA kernel is held against the plain step on the card
by chip_smoke.py (phase 2j) and run end to end through run_simulation
(phases 3l and 3m).

Parted photons. The RPV weight takes expf, logf and sqrtf, which XLA on
the CPU and PyTorch round differently in the last bit, and XLA may
contract its products into FMAs; a weight so moved parts a photon's path
only where it straddles the roulette threshold. Domain means are held
within 1e-3 (tests/test_torch_record_kernel.py's RTA_GAP: room for a few of
the 4,096 photons to part, and 1/8 of the one-sigma noise), per-pixel
fluxes within z < 5. No photon was seen to part on these seeds. The
per-pixel albedo is an exact float32 read in both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.domain.domain import build_domain as jbuild_domain
from mcbrat3d_tpu.physics import surface as jsurface
from mcbrat3d_tpu.scenes.collection import \
    broken_cloud_scene as jbroken_cloud
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport.integrator import KernelConfig as JKernelConfig
from mcbrat3d_tpu.transport.integrator import run_batch as jrun_batch
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.physics import surface
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig, run_batch,
                                                      select_kernel)

torch.set_num_threads(1)

JAX_SMALL = jpk.PallasConfig(rows=16, block_rows=8, steps_per_call=32,
                             max_steps=6000, interpret=True)
SMALL = rk.RecordConfig(rows=16, steps_per_call=32, max_steps=6000)
RTA_GAP = 1e-3
# Radiance: tests/test_torch_radiance.py's per-direction and per-pixel gaps.
RAD_GAP = 1e-3
RAD_PIXEL_GAP = 1e-3
RPV = (0.25, 0.8, -0.15)  # rho0, k, theta of JAX's TestRPVSurface
KERNEL_ARGS = dict(compute_intensity=False, record_scattering_orders=0,
                   use_ray_tracing=False)


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def checker(nxs=8, lo=0.05, hi=0.65):
    """JAX's TestPerPixelSurface._checker: nxs x 1 albedos alternating lo
    and hi."""
    return np.where(np.arange(nxs) % 2 == 0, lo, hi).astype(
        np.float32).reshape(nxs, 1, 1)


def surfaces(kind, params=None):
    """(JAX surface, port surface) of one kind."""
    if kind == "rpv":
        return jsurface.Surface.rpv(*RPV), Surface.rpv(*RPV)
    p = checker() if params is None else params
    return jsurface.Surface(params=p), Surface(params=p)


def rta(fu, fd, ab, n):
    return np.array([float(np.sum(np.asarray(a))) for a in (fu, fd, ab)]) / n


def assert_pixels_agree(pairs, n):
    """Per-pixel z < 5 (the formula of tests/test_pallas.py)."""
    for a, b in pairs:
        a = np.asarray(a, np.float64) / n
        b = np.asarray(b, np.float64) / n
        sigma = np.sqrt(a / n + b / n + 1e-12)
        z = np.abs(a - b) / np.maximum(sigma, 1e-9)
        assert z.max() < 5.0, z.max()


# ---------------------------------------------------------------------------
# The BRDF functions
# ---------------------------------------------------------------------------

def _geometry(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    mu_in = -(0.02 + 0.98 * rs.rand(n)).astype(np.float32)
    mu_out = (1e-3 + (1.0 - 1e-3) * rs.rand(n)).astype(np.float32)
    phi_in = (2 * np.pi * rs.rand(n)).astype(np.float32)
    phi_out = (2 * np.pi * rs.rand(n)).astype(np.float32)
    params = np.stack([0.05 + 0.5 * rs.rand(n), 0.5 + rs.rand(n),
                       -0.4 + 0.8 * rs.rand(n)], axis=-1).astype(np.float32)
    return params, mu_in, mu_out, phi_in, phi_out


@pytest.mark.parametrize("name", ["Lambertian", "RPV"])
def test_brdf_matches_jax(name):
    """The registry's BRDFs against JAX's on seeded parameters and
    geometry, within 1e-6 relative."""
    args = _geometry()
    want = np.asarray(jsurface.BRDF_REGISTRY[name](*args))
    got = surface.BRDF_REGISTRY[name](*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert np.all(want > 0)


def test_reflectance_maps_positions_onto_pixels_as_jax():
    """Surface.reflectance over a 3 x 5 RPV grid: the fractional (x, y) ->
    pixel lookup and the BRDF, against JAX's, within 1e-6 relative; a
    registered BRDF is found by name."""
    rs = np.random.RandomState(3)
    params = np.stack([0.1 + 0.4 * rs.rand(3, 5), 0.6 + rs.rand(3, 5),
                       -0.3 + 0.6 * rs.rand(3, 5)], axis=-1).astype(
                           np.float32)
    _, mu_in, mu_out, phi_in, phi_out = _geometry(2048, 1)
    x = rs.rand(2048).astype(np.float32)
    y = rs.rand(2048).astype(np.float32)
    x[:3] = [0.0, 1.0, 0.9999999]
    args = (x, y, mu_in, mu_out, phi_in, phi_out)
    want = np.asarray(jsurface.Surface(params=params, brdf_name="RPV")
                      .reflectance(*args))
    got = Surface(params=params, brdf_name="RPV").reflectance(
        *(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    surface.register_brdf("half_lambert",
                          lambda p, *_: 0.5 * p[..., 0])
    try:
        half = Surface(params=params[..., :1], brdf_name="half_lambert")
        np.testing.assert_array_equal(
            half.reflectance(*(torch.tensor(a) for a in args)).numpy(),
            0.5 * params[..., 0][np.minimum((x * 3).astype(int), 2),
                                 np.minimum((y * 5).astype(int), 4)])
    finally:
        del surface.BRDF_REGISTRY["half_lambert"]


def test_kernel_form_matches_rpv_reflectance():
    """The record kernel's trig-free RPV weight (rk.rpv_weight, JAX's
    pallas_kernel.py:1440-1477: cos(dphi) from the direction components,
    tan(acos(mu)) as sqrt(1 - mu^2) / mu) equals rpv_reflectance, the
    port's and JAX's, within 1e-5 relative, for incoming directions down
    to grazing and straight down (where cos(dphi) is taken as 1)."""
    rho0, k, th = RPV
    params, mu_in, mu_out, phi_in, phi_out = _geometry(8192, 2)
    mu_in[:4] = -1.0
    s_in = np.sqrt(1.0 - mu_in.astype(np.float64) ** 2)
    ux = torch.tensor((s_in * np.cos(phi_in)).astype(np.float32))
    uy = torch.tensor((s_in * np.sin(phi_in)).astype(np.float32))
    uz = torch.tensor(mu_in)
    mu_new = torch.tensor(mu_out)
    sin_new = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
    phi = torch.tensor(phi_out)
    got = rk.rpv_weight(rho0, k, th, ux, uy, uz, mu_new, sin_new,
                        torch.cos(phi), torch.sin(phi)).numpy()
    p = np.broadcast_to(np.asarray(RPV, np.float32), params.shape)
    args = (p, mu_in, mu_out, phi_in, phi_out)
    for want in (np.asarray(jsurface.rpv_reflectance(*args)),
                 surface.rpv_reflectance(
                     *(torch.tensor(np.ascontiguousarray(a))
                       for a in args)).numpy()):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The plain step against JAX's record kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_clouds():
    kw = dict(ssa=0.99, n_cdf_steps=201, macro_factor=8)
    return jmake(**kw), make_step_cloud(**kw, device="cpu")


@pytest.fixture(scope="module")
def flux_runs(step_clouds):
    """One batch over the RPV surface and one over the per-pixel checker,
    JAX's interpret-mode K1 and the port's plain step on the same folded
    seed: kind -> (JAX tuple, port tuple)."""
    jdom, tdom = step_clouds
    out = {}
    for i, kind in enumerate(("rpv", "px")):
        jsfc, tsfc = surfaces(kind)
        key = jrng.batch_key(4, i)
        out[kind] = (
            jpk.run_batch_pallas(jdom, jsfc, jill.directional(0.5, 0.3), key,
                                 JAX_SMALL, photons_per_lane=2),
            rk.run_batch_record(tdom, tsfc, illumination.directional(0.5, 0.3),
                                folded_seed(key), SMALL, 2))
    return out


@pytest.mark.parametrize("kind", ["rpv", "px"])
def test_plain_step_matches_jax_interpret_kernel(flux_runs, kind):
    """RPV and per-pixel flux on the step cloud, path for path: equal
    photons, n_bad and launches; domain-mean R/T/A within 1e-3 and every
    pixel within z < 5."""
    (fu, fd, vol, n, n_bad, n_calls), (tu, tdn, tv, tn, t_bad, t_calls) = \
        flux_runs[kind]
    assert tn == int(n) == 16 * 128 * 2
    assert t_bad == int(n_bad) == 0 and t_calls == int(n_calls)
    tu, tdn, tv = (t.numpy() for t in (tu, tdn, tv))
    gap = np.abs(rta(tu, tdn, tv, tn) - rta(fu, fd, vol, tn))
    assert gap.max() < RTA_GAP, gap
    assert_pixels_agree([(tu, fu), (tdn, fd),
                         (tv.sum(axis=2), np.asarray(vol).sum(axis=2))], tn)


def test_rpv_differs_from_lambertian_of_its_rho0(flux_runs, step_clouds):
    """The RPV weight really changes the run (JAX's TestRPVSurface check):
    on the same seed the reflected flux leaves a Lambertian surface of
    albedo rho0 by more than 0.01."""
    _, (tu, _, _, tn, _, _) = flux_runs["rpv"]
    lam = rk.run_batch_record(step_clouds[1], Surface.lambertian(RPV[0]),
                              illumination.directional(0.5, 0.3),
                              folded_seed(jrng.batch_key(4, 0)), SMALL, 2)
    assert abs(float(tu.sum()) / tn - float(lam[0].sum()) / lam[3]) > 0.01


def test_uniform_grid_equals_the_scalar_albedo_bit_for_bit(step_clouds):
    """A 4 x 1 grid of one value takes the per-pixel branch and reproduces
    the uniform Lambertian run bit for bit (JAX's
    test_uniform_valued_grid_matches_scalar_bitwise): the column keying and
    the albedo read."""
    tdom = step_clouds[1]
    grid_sfc = Surface(params=np.full((4, 1, 1), 0.3, np.float32))
    prm = rk.RecordParams.make(tdom, grid_sfc, illumination.flux(), True,
                               1.0, True)
    assert prm.surface == rk.SURF_PX
    a, b = (rk.run_batch_record(tdom, sfc, illumination.directional(0.5, 0.0),
                                rng.batch_seed(3, 0), SMALL, 2)
            for sfc in (grid_sfc, Surface.lambertian(0.3)))
    assert a[3:] == b[3:]
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


def test_per_pixel_radiance_matches_jax_interpret_kernel():
    """Per-pixel albedo under 6 directions (the radiance deck's) on K2:
    the surface term stays 1/pi, the albedo rides the reflected weight.
    Against JAX's in-kernel estimator on the same folded seed: per-direction
    means within 1e-3, pixels within 1e-3 of the image maximum, fluxes
    within 1e-3 per photon."""
    kw = dict(ssa=0.99, n_cdf_steps=201, compute_intensity_tables=True,
              hybrid_width_deg=7.0)
    jdom, tdom = jmake(**kw), make_step_cloud(**kw, device="cpu")
    mus = [1.0, 1.0, 0.8660254, 0.8660254, 0.5, 0.5]
    phis = [0.0, 90.0] * 3
    jsfc, tsfc = surfaces("px", checker(8, 0.1, 0.8))
    key = jrng.batch_key(5, 0)
    knobs = dict(use_russian_roulette=True, zeta_min=0.3,
                 use_hybrid_phase=True)
    jt = jrun_batch(
        jdom, jsfc, jill.directional(0.5, 0.0), key,
        JKernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                      use_pallas="on", need_volume_absorption=False),
        JIcfg(n_dirs=6, pallas_march="cell", **knobs),
        jdirections(mus, phis))
    tt = run_batch(
        tdom, tsfc, illumination.directional(0.5, 0.0), folded_seed(key),
        KernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000,
                     need_volume_absorption=False),
        intensity_config=le.IntensityConfig(n_dirs=6, **knobs),
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
        assert abs(float(a.sum()) - float(np.sum(b))) / 1024 < 1e-3


def test_grid_of_many_packing_rows_matches_jax_interpret_kernel():
    """A 16 x 16 albedo grid on a 32 x 32 x 8 broken cloud: 1,024 columns,
    eight of JAX's 128-lane albedo rows (its row select chain; the port
    reads one flat array). Path for path: R/T/A within 1e-3, pixels
    within z < 5."""
    size = dict(nx=32, ny=32, nz=8)
    bkw = dict(macro_factor=8, n_cdf_steps=201)
    jdom = jbuild_domain(*jbroken_cloud(**size)[:2], **bkw)
    tdom = build_domain(*broken_cloud_scene(**size, device="cpu")[:2], **bkw)
    rs = np.random.RandomState(4)
    p = (0.1 + 0.7 * rs.rand(16, 16, 1)).astype(np.float32)
    jsfc, tsfc = surfaces("px", p)
    key = jrng.batch_key(6, 0)
    jcfg = dataclasses.replace(JAX_SMALL, rows=8)
    fu, fd, vol, n, n_bad, _ = jpk.run_batch_pallas(
        jdom, jsfc, jill.directional(0.5, 0.0), key, jcfg,
        photons_per_lane=2)
    tu, tdn, tv, tn, t_bad, _ = rk.run_batch_record(
        tdom, tsfc, illumination.directional(0.5, 0.0), folded_seed(key),
        dataclasses.replace(SMALL, rows=8), 2)
    assert tn == int(n) == 8 * 128 * 2 and t_bad == int(n_bad) == 0
    tu, tdn, tv = (t.numpy() for t in (tu, tdn, tv))
    gap = np.abs(rta(tu, tdn, tv, tn) - rta(fu, fd, vol, tn))
    assert gap.max() < RTA_GAP, gap
    assert_pixels_agree([(tu, fu), (tdn, fd)], tn)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

DISPATCH_CASES = {
    # name: (surface kind or albedo grid, lw_mode with emission, on K1)
    "uniform_rpv": ("rpv", False, True),
    "checker": (checker(), False, True),
    "rpv_lw_mode": ("rpv", True, True),
    "grid_not_dividing_the_columns": (checker(5), False, False),
    "checker_in_lw_mode": (checker(), True, False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_matches_jax(case):
    """The port picks the record kernel for a uniform RPV or per-pixel
    Lambertian surface exactly where JAX's predicate is empty: a grid whose
    pixels do not tile the columns (5 over 32) and a per-pixel grid in
    lw_mode fall off it in both packages, with the same reasons."""
    kind, lw, on_k1 = DISPATCH_CASES[case]
    jdom, tdom = jmake(ssa=0.99), make_step_cloud(ssa=0.99, device="cpu")
    if isinstance(kind, str):
        jsfc, tsfc = surfaces(kind)
    else:
        jsfc, tsfc = surfaces("px", kind)
    if lw:
        shape = tdom.grid.shape
        cdf = np.linspace(0.0, 1.0, int(np.prod(shape)) + 1)[1:]
        jsrc = jill.emission(cdf, 0.8, shape)
        tsrc = illumination.emission(cdf, 0.8, shape, device="cpu")
    else:
        jsrc, tsrc = jill.directional(0.5, 0.0), illumination.directional(
            0.5, 0.0)
    jr = jpk.ineligibility_reasons(jdom, jsfc, jsrc, lw_mode=lw,
                                   **KERNEL_ARGS)
    tr = rk.ineligibility_reasons(tdom, tsfc, tsrc, lw_mode=lw,
                                  **KERNEL_ARGS)
    assert tr == jr
    assert (tr == []) == on_k1
    picked = select_kernel(tdom, tsfc, tsrc, KernelConfig(
        n_lanes=1024, photons_per_lane=1, lw_mode=lw))[0]
    assert (picked == "record") == on_k1, picked
    if not on_k1:
        assert tr[0].startswith("non-uniform or unsupported-BRDF surface")
        with pytest.raises(ValueError, match="does not reflect off"):
            rk.RecordParams.make(tdom, tsfc, tsrc, True, 1.0, True,
                                 lw_mode=lw)


def test_rpv_radiance_is_refused_by_the_record_kernel_as_jax():
    """Radiance over an RPV surface stays off K2 in both packages (its
    surface term is Lambertian's 1/pi): the intensity predicates name the
    same reasons, and the record kernel's own parameters refuse the case,
    so a direct call cannot run it either."""
    kw = dict(ssa=0.99, compute_intensity_tables=True)
    jdom, tdom = jmake(**kw), make_step_cloud(**kw, device="cpu")
    jsfc, tsfc = surfaces("rpv")
    mus, phis = [1.0, 0.5], [0.0, 90.0]
    jr = jpk.intensity_ineligibility_reasons(
        jdom, jsfc, jill.directional(0.5, 0.0), lw_mode=False,
        record_scattering_orders=0, use_ray_tracing=False,
        icfg=JIcfg(n_dirs=2), dirs=jdirections(mus, phis), dirs_mu_ok=True)
    icfg = le.IntensityConfig(n_dirs=2)
    dirs = le.make_intensity_directions(mus, phis, device="cpu")
    src = illumination.directional(0.5, 0.0)
    tr = rk.intensity_ineligibility_reasons(
        tdom, tsfc, src, lw_mode=False, record_scattering_orders=0,
        use_ray_tracing=False, icfg=icfg, dirs=dirs)
    assert tr == jr == ["intensity with a non-Lambertian surface"]
    with pytest.raises(ValueError, match="non-Lambertian"):
        rk.RecordParams.make(tdom, tsfc, src, True, 1.0, False,
                             intensity_config=icfg, intensity_dirs=dirs)
    with pytest.raises(ValueError, match="non-Lambertian"):
        rk.run_batch_record(tdom, tsfc, src, 0, SMALL, 1,
                            intensity_config=icfg, intensity_dirs=dirs)
