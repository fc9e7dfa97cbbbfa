"""PyTorch port: in-kernel radiance (local estimation), the plain step held
against the JAX record kernel in Pallas interpret mode, plus analytic
radiance oracles on the port's plain path.

Both packages draw the same counter uniforms from the same folded seed
(the roulette draws of direction d at sites 16 + 2d and 17 + 2d), and the
JAX march is forced to the cell DDA the port implements, so photon paths
and marches coincide up to float rounding. The CUDA kernel is held against
the same plain step on the card by chip_smoke.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport.integrator import KernelConfig as JKernelConfig
from mcbrat3d_tpu.transport.integrator import run_batch as jrun_batch
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.plane_parallel import make_slab
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

MUS, PHIS = [1.0, 0.5], [0.0, 90.0]
SRC = illumination.directional(0.5, 0.0)
N_LANES = 1024  # 8 rows of 128 lanes, one photon each
DOMAIN_KW = dict(ssa=0.99, n_cdf_steps=201, compute_intensity_tables=True,
                 hybrid_width_deg=7.0)
# configuration -> (all_hg, intensity knobs, surface albedo)
CONFIGS = {
    "exact_hg": (True, dict(use_russian_roulette=False,
                            use_hybrid_phase=False), 0.2),
    "roulette_hybrid": (True, dict(use_russian_roulette=True,
                                   use_hybrid_phase=True), 0.2),
    "original_table": (False, dict(use_russian_roulette=False,
                                   use_hybrid_phase=False), 0.0),
    "cap": (True, dict(use_russian_roulette=False, use_hybrid_phase=True,
                       limit_contributions=True, max_contribution=0.02),
            0.2),
}
# Per-direction domain-mean radiance gap allowed between the plain step
# and the JAX kernel (relative). Observed ~1e-5 (float rounding of the
# same paths and marches; the JAX table lookups are exact f32 on the
# interpret path); 1e-3 leaves room for a photon whose path diverges after
# a 1-ulp difference in a transcendental, and is far below the
# per-direction MC noise (~3% at 1,024 photons).
RAD_GAP = 1e-3
# Per-pixel gap allowed between the same two images, as a fraction of the
# image maximum: a contribution tallied in the wrong column (exit column,
# x/y wrap) moves a pixel by a large part of its value (an image shifted
# by one column differs by 0.27 to 0.79 of the maximum in these
# configurations), while the shared paths agree per pixel to <= 2e-5 of
# the maximum.
RAD_PIXEL_GAP = 1e-3


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def domains(all_hg: bool):
    jdom, tdom = jmake(**DOMAIN_KW), make_step_cloud(**DOMAIN_KW, device="cpu")
    if not all_hg:  # a file-read domain: tabulated phase, no hg_g
        jdom = dataclasses.replace(jdom, all_hg=False)
        tdom = dataclasses.replace(tdom, all_hg=False)
    return jdom, tdom


def assert_images_agree(a, b, n_a, n_b):
    """Per-pixel z < 5 (the formula of tests/test_pallas.py)."""
    a = np.asarray(a, np.float64) / n_a
    b = np.asarray(b, np.float64) / n_b
    sigma = np.sqrt(a / n_a + b / n_b + 1e-12)
    z = np.abs(a - b) / np.maximum(sigma, 1e-9)
    assert z.max() < 5.0, z.max()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """One radiance batch of the JAX interpret kernel and of the port's
    plain step, same folded seed (shared by the assertions below)."""
    all_hg, knobs, albedo = CONFIGS[request.param]
    jdom, tdom = domains(all_hg)
    key = jrng.batch_key(3, 0)
    jt = jrun_batch(
        jdom, JSurface.lambertian(albedo), jill.directional(0.5, 0.0), key,
        JKernelConfig(n_lanes=N_LANES, photons_per_lane=1, max_steps=6000,
                      use_pallas="on", need_volume_absorption=False),
        JIcfg(n_dirs=2, pallas_march="cell", **knobs),
        jdirections(MUS, PHIS))
    tt = run_batch(
        tdom, Surface.lambertian(albedo), SRC, folded_seed(key),
        KernelConfig(n_lanes=N_LANES, photons_per_lane=1, max_steps=6000,
                     need_volume_absorption=False),
        intensity_config=le.IntensityConfig(n_dirs=2, **knobs),
        intensity_dirs=le.make_intensity_directions(MUS, PHIS, device="cpu"))
    return request.param, jt, tt


def test_plain_radiance_matches_jax_interpret_kernel(pair):
    name, jt, tt = pair
    n = int(jt.n_photons)
    assert tt.n_photons == n == N_LANES
    assert tt.n_bad == int(jt.n_bad) == 0
    ji, ti = np.asarray(jt.intensity), tt.intensity.numpy()
    assert ti.shape == ji.shape == (32, 1, 2)
    jm, tm = ji.mean(axis=(0, 1)), ti.mean(axis=(0, 1))
    assert np.all(jm > 0)
    gap = np.abs(tm - jm) / jm
    assert gap.max() < RAD_GAP, (name, gap)
    pixel_gap = np.abs(ti - ji).max() / np.abs(ji).max()
    assert pixel_gap < RAD_PIXEL_GAP, (name, pixel_gap)
    assert_images_agree(ti, ji, n, n)


def test_radiance_run_fluxes_match_jax(pair):
    """The flux tallies of the radiance run still follow the JAX paths."""
    _, jt, tt = pair
    n = tt.n_photons
    for a, b in ((tt.flux_up, jt.flux_up), (tt.flux_down, jt.flux_down),
                 (tt.flux_absorbed, jt.flux_absorbed)):
        assert abs(float(a.sum()) - float(np.sum(b))) / n < 1e-3


@pytest.fixture(scope="module")
def cloud():
    """A small HG slab (4 x 4 x 4 cells, tau 2): short photon lives and
    marches that cross x and y faces in both directions."""
    return make_slab(tau=2.0, ssa=0.99, nx=4, ny=4, nz=4, n_cdf_steps=201,
                     phase=PhaseFunction.henyey_greenstein(0.85, 64),
                     compute_intensity_tables=True, hybrid_width_deg=7.0,
                     device="cpu")


def test_cap_clips_and_keeps_totals(cloud):
    """With the cap the excess is redistributed per direction: against an
    uncapped run on the same seed the image changes, the totals do not."""
    _, knobs, albedo = CONFIGS["cap"]
    runs = []
    for limit in (True, False):
        runs.append(run_batch(
            cloud, Surface.lambertian(albedo), SRC, rng.batch_seed(6, 0),
            KernelConfig(n_lanes=N_LANES, photons_per_lane=1, max_steps=6000,
                         need_volume_absorption=False),
            intensity_config=le.IntensityConfig(
                n_dirs=2, **dict(knobs, limit_contributions=limit)),
            intensity_dirs=le.make_intensity_directions(MUS, PHIS,
                                                        device="cpu")))
    capped, free = (t.intensity.double() for t in runs)
    assert float((capped - free).abs().max()) > 1e-3 * float(free.max())
    torch.testing.assert_close(capped.sum(dim=(0, 1)), free.sum(dim=(0, 1)),
                               rtol=1e-5, atol=0.0)


def test_forward_table_matches_jax_packing():
    """The kernel's forward table is _pack_forward_table's f32 resampling
    (uniform in sin(theta/2)) without the bf16 split."""
    for all_hg, hybrid in ((True, True), (False, False)):
        jdom, tdom = domains(all_hg)
        packed, hf, n_s = jpk._pack_forward_table(jdom, use_hybrid=hybrid,
                                                  hif=True)
        packed = np.asarray(packed)
        v0, dd = rk.forward_table(tdom, hybrid)
        assert n_s == rk.FWD_N_S
        n = v0.numel()
        jv0 = packed[:128].T.reshape(-1)[:n]
        jdd = packed[128:].T.reshape(-1)[:n]
        scale = float(np.abs(jv0).max())
        np.testing.assert_allclose(v0.numpy(), jv0, rtol=0, atol=2e-6 * scale)
        np.testing.assert_allclose(dd.numpy(), jdd, rtol=0, atol=4e-6 * scale)


def test_flux_tallies_unchanged_by_radiance(cloud):
    """The local estimate draws only its own sites (16 + 2d, 17 + 2d), so
    at one geometry the flux tallies with radiance on equal the flux-only
    run bit for bit."""
    rcfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=6000,
                           vol_tally=False)
    sfc = Surface.lambertian(0.3)
    seed = rng.batch_seed(5, 1)
    flux = rk.run_batch_record(cloud, sfc, SRC, seed, rcfg, 1)
    icfg = le.IntensityConfig(n_dirs=2)
    rad = rk.run_batch_record(cloud, sfc, SRC, seed, rcfg, 1,
                              intensity_config=icfg,
                              intensity_dirs=le.make_intensity_directions(
                                  MUS, PHIS, device="cpu"))
    for a, b in zip(flux[:3], rad[:3]):
        assert torch.equal(a, b)
    assert flux[3:] == rad[3:6]
    assert rad[6].shape == (4, 4, 2) and float(rad[6].min()) >= 0.0


def test_chunked_directions_equal_manual_chunks(cloud, monkeypatch):
    """More directions than MAX_KERNEL_DIRS run as passes over the same
    photons: the image is the concatenation of per-chunk runs, the fluxes
    are chunk 0's, and marches cut in a later chunk still count into
    n_bad (here a march bound too short for the second chunk only)."""
    monkeypatch.setattr(le, "MAX_KERNEL_DIRS", 1)
    march_bound = le.march_bound
    monkeypatch.setattr(le, "march_bound", lambda grid, dirs, min_mu: (
        1 if float(dirs[2, 0]) == MUS[1]
        else march_bound(grid, dirs, min_mu)))
    cfg = KernelConfig(n_lanes=N_LANES, photons_per_lane=1, max_steps=6000,
                       need_volume_absorption=False)
    sfc = Surface.lambertian(0.0)
    seed = rng.batch_seed(9, 0)
    dirs = le.make_intensity_directions(MUS, PHIS, device="cpu")
    t = run_batch(cloud, sfc, SRC, seed, cfg,
                  intensity_config=le.IntensityConfig(n_dirs=2),
                  intensity_dirs=dirs)
    parts = [run_batch(cloud, sfc, SRC, seed, cfg,
                       intensity_config=le.IntensityConfig(n_dirs=1),
                       intensity_dirs=dirs[:, d:d + 1]) for d in range(2)]
    assert t.intensity.shape == (4, 4, 2)
    assert torch.equal(t.intensity,
                       torch.cat([p.intensity for p in parts], dim=-1))
    assert torch.equal(t.flux_up, parts[0].flux_up)
    assert t.n_photons == parts[0].n_photons
    assert parts[0].n_cut == 0 and parts[1].n_cut > 0
    assert t.n_bad == parts[0].n_bad + parts[1].n_cut
    assert t.n_cut == parts[1].n_cut


def test_march_bound_covers_diagonal_directions(cloud):
    """A direction at the mu floor crossing x and y faces both needs more
    iterations than dda_iteration_bound (one horizontal axis); the launch
    bound covers its own crossings."""
    dirs = le.make_intensity_directions([0.15], [45.0], device="cpu")
    need = 4 + 2 * int(np.ceil(1.0 * np.sqrt(1 - 0.15**2) / 0.15
                               * np.sqrt(0.5) / 0.25))
    assert le.MIN_MU == le.IntensityConfig(n_dirs=1).pallas_min_mu == 0.15
    assert le.dda_iteration_bound(cloud.grid, le.MIN_MU) < need
    assert le.march_bound(cloud.grid, dirs, le.MIN_MU) >= need


def test_cut_marches_are_counted(cloud, monkeypatch):
    """A march bound too short for a direction cuts its marches: they add
    nothing and are counted into n_bad, never dropped silently."""
    monkeypatch.setattr(le, "march_bound", lambda grid, dirs, min_mu: 4)
    rcfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=6000)
    icfg = le.IntensityConfig(n_dirs=1, use_russian_roulette=False)
    out = rk.run_batch_record(cloud, Surface.lambertian(0.0), SRC,
                              rng.batch_seed(2, 0), rcfg, 1,
                              intensity_config=icfg,
                              intensity_dirs=le.make_intensity_directions(
                                  [0.3], [0.0], device="cpu"))
    assert out[7] > 0 and out[4] >= out[7]


@pytest.mark.parametrize("quadrant", range(8))
def test_no_march_stall_in_any_azimuth(cloud, quadrant):
    """Negative-azimuth stall trap (ROADMAP Queue 3): face landings must
    name the cell being entered for every sign of the direction."""
    phi = 45.0 * quadrant + 22.5 * (quadrant % 2)
    rcfg = rk.RecordConfig(rows=8, steps_per_call=32, max_steps=6000)
    out = rk.run_batch_record(cloud, Surface.lambertian(0.1), SRC,
                              rng.batch_seed(4, quadrant), rcfg, 1,
                              intensity_config=le.IntensityConfig(n_dirs=1),
                              intensity_dirs=le.make_intensity_directions(
                                  [0.5], [phi], device="cpu"))
    assert out[4] == 0
    assert float(out[6].sum()) > 0


def test_ineligible_radiance_raises_naming_predicates(cloud):
    """With use_pallas='on' a radiance run no kernel takes raises, naming
    the predicates (with 'auto' it runs on the wave kernel)."""
    cfg = KernelConfig(n_lanes=N_LANES, photons_per_lane=1, use_pallas="on")
    shallow = le.make_intensity_directions([0.1], [0.0], device="cpu")
    with pytest.raises(ValueError, match="MIN_MU"):
        run_batch(cloud, Surface.lambertian(0.0), SRC, 0, cfg,
                  intensity_config=le.IntensityConfig(n_dirs=1),
                  intensity_dirs=shallow)
    up = le.make_intensity_directions([1.0], [0.0], device="cpu")
    with pytest.raises(ValueError, match="n_orders_orig_phase"):
        run_batch(cloud, Surface.lambertian(0.0), SRC, 0, cfg,
                  intensity_config=le.IntensityConfig(
                      n_dirs=1, n_orders_orig_phase=2),
                  intensity_dirs=up)
    no_tables = dataclasses.replace(make_step_cloud(ssa=0.99,
                                                    n_cdf_steps=101,
                                                    device="cpu"),
                                    all_hg=False)
    with pytest.raises(ValueError, match="compute_intensity_tables"):
        run_batch(no_tables, Surface.lambertian(0.0), SRC, 0, cfg,
                  intensity_config=le.IntensityConfig(n_dirs=1),
                  intensity_dirs=up)
    with pytest.raises(ValueError, match="nonzero mu"):
        le.make_intensity_directions([0.0], [0.0], device="cpu")


# ---------------------------------------------------------------------------
# Analytic oracles of tests/test_intensity.py on the port's plain path
# ---------------------------------------------------------------------------

def slab_radiance(dom, mu0, albedo, icfg, mus, phis, n_lanes, ppl, seed=0):
    t = run_batch(dom, Surface.lambertian(albedo),
                  illumination.directional(mu0, 0.0), rng.batch_seed(seed, 0),
                  KernelConfig(n_lanes=n_lanes, photons_per_lane=ppl,
                               max_steps=2000),
                  intensity_config=icfg,
                  intensity_dirs=le.make_intensity_directions(
                      mus, phis, device="cpu"))
    assert t.n_bad == 0
    return t.normalized(dom.grid).intensity.mean(dim=(0, 1)).numpy(), t


@pytest.fixture(scope="module")
def thin_slab():
    tau = 0.05
    dom = make_slab(tau=tau, ssa=1.0, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    compute_intensity_tables=True, device="cpu")
    rad, t = slab_radiance(dom, 1.0, 0.0,
                           le.IntensityConfig(n_dirs=2,
                                              use_russian_roulette=False),
                           [1.0, 0.5], [0.0, 0.0], 4096, 4)
    return tau, rad, t.n_photons


@pytest.mark.parametrize("i,mu_v", [(0, 1.0), (1, 0.5)])
def test_thin_isotropic_slab_radiance(thin_slab, i, mu_v):
    """First order: I(mu_v) = ssa tau P / (4 pi mu_v), P = 1, normal
    incidence, per unit incident flux on the horizontal."""
    tau, rad, n = thin_slab
    expect = tau / (4 * np.pi * mu_v)
    sigma = expect / np.sqrt(tau * n)
    assert abs(rad[i] - expect) < 4 * sigma + 0.03 * expect


def test_hg_forward_vs_backward_ratio():
    dom = make_slab(tau=0.1, ssa=1.0, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    phase=PhaseFunction.henyey_greenstein(0.7, 64),
                    compute_intensity_tables=True, device="cpu")
    rad, _ = slab_radiance(dom, 0.5, 0.0,
                           le.IntensityConfig(n_dirs=2,
                                              use_russian_roulette=False),
                           [0.5, 0.5], [0.0, 180.0], 4096, 4)
    forward, back = rad

    def hg(c):
        return (1 - 0.7**2) / (1 + 0.7**2 - 2 * 0.7 * c) ** 1.5

    assert forward > 3 * back
    np.testing.assert_allclose(forward / back, hg(0.5) / hg(-1.0), rtol=0.25)


def test_lambertian_surface_radiance():
    """tau ~ 0: every photon reflects once; the domain mean is
    albedo / pi per unit incident flux on the horizontal in every
    direction, up to float32 tally rounding."""
    dom = make_slab(tau=1e-6, ssa=1.0, nx=2, ny=2, nz=2, n_cdf_steps=101,
                    compute_intensity_tables=True, device="cpu")
    rad, _ = slab_radiance(dom, 0.7, 0.4,
                           le.IntensityConfig(n_dirs=2,
                                              use_russian_roulette=False),
                           [1.0, 0.5], [0.0, 45.0], 4096, 2)
    np.testing.assert_allclose(rad, 0.4 / np.pi, rtol=1e-4)


def test_roulette_unbiased_vs_full():
    """The Iwabuchi roulette estimator agrees with the full transmittance
    estimator in expectation (independent seeds)."""
    dom = make_slab(tau=2.0, ssa=0.99, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    phase=PhaseFunction.henyey_greenstein(0.6, 64),
                    compute_intensity_tables=True, device="cpu")

    def mean_rad(rr, seeds):
        vals = [slab_radiance(dom, 0.6, 0.0,
                              le.IntensityConfig(n_dirs=1,
                                                 use_russian_roulette=rr),
                              [0.8], [30.0], 2048, 2, seed=s)[0][0]
                for s in seeds]
        return np.mean(vals), np.std(vals, ddof=1) / np.sqrt(len(vals))

    full, fe = mean_rad(False, range(3))
    rr, re = mean_rad(True, range(3, 6))
    sigma = np.sqrt(fe**2 + re**2) + 1e-6
    assert abs(full - rr) < 4 * sigma + 0.05 * full, (full, rr, sigma)


def test_capping_preserves_total():
    dom = make_slab(tau=1.0, ssa=1.0, nx=4, ny=4, nz=4, n_cdf_steps=501,
                    phase=PhaseFunction.henyey_greenstein(0.85, 64),
                    compute_intensity_tables=True, device="cpu")
    base = le.IntensityConfig(n_dirs=1, use_russian_roulette=False)
    capped = dataclasses.replace(base, limit_contributions=True,
                                 max_contribution=0.005)
    _, t0 = slab_radiance(dom, 0.9, 0.0, base, [0.9], [0.0], 2048, 2)
    _, t1 = slab_radiance(dom, 0.9, 0.0, capped, [0.9], [0.0], 2048, 2)
    i0, i1 = t0.intensity[:, :, 0], t1.intensity[:, :, 0]
    torch.testing.assert_close(i1.sum(), i0.sum(), rtol=1e-3, atol=0.0)
    assert float(i1.max()) <= float(i0.max()) + 1e-6
