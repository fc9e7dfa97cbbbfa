"""PyTorch port: the refill schedule of the record kernel's flux path (K1,
K1-a/b, K1-c, K1-d).

``run_batch`` runs every flux launch of the record kernel on the refill
schedule (``record_kernel.RefillSchedule``): as many slots as the card
holds resident threads for the kernel's instantiation (the occupancy
query; on the CPU, where there is none, the JAX package's 65,536 lanes or
the count a test gives), no more than the batch's photons fill, each slot
starting its share of the photons in the kernel, launches of
``record_kernel.REFILL_STEPS`` steps under ``relaunch_loop``, the step cap
rounded up to whole launches, int64 launch counters, and a plain twin that
stops once no lane has work, as the kernel's lanes do. The JAX package's
geometry (at most 512 rows of 128 lanes, 128 steps a launch) stays
selectable (``record_kernel.jax_geometry``), radiance keeps it at most 32
rows, and the parity tests of tests/test_torch_record_*.py,
test_torch_lw_emission.py and test_torch_radiance.py hold the port against
the JAX kernel on it, photon for photon.

Here the plain twin on the refill schedule, with fewer slots than photons
(256 slots, 4,096 photons: sixteen a slot in one launch) for every source,
3 components, the two K1-d surfaces and the emission refill with lw_mode:
the photon count is exact, n_bad is 0, the energy balance holds without
roulette, and R, T, A (net absorption for LW) agree with the same scene on
JAX's geometry, and with the JAX record kernel in interpret mode, within
4.5 combined sigma. Other slots draw other counter uniforms, so those
comparisons are statistical. Without roulette every photon's share of R
and of the absorption is a weight in [0, 1] (its exit weight, or the
weight it lost: reflectances stay below 1), and over a black surface so is
its share of T; the standard error of a mean m over n photons is then at
most sqrt(m (1 - m) / n), and the limit uses that bound. Over a reflecting
surface a photon may reach it more than once, so its share of T has no
such bound and T is held by the energy balance instead.
"""

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface, column_albedo
from mcbrat3d_tpu_torch.scenes.step_cloud import (make_step_cloud,
                                                  make_step_cloud_multi)
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import weights
from mcbrat3d_tpu_torch.transport import integrator
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

torch.set_num_threads(1)

Z_LIMIT = 4.5
SLOTS, N_PHOTONS = 256, 4096
# the step cloud cut to short paths: ssa 0.9, optical depths 2 and 6
STEP = dict(ssa=0.9, tau_thick=6.0, n_cdf_steps=201)
# an RPV surface whose reflectance stays below 1 (k > 1 bounds the
# Minnaert term by 2^(k - 1)), so no weight grows past 1
RPV = (0.25, 1.2, -0.15)
CHECKER = np.where(np.arange(8) % 2 == 1, 0.65, 0.05).astype(
    np.float32).reshape(8, 1, 1)


def refill(max_steps=20_000, slots=SLOTS, **kw):
    return rk.RefillSchedule(max_steps, resident=slots, **kw)


def folded_seed(key) -> int:
    """The uint32 seed the JAX kernels fold from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def emission_scene(macro_factor=8):
    """An 8 x 4 x 8 half-filled cloud over a uniform gas with 3D
    temperatures of 250-290 K (tests/test_torch_lw_emission.py's lw_setup)
    and its per-voxel emission source, every birth in the atmosphere (so
    that each carries a pre-credit and the LW energy identity is exact)."""
    nx, ny, nz = 8, 4, 8
    rs = np.random.RandomState(0)
    cld = rs.rand(nx, ny, nz) * 6.0
    temps = 250.0 + 40.0 * rs.rand(nx, ny, nz)
    gas = np.full((1, 1, nz), 0.5)
    grid = Grid.regular(nx, ny, nz, 0.5, 0.5, 0.25, device="cpu")
    comps = [OpticalComponent("cloud", cld, np.full_like(cld, 0.6),
                              np.zeros(cld.shape, np.int32),
                              PhaseFunctionTable(
                                  [PhaseFunction.henyey_greenstein(0.85, 64)],
                                  key=[1.0])),
             OpticalComponent("gas", gas, np.zeros_like(gas),
                              np.zeros(gas.shape, np.int32),
                              PhaseFunctionTable([PhaseFunction.isotropic()],
                                                 key=[1.0]))]
    dom = build_domain(grid, comps, temps=temps, n_cdf_steps=201,
                       macro_factor=macro_factor)
    w = weights.emission_weighting(grid, temps,
                                   weights.absorption_coefficient(comps, grid),
                                   290.0, 0.95, 10.0)
    return dom, illumination.emission(w.voxel_cdf, 1.0, grid.shape,
                                      device="cpu")


# name -> (domain, surface, source, lw_mode)
def case(name):
    if name == "emission_lw":
        dom, src = emission_scene()
        return dom, Surface.lambertian(0.0), src, True
    if name == "three_components":
        return (make_step_cloud_multi(n_components=3, macro_factor=8,
                                      device="cpu", **STEP),
                Surface.lambertian(0.0), illumination.directional(0.5, 0.0),
                False)
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    sfc = {"rpv": Surface.rpv(*RPV),
           "per_pixel": Surface(params=CHECKER)}.get(
               name, Surface.lambertian(0.0))
    src = {"random_azimuth": illumination.random_azimuth(0.6),
           "flux": illumination.flux(),
           "spotlight": illumination.spotlight(0.8, 20.0, 0.3, 0.6)}.get(
               name, illumination.directional(0.5, 0.0))
    return dom, sfc, src, False


CASES = ["directional", "random_azimuth", "flux", "spotlight",
         "three_components", "rpv", "per_pixel", "emission_lw"]


def shares(t):
    """R, T and A (net absorption with lw_mode) per photon, float64."""
    return np.array([float(a.double().sum()) / t.n_photons
                     for a in (t.flux_up, t.flux_down, t.flux_absorbed)])


def assert_within_sigma(a, b, n, names):
    """Each mean of a and b (n photons each) within Z_LIMIT combined
    sigma, each sigma bounded by sqrt(|m| (1 - |m|) / n)."""
    a, b = np.abs(np.asarray(a)), np.abs(np.asarray(b))
    var = (np.clip(a * (1 - a), 0, None) + np.clip(b * (1 - b), 0, None)) / n
    z = np.abs(a - b) / np.sqrt(np.maximum(var, 1e-30))
    assert (z < Z_LIMIT).all(), (names, z, a, b)


def recording(seen):
    """record_launch_plain, recording (lanes, step0, k_steps, counts
    dtype) of each launch."""
    plain = rk.record_launch_plain

    def run(st, tab, prm, seed, step0, k, tally):
        seen.append((st.x.shape[0], step0, k, tally.counts.dtype))
        plain(st, tab, prm, seed, step0, k, tally)
    return run


# ---------------------------------------------------------------------------
# The schedule run_batch takes
# ---------------------------------------------------------------------------

def test_run_batch_takes_the_refill_schedule_unless_a_geometry_is_given(
        monkeypatch):
    """run_batch sends a K1 flux batch to the refill schedule (on the CPU
    JAX's 65,536 slots, capped by the batch's photons in whole rows: 2,000
    photons on 16 rows, one launch of REFILL_STEPS); rk.jax_geometry gives
    JAX's 8 rows of 128 lanes and 128 steps a launch."""
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    seen = []
    monkeypatch.setattr(rk, "record_launch_plain", recording(seen))
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=2,
                       need_volume_absorption=False)
    args = (dom, Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
            3, cfg)
    assert integrator.select_kernel(*args[:3], cfg, None, None)[0] == "record"
    t = integrator.run_batch(*args, n_photons=2000)
    assert t.n_photons == 2000 and t.n_bad == 0
    assert seen == [(2048, 0, rk.REFILL_STEPS, torch.int64)]
    assert t.n_steps == rk.REFILL_STEPS
    seen.clear()
    jax_cfg = rk.jax_geometry(cfg)
    assert (jax_cfg.rows, jax_cfg.steps_per_call) == (8, 128)
    t = rk.run_batch_record_tallies(*args, rcfg=jax_cfg)
    assert t.n_photons == 2048 and t.n_bad == 0
    assert {s[:1] + s[2:] for s in seen} == {(1024, 128, torch.int64)}
    assert t.n_steps == 128 * len(seen)


def test_radiance_keeps_the_jax_geometry(monkeypatch):
    """A radiance run takes JAX's geometry at most RADIANCE_ROWS rows
    (8,192 lanes asked, 4,096 run) and 128 steps a launch, whatever rcfg
    says."""
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    seen = []
    monkeypatch.setattr(rk, "record_launch_plain", recording(seen))
    cfg = KernelConfig(n_lanes=1 << 13, photons_per_lane=1,
                       need_volume_absorption=False)
    t = integrator.run_batch(
        dom, Surface.lambertian(0.0), illumination.directional(0.5, 0.0), 4,
        cfg, n_photons=64,
        intensity_config=le.IntensityConfig(n_dirs=2,
                                            use_russian_roulette=False,
                                            use_hybrid_phase=False),
        intensity_dirs=le.make_intensity_directions([1.0, 0.6], [0.0, 90.0],
                                                    device="cpu"))
    assert t.n_photons == 64 and t.n_bad == 0 and t.intensity is not None
    assert {s[:1] + s[2:] for s in seen} == {
        (rk.RADIANCE_ROWS * 128, 128, torch.int64)}


def test_counters_are_int64():
    """The launch counters are int64 in the tally and through the relaunch
    loop, which adds a launch's lane-steps past 2^31 without wrapping."""
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    prm = rk.RecordParams.make(dom, Surface.lambertian(0.0),
                               illumination.directional(0.5, 0.0), True, 1.0,
                               False)
    assert rk.RecordTally.zeros(prm, "cpu").counts.dtype == torch.int64
    st = rk.RecordState.initial(torch.zeros(128, dtype=torch.int32), 1.0)
    counts = torch.zeros(rk.N_COUNTS, dtype=torch.int64)

    def launch(step0):
        counts[0] += 3
        counts[2] += 3 << 31
        counts[3] += 5 << 31

    assert rk.relaunch_loop(st, counts, launch, 4096, 8192,
                            n_per_launch=4) == (3, 1, 3 << 31, 5 << 31)


def test_the_twin_stops_once_no_lane_has_work(monkeypatch):
    """One photon a slot in a launch of REFILL_STEPS steps: the twin runs
    as many plain steps as the longest photon takes, not the launch's
    length; a launch one step shorter leaves that photon alive (n_bad)."""
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    calls, step = [], rk.record_step_plain
    monkeypatch.setattr(rk, "record_step_plain",
                        lambda *a: calls.append(1) or step(*a))
    cfg = KernelConfig(n_lanes=256, photons_per_lane=1,
                       need_volume_absorption=False)
    args = (dom, Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
            9, cfg)
    t = rk.run_batch_record_tallies(*args, rcfg=refill())
    n = len(calls)
    assert t.n_photons == 256 and t.n_bad == 0
    assert t.n_steps == rk.REFILL_STEPS and 0 < n < rk.REFILL_STEPS
    calls.clear()
    t = rk.run_batch_record_tallies(
        *args, rcfg=refill(max_steps=n - 1, k_steps=n - 1))
    assert len(calls) == n - 1 and t.n_bad > 0


@pytest.mark.parametrize("max_steps,k_steps,cap", [
    (20_000, 4096, 20_480), (100, 4096, 4096), (100, 64, 128)])
def test_the_step_cap_rounds_up_to_whole_launches(max_steps, k_steps, cap,
                                                  monkeypatch):
    """The schedule's cap is whole launches: 20,000 steps run to 20,480,
    100 to one launch of 4,096 (every photon ends: n_bad 0) or, in
    launches of 64, to two (128 steps: the photons alive then are
    n_bad)."""
    assert rk.RefillSchedule(max_steps, k_steps=k_steps).geometry(
        N_PHOTONS, SLOTS)[0].max_steps == cap
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    seen = []
    monkeypatch.setattr(rk, "record_launch_plain", recording(seen))
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=4, max_steps=max_steps,
                       need_volume_absorption=False)
    t = rk.run_batch_record_tallies(
        dom, Surface.lambertian(0.2), illumination.directional(0.5, 0.0), 5,
        cfg, rcfg=refill(max_steps, k_steps=k_steps))
    assert [s[1] for s in seen] == list(range(0, t.n_steps, k_steps))
    assert t.n_steps <= cap
    if k_steps == 64:
        assert t.n_steps == cap and t.n_bad > 0
        assert t.n_lane_steps <= SLOTS * cap
    else:
        assert t.n_bad == 0 and t.n_photons == N_PHOTONS


# ---------------------------------------------------------------------------
# Sixteen photons a slot, every configuration of the flux path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CASES)
def runs(request):
    """(name, domain, surface, refill tallies, JAX-geometry tallies) of
    one case: 4,096 photons without roulette on 256 slots and on JAX's
    1,024 lanes x 4 photons."""
    dom, sfc, src, lw = case(request.param)
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=4, lw_mode=lw,
                       need_volume_absorption=False,
                       use_russian_roulette=False)
    out = [rk.run_batch_record_tallies(dom, sfc, src, 21, cfg, rcfg=sched)
           for sched in (refill(), rk.jax_geometry(cfg))]
    return (request.param, dom, sfc) + tuple(out)


def test_refill_counts_every_photon(runs):
    """Exact photon count, no photon left at the cap, one launch of
    REFILL_STEPS steps on the refill schedule and more than one lane-step
    a photon; the 3D tally (lw_mode) sums to the column absorption."""
    name, dom, _, t, j = runs
    for r in (t, j):
        assert r.n_photons == N_PHOTONS and r.n_bad == 0
    assert t.n_steps == rk.REFILL_STEPS and t.n_lane_steps > N_PHOTONS
    assert j.n_steps % 128 == 0
    assert (t.volume_absorption is not None) == (name == "emission_lw")
    if t.volume_absorption is not None:
        assert float(t.volume_absorption.double().sum()) == pytest.approx(
            float(t.flux_absorbed.double().sum()), rel=1e-5)


def test_refill_energy_balance_without_roulette(runs):
    """Every started weight leaves the top, is absorbed or stays in the
    surface: R + A + sum((1 - albedo) T) == 1 per photon over the black
    surfaces and the per-pixel grid (its albedo per column); with lw_mode,
    every birth atmospheric (pre-credit -1), R + T == -A. The RPV
    surface's reflected weight is not tallied (no balance to hold)."""
    name, dom, sfc, t, _ = runs
    if name == "rpv":
        assert sfc.is_uniform_rpv
        return
    up, down, ab = (float(a.double().sum()) / t.n_photons
                    for a in (t.flux_up, t.flux_down, t.flux_absorbed))
    if name == "emission_lw":
        assert up + down == pytest.approx(-ab, abs=2e-4)
        assert ab < 0
        return
    nx, ny, _ = dom.grid.shape
    alb = column_albedo(sfc, nx, ny, "cpu").double() if (
        name == "per_pixel") else torch.zeros(nx * ny, dtype=torch.float64)
    kept = float(((1 - alb) * t.flux_down.double().reshape(-1)).sum())
    assert up + ab + kept / t.n_photons == pytest.approx(1.0, abs=2e-4)


def test_refill_matches_jax_geometry(runs):
    """R, T, A (net absorption with lw_mode) on the refill schedule and on
    JAX's geometry within 4.5 combined sigma (T over the black surfaces
    and with lw_mode; over the RPV surface and the grid R and A)."""
    name, _, _, t, j = runs
    keep = [0, 2] if name in ("rpv", "per_pixel") else [0, 1, 2]
    assert_within_sigma(shares(t)[keep], shares(j)[keep], N_PHOTONS,
                        [("R", "T", "A")[k] for k in keep])


def test_refill_matches_the_jax_interpret_kernel():
    """The refill schedule's plain twin against the JAX record kernel in
    interpret mode (its geometry: 16 rows x 2 photons, 32 steps a launch)
    on the cut step cloud over a black surface: R, T, A within 4.5
    combined sigma."""
    n = 16 * 128 * 2
    key = jrng.batch_key(4, 0)
    fu, fd, ab, jn, jbad, _ = jpk.run_batch_pallas(
        jmake(macro_factor=8, **STEP), JSurface.lambertian(0.0),
        jill.directional(0.5, 0.0), key,
        jpk.PallasConfig(rows=16, block_rows=8, steps_per_call=32,
                         max_steps=6000, interpret=True),
        photons_per_lane=2, use_russian_roulette=False)
    assert int(jn) == n and int(jbad) == 0
    t = rk.run_batch_record_tallies(
        make_step_cloud(macro_factor=8, device="cpu", **STEP),
        Surface.lambertian(0.0), illumination.directional(0.5, 0.0),
        folded_seed(key),
        KernelConfig(n_lanes=n, photons_per_lane=1,
                     need_volume_absorption=False,
                     use_russian_roulette=False),
        rcfg=refill())
    assert t.n_photons == n and t.n_bad == 0
    jax_shares = np.array([float(np.asarray(a, np.float64).sum()) / n
                           for a in (fu, fd, ab)])
    assert_within_sigma(shares(t), jax_shares, n, "R/T/A")


def test_the_jax_geometry_still_carries_the_jax_photons():
    """On JAX's geometry with one photon a lane the refill schedule's
    slots are JAX's lanes: the two schedules start the same photons on the
    same lanes at the same steps, so their tallies agree to float32
    rounding."""
    dom = make_step_cloud(macro_factor=8, device="cpu", **STEP)
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=1,
                       need_volume_absorption=False)
    args = (dom, Surface.lambertian(0.2), illumination.directional(0.5, 0.0),
            13, cfg)
    a = rk.run_batch_record_tallies(*args)
    b = rk.run_batch_record_tallies(*args, rcfg=rk.jax_geometry(cfg))
    assert a.n_photons == b.n_photons == 1024
    assert a.n_lane_steps == b.n_lane_steps and a.n_real == b.n_real
    for x, y in ((a.flux_up, b.flux_up), (a.flux_down, b.flux_down),
                 (a.flux_absorbed, b.flux_absorbed)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
