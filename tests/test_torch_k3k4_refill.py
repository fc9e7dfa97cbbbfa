"""PyTorch port: the refill schedule of the column (K3) and separable (K4)
kernels' flux paths.

``run_batch`` runs K3's and K4's flux paths on the refill schedule
(``record_kernel.RefillSchedule``): as many slots as the card holds
resident threads for the kernel (the occupancy query; on the CPU, where
there is none, the JAX package's 65,536 lanes or the count a test gives),
no more than the batch's photons fill, each slot starting its share of the
photons in the kernel, launches of ``record_kernel.REFILL_STEPS`` steps
under ``relaunch_loop``, the step cap rounded up to whole launches. The
JAX package's geometry (at most 512 rows of 128 lanes, 128 steps a launch)
stays selectable (``record_kernel.jax_geometry``) and the parity tests of
tests/test_torch_col_kernel.py and tests/test_torch_sep_kernel.py run on
it, photon for photon.

Here the plain twins on the refill schedule, with fewer slots than photons
so that every slot starts several photons and a launch outlasts them: the
photon count is exact, n_bad is 0, the energy balance holds without
roulette, and the domain means and the absorption profile agree with the
same scene on JAX's geometry, and with the JAX package's kernel in
interpret mode, within 4.5 combined sigma. Other slots draw other counter
uniforms, so those comparisons are statistical. Without roulette over a
black surface every photon's share of R, of T, of the absorption and of
each level's absorption is a weight in [0, 1] (its final weight, one exit
or the weight it lost), so the standard error of a mean m over n photons
is at most sqrt(m (1 - m) / n); the limit uses that bound.
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
from mcbrat3d_tpu.scenes.collection import lw_flagship_scene as jscene
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import lw_flagship_scene
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport import sep_kernel as sk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig

torch.set_num_threads(1)

Z_LIMIT = 4.5
# 256 slots for 2,048 photons: eight a slot, one launch of 4,096 steps
SLOTS, N_PHOTONS = 256, 2048

SOURCES = {
    "directional": (lambda: illumination.directional(0.5, 0.0),
                    lambda: jill.directional(0.5, 0.0)),
    "random_azimuth": (lambda: illumination.random_azimuth(0.5),
                       lambda: jill.random_azimuth(0.5)),
    "flux": (illumination.flux, jill.flux),
}


def folded_seed(key) -> int:
    """The uint32 seed the JAX kernels fold from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def column_field(nx, ny, nz, seed=0, max_scale=0.05):
    """Broken-cloud extinction [nx, ny, nz]: a column template."""
    rs = np.random.RandomState(seed)
    f = rs.rand(nx, ny)
    for _ in range(3):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    scale = rs.rand(nx, ny) * max_scale * (f > np.quantile(f, 0.55))
    h = np.ceil(f * nz).astype(int) * (scale > 0)
    return np.where(np.arange(nz)[None, None, :] < h[:, :, None],
                    scale[:, :, None], 0.0)


def col_domains(macro_factor, analytic=True):
    """(JAX domain, port domain) of the 16 x 16 x 8 column field (the
    col_domain of tests/test_torch_col_kernel.py), ssa 0.9 so that the
    absorption is not small."""
    ext = column_field(16, 16, 8)
    args = (ext, np.full_like(ext, 0.9), np.zeros(ext.shape, np.int32))
    jd = jbuild(JGrid.regular(16, 16, 8, 100.0, 100.0, 50.0),
                [JComponent("cloud", *args,
                            JPFT([JPF.henyey_greenstein(0.85, 64)],
                                 key=[1.0]))],
                n_cdf_steps=201, macro_factor=macro_factor)
    td = build_domain(Grid.regular(16, 16, 8, 100.0, 100.0, 50.0,
                                   device="cpu"),
                      [OpticalComponent("cloud", *args, PhaseFunctionTable(
                          [PhaseFunction.henyey_greenstein(0.85, 64)],
                          key=[1.0]))],
                      n_cdf_steps=201, macro_factor=macro_factor)
    if not analytic:
        jd = dataclasses.replace(jd, all_hg=False)
        td = dataclasses.replace(td, all_hg=False)
    return jd, td


def sep_domains(nz=150):
    """(JAX, port) compact separable domains of the flagship scene cut to
    16 x 16 columns."""
    kw = dict(nx=16, ny=16, nz=nz, cloud_base_level=55 * nz // 150,
              cloud_top_level=85 * nz // 150)
    dkw = dict(macro_factor=8, n_cdf_steps=201, lambda_um=10.0,
               device_fields="compact")
    jg, jc, jt = jscene(**kw)
    tg, tc, tt = lw_flagship_scene(**kw, device="cpu")
    return (jbuild(jg, jc, temps=jt, **dkw),
            build_domain(tg, tc, temps=tt, **dkw))


def refill(max_steps=20_000, slots=SLOTS, **kw):
    return rk.RefillSchedule(max_steps, resident=slots, **kw)


def means(fu, fd, ac, az, n):
    """R, T, A and the absorption profile per photon, as float64 (from
    torch tensors or JAX arrays)."""
    r_t_a = [np.asarray(v, np.float64).sum() / n for v in (fu, fd, ac)]
    return np.array(r_t_a), np.asarray(az, np.float64) / n


def assert_within_sigma(a, n_a, b, n_b, name):
    """Every entry of the means a (over n_a photons) and b (n_b) within
    Z_LIMIT combined sigma, each sigma bounded by sqrt(m (1 - m) / n)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    var = (np.clip(a * (1 - a), 0, None) / n_a
           + np.clip(b * (1 - b), 0, None) / n_b)
    z = np.abs(a - b) / np.sqrt(np.maximum(var, 1e-30))
    assert (z < Z_LIMIT).all(), (name, float(z.max()), a, b)


# ---------------------------------------------------------------------------
# The slot rule and the step cap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_photons,resident,rows", [
    (1 << 20, 135_168, 1056),   # 4 blocks of 256 on 132 SMs
    (1 << 17, 135_168, 1024),   # capped by the batch's photons
    (1000, 135_168, 8),         # photons rounded up to whole rows
    (1, 135_168, 1),
    (1 << 20, 67_584, 528),     # 2 blocks an SM
    (1 << 20, 100, 1),          # never less than one row
    (1 << 20, rk.PLAIN_SLOTS, 512),
])
def test_slot_rule_takes_the_resident_rows_capped_by_the_photons(
        n_photons, resident, rows):
    assert rk.refill_rows(n_photons, resident) == rows
    cfg, ppl = rk.RefillSchedule(20_000).geometry(n_photons, resident)
    assert cfg.rows == rows and cfg.steps_per_call == rk.REFILL_STEPS
    assert ppl == -(-n_photons // (rows * 128))
    assert cfg.n_lanes * ppl >= n_photons > cfg.n_lanes * (ppl - 1)


@pytest.mark.parametrize("max_steps,k_steps,cap", [
    (20_000, 4096, 20_480), (4096, 4096, 4096), (1, 4096, 4096),
    (400_000, 4096, 401_408), (200, 64, 256), (1_600_000, 8192, 1_605_632),
])
def test_step_cap_rounds_up_to_whole_launches(max_steps, k_steps, cap):
    cfg, _ = rk.RefillSchedule(max_steps, k_steps=k_steps).geometry(
        1 << 20, 135_168)
    assert cfg.max_steps == cap and cfg.max_steps % k_steps == 0


def test_cpu_slots_are_jax_lanes_and_the_default_is_the_refill():
    """Without an occupancy query the plain twins take JAX's 65,536 lanes;
    run_batch_col_tallies and run_batch_sep_tallies run the refill
    schedule unless a geometry is given (JAX's by rk.jax_geometry)."""
    _, td = col_domains(4)
    prm = ck.ColParams.make(td, Surface.lambertian(0.0),
                            illumination.directional(0.5, 0.0), True, 1.0,
                            False)
    asked = []
    cfg, _ = rk.resolve_schedule(rk.RefillSchedule(20_000), 1 << 20, None,
                                 lambda: asked.append(prm), "cpu")
    assert cfg.n_lanes == rk.PLAIN_SLOTS == 65_536 and not asked
    seen = []

    def recording(st, tab, p, seed, step0, k, tally):
        seen.append((st.x.shape[0], step0, k))
        ck.col_launch_plain(st, tab, p, seed, step0, k, tally)

    cfg = KernelConfig(n_lanes=1024, photons_per_lane=2,
                       need_volume_absorption=False)
    t = ck.run_batch_col_tallies(td, Surface.lambertian(0.0),
                                 illumination.directional(0.5, 0.0), 3, cfg,
                                 n_photons=2000, launch=recording)
    assert t.n_photons == 2000 and t.n_bad == 0
    assert seen == [(2048, 0, rk.REFILL_STEPS)]
    assert t.n_steps == rk.REFILL_STEPS
    seen.clear()
    jax_cfg = rk.jax_geometry(cfg)
    assert (jax_cfg.rows, jax_cfg.steps_per_call) == (8, 128)
    t = ck.run_batch_col_tallies(td, Surface.lambertian(0.0),
                                 illumination.directional(0.5, 0.0), 3, cfg,
                                 launch=recording, ccfg=jax_cfg)
    assert t.n_photons == 2048 and {s[:1] + s[2:] for s in seen} == {
        (1024, 128)}
    assert t.n_steps == 128 * len(seen)


OCC = dict(blocks_per_sm=4, threads=256, smem=0, registers=64,
           local_bytes=0, n_sm=132)


@pytest.mark.parametrize("device,resident,n_photons,rows,asks", [
    ("cuda", None, 1 << 20, 1056, 1),  # the occupancy record's slots
    ("cuda", None, 1 << 17, 1024, 1),  # capped by the photons
    ("cuda", 2048, 1 << 20, 16, 0),    # the schedule's own count
    ("cpu", None, 1 << 20, 512, 0),    # no query on the CPU
])
def test_resolve_schedule_takes_slots_from_the_occupancy_query(
        device, resident, n_photons, rows, asks):
    """rk.resolve_schedule asks the kernel's occupancy only for a CUDA
    device and a schedule without a slot count of its own; a launch
    geometry passes through, its photons a lane from the batch."""
    asked = []

    def occupancy():
        asked.append(1)
        return OCC

    sched = rk.RefillSchedule(20_000, resident=resident)
    cfg, ppl = rk.resolve_schedule(sched, n_photons, None, occupancy,
                                   device)
    assert (cfg.rows, len(asked)) == (rows, asks)
    assert cfg.steps_per_call == rk.REFILL_STEPS
    assert cfg.n_lanes * ppl >= n_photons
    geo = rk.RecordConfig(rows=8, max_steps=1000)
    assert rk.resolve_schedule(geo, 2000, None, occupancy, device) == (
        geo, 2)
    assert rk.resolve_schedule(geo, 2000, 5, occupancy, device) == (geo, 5)
    assert len(asked) == asks
    with pytest.raises(ValueError):
        rk.resolve_schedule(sched, None, None, occupancy, device)


@pytest.mark.parametrize("ccfg", ["jax", "refill", "geometry_without"])
def test_the_3d_field_follows_need_volume_absorption(ccfg):
    """run_batch_col_tallies tallies the 3D field when the KernelConfig
    asks for it, on JAX's geometry (rk.jax_geometry carries the flag), on
    the refill schedule and on a geometry made without it; and not when
    the config does not ask."""
    _, td = col_domains(4)
    for vol in (True, False):
        cfg = KernelConfig(n_lanes=1024, photons_per_lane=1,
                           need_volume_absorption=vol)
        geo = {"jax": rk.jax_geometry(cfg),
               "refill": rk.RefillSchedule(cfg.max_steps, resident=SLOTS),
               "geometry_without": rk.RecordConfig(rows=8,
                                                   vol_tally=False)}[ccfg]
        if ccfg == "jax":
            assert geo.vol_tally == vol
        t = ck.run_batch_col_tallies(td, Surface.lambertian(0.2),
                                     illumination.directional(0.5, 0.0), 7,
                                     cfg, ccfg=geo)
        assert t.n_photons == 1024 and t.n_bad == 0
        if not vol:
            assert t.volume_absorption is None
            continue
        assert t.volume_absorption.shape == (16, 16, 8)
        total = float(t.flux_absorbed.sum())
        assert float(t.volume_absorption.sum()) == pytest.approx(
            total, rel=1e-4)


@pytest.mark.parametrize("kernel", ["col", "sep"])
def test_photons_alive_at_the_rounded_cap_are_bad(kernel):
    """A cap of 100 steps in launches of 64 runs two launches (128 steps);
    the photons alive then are n_bad, and the rest of the quota is never
    started."""
    sched = refill(max_steps=100, k_steps=64)
    if kernel == "col":
        _, td = col_domains(4)
        t = ck.run_batch_col(td, Surface.lambertian(0.2),
                             illumination.directional(0.5, 0.0), 5, sched,
                             n_photons=1 << 14)
    else:
        _, td = sep_domains()
        t = sk.run_batch_sep(td, Surface.lambertian(0.05),
                             illumination.emission_separable(td, 288.0,
                                                             0.95),
                             5, sched, n_photons=1 << 14, lw_mode=True)
    assert t.n_steps == 128
    assert t.n_bad > 0
    assert t.n_lane_steps <= SLOTS * 128


# ---------------------------------------------------------------------------
# K3 on the refill schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", sorted(SOURCES))
def test_k3_energy_balance_without_roulette(source):
    """Eight photons a slot, one launch: every started weight is
    accounted for, R + (1 - rho) T + A == 1 to float32 rounding, and the
    profile and the 3D field sum to the column absorption."""
    rho = 0.2
    _, td = col_domains(4)
    t = ck.run_batch_col(td, Surface.lambertian(rho), SOURCES[source][0](),
                         11, refill(vol_tally=True), n_photons=N_PHOTONS,
                         use_russian_roulette=False)
    n = t.n_photons
    assert n == N_PHOTONS and t.n_bad == 0
    assert t.n_steps == rk.REFILL_STEPS and t.n_lane_steps > n
    balance = float(t.flux_up.sum() + (1 - rho) * t.flux_down.sum()
                    + t.flux_absorbed.sum()) / n
    assert abs(balance - 1.0) < 2e-4
    total = float(t.flux_absorbed.sum())
    assert float(t.absorption_profile.sum()) == pytest.approx(total,
                                                              rel=1e-5)
    assert float(t.volume_absorption.sum()) == pytest.approx(total,
                                                             rel=1e-5)


@pytest.mark.parametrize("macro_factor,analytic,source", [
    (4, True, "directional"), (0, False, "flux"),
    (4, False, "random_azimuth")])
def test_k3_matches_jax_geometry(macro_factor, analytic, source):
    """The same scene and 4,096 photons on the refill schedule (256 slots)
    and on JAX's geometry (1,024 lanes, 128 steps): R, T, A and the
    profile within 4.5 combined sigma."""
    _, td = col_domains(macro_factor, analytic)
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=4,
                       need_volume_absorption=False,
                       use_russian_roulette=False)
    runs = [ck.run_batch_col_tallies(td, Surface.lambertian(0.0),
                                     SOURCES[source][0](), 21, cfg,
                                     ccfg=sched)
            for sched in (refill(), rk.jax_geometry(cfg))]
    for t in runs:
        assert t.n_photons == 4096 and t.n_bad == 0
    assert runs[0].n_steps % rk.REFILL_STEPS == 0
    assert runs[1].n_steps % 128 == 0
    (m_a, p_a), (m_b, p_b) = (
        means(t.flux_up, t.flux_down, t.flux_absorbed,
              t.absorption_profile, t.n_photons) for t in runs)
    assert abs(m_a.sum() - 1.0) < 2e-4 and abs(m_b.sum() - 1.0) < 2e-4
    assert_within_sigma(m_a, 4096, m_b, 4096, "R/T/A")
    assert_within_sigma(p_a, 4096, p_b, 4096, "profile")


def test_k3_matches_the_jax_interpret_kernel():
    """The refill schedule's plain twin against the JAX package's column
    kernel in interpret mode (its geometry: 8 rows x 2 photons) on the
    16 x 16 x 8 field: R, T, A and the profile within 4.5 combined
    sigma."""
    jd, td = col_domains(4)
    key = jrng.batch_key(4, 0)
    fu, fd, ac, az, _, n, n_bad, _ = jpc.run_batch_pallas_col(
        jd, JSurface.lambertian(0.0), jill.directional(0.5, 0.0), key,
        jpk.PallasConfig(rows=8, block_rows=8, steps_per_call=32,
                         max_steps=4096, interpret=True),
        2, use_russian_roulette=False, need_vol=False)
    assert int(n) == N_PHOTONS and int(n_bad) == 0
    t = ck.run_batch_col(td, Surface.lambertian(0.0),
                         illumination.directional(0.5, 0.0),
                         folded_seed(key), refill(), n_photons=N_PHOTONS,
                         use_russian_roulette=False)
    assert t.n_photons == N_PHOTONS and t.n_bad == 0
    m_j, p_j = means(fu, fd, ac, az, N_PHOTONS)
    m_t, p_t = means(t.flux_up, t.flux_down, t.flux_absorbed,
                     t.absorption_profile, N_PHOTONS)
    assert_within_sigma(m_t, N_PHOTONS, m_j, N_PHOTONS, "R/T/A")
    assert_within_sigma(p_t, N_PHOTONS, p_j, N_PHOTONS, "profile")


# ---------------------------------------------------------------------------
# K4 on the refill schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", sorted(SOURCES))
def test_k4_energy_balance_without_roulette(source):
    """Eight photons a slot over the 16 x 16 x 150 flagship cut: R +
    (1 - rho) T + A == 1 to float32 rounding, the profile summing to the
    column absorption."""
    rho = 0.05
    _, td = sep_domains()
    t = sk.run_batch_sep(td, Surface.lambertian(rho), SOURCES[source][0](),
                         13, refill(), n_photons=N_PHOTONS,
                         use_russian_roulette=False)
    n = t.n_photons
    assert n == N_PHOTONS and t.n_bad == 0
    assert t.n_steps == rk.REFILL_STEPS and t.n_lane_steps > n
    balance = float(t.flux_up.double().sum()
                    + (1 - rho) * t.flux_down.double().sum()
                    + t.flux_absorbed.double().sum()) / n
    assert abs(balance - 1.0) < 2e-4
    assert float(t.absorption_profile.double().sum()) == pytest.approx(
        float(t.flux_absorbed.double().sum()), rel=1e-5)


def test_k4_lw_energy_identity():
    """The thin all-atmosphere LW scene of
    tests/test_torch_sep_kernel.py::test_lw_energy_identity_on_the_plain_step
    on the refill schedule: every emitted weight leaves the top, is
    absorbed by the surface or in the domain, so sum(up) + 0.95 sum(down)
    == -sum(net absorption) without roulette."""
    grid, comps, temps = lw_flagship_scene(
        nx=16, ny=16, nz=60, cloud_base_level=20, cloud_top_level=35,
        cloud_beta_max=0.3, gas_beta0=0.006, device="cpu")
    dom = build_domain(grid, comps, temps=temps, macro_factor=8,
                       n_cdf_steps=201, lambda_um=10.0,
                       device_fields="compact")
    src = illumination.emission_separable(dom, 288.0, 0.0)
    t = sk.run_batch_sep(dom, Surface.lambertian(0.05), src, 71, refill(),
                         n_photons=N_PHOTONS, use_russian_roulette=False,
                         lw_mode=True)
    n = t.n_photons
    assert n == N_PHOTONS and t.n_bad == 0
    lhs = float(t.flux_up.double().sum() + 0.95 * t.flux_down.double().sum())
    net = -float(t.flux_absorbed.double().sum())
    assert lhs / n == pytest.approx(net / n, abs=1e-5)


@pytest.mark.parametrize("source", ["directional", "flux"])
def test_k4_matches_jax_geometry(source):
    """4,096 photons on the refill schedule (256 slots) and on JAX's
    geometry (1,024 lanes, 128 steps): R, T, A and the profile within 4.5
    combined sigma."""
    _, td = sep_domains()
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=4,
                       need_volume_absorption=False,
                       use_russian_roulette=False)
    runs = [sk.run_batch_sep_tallies(td, Surface.lambertian(0.0),
                                     SOURCES[source][0](), 23, cfg,
                                     scfg=sched)
            for sched in (refill(), rk.jax_geometry(cfg))]
    for t in runs:
        assert t.n_photons == 4096 and t.n_bad == 0
    (m_a, p_a), (m_b, p_b) = (
        means(t.flux_up, t.flux_down, t.flux_absorbed,
              t.absorption_profile, t.n_photons) for t in runs)
    assert_within_sigma(m_a, 4096, m_b, 4096, "R/T/A")
    assert_within_sigma(p_a, 4096, p_b, 4096, "profile")


def test_k4_matches_the_jax_interpret_kernel():
    """The refill schedule's plain twin against the JAX package's
    separable kernel in interpret mode (8 rows x 2 photons) on the 16 x 16
    x 150 flagship cut with a directional beam: R, T, A and the profile
    within 4.5 combined sigma."""
    jd, td = sep_domains()
    key = jrng.batch_key(6, 0)
    fu, fd, ac, az, n, n_bad, _ = jsep.run_batch_pallas_sep(
        jd, JSurface.lambertian(0.0), jill.directional(0.5, 0.0), key,
        jpk.PallasConfig(rows=8, block_rows=8, steps_per_call=32,
                         max_steps=4096, interpret=True),
        2, use_russian_roulette=False, lw_mode=False)
    assert int(n) == N_PHOTONS and int(n_bad) == 0
    t = sk.run_batch_sep(td, Surface.lambertian(0.0),
                         illumination.directional(0.5, 0.0),
                         folded_seed(key), refill(), n_photons=N_PHOTONS,
                         use_russian_roulette=False)
    assert t.n_photons == N_PHOTONS and t.n_bad == 0
    m_j, p_j = means(fu, fd, ac, az, N_PHOTONS)
    m_t, p_t = means(t.flux_up, t.flux_down, t.flux_absorbed,
                     t.absorption_profile, N_PHOTONS)
    assert_within_sigma(m_t, N_PHOTONS, m_j, N_PHOTONS, "R/T/A")
    assert_within_sigma(p_t, N_PHOTONS, p_j, N_PHOTONS, "profile")
