"""PyTorch port: the tiled dense-domain kernel (K5).

The plain PyTorch pass (what ``tile_pass`` runs on the CPU) and the pass
loop around it against the JAX tiled kernel in Pallas interpret mode; the
planner, the envelope and the per-cell fields against the JAX package's;
the dense scene and the spotlight source against the JAX package's; whole
runs against the JAX XLA wave kernel and the JAX tiled kernel; the quota,
the drain floor and the lane-step count; the dispatch against the JAX
package's own choice; and a dense domain file through the port's command
line. The CUDA kernel is held against the plain pass on the card by
chip_smoke.py (phase 2f).

Parity. Both packages draw the kernel's counter uniforms from the same
folded seed keyed by the packed slot, and the tests feed the port the JAX
package's threefry injection uniforms, so the two sort, pack and transport
the same photons. The JAX kernel's tally is an exact float32 one-hot
product, so per column the two differ only by float32 summation order
(COLUMN_RTOL 1e-5 of the column's value). A photon
whose path parts from the JAX one (XLA's CPU compiler contracts a*b + c
into fused multiply-adds in the interpret-mode kernel; the port rounds the
product) moves at most its own weight, so beyond that tolerance the
tallies may differ by at most 2 x PARTED_SHARE of the photons started
(0.5%); the counts (photons started, passes, n_bad, lane-steps) must be
equal, because one parted photon renumbers the slots of every later pass.
On the scenes and seeds used no photon parts, truncated (4 passes) or
whole.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
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
from mcbrat3d_tpu.scenes.collection import dense_cloud_scene as jdense
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu.transport import pallas_tile as jtile
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain import io_netcdf
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import dense_cloud_scene
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport import sep_kernel as sk
from mcbrat3d_tpu_torch.transport import tile_kernel as tk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMN_RTOL = 1e-5
PARTED_SHARE = 0.005
# tests/test_pallas_tile.py's launch geometry: 2 x 2 x 2 tiles of a
# 16 x 16 x 8 domain, 512-slot cohorts, exact runs (no drain floor)
GEOMETRY = dict(rows_b=4, k_steps=8, skip_iters=3, force_tiles=(8, 8, 4),
                drain_div=1 << 30)
N_POOL = 2048
SOURCES = {
    "directional": (lambda: illumination.directional(0.6, 137.0),
                    lambda: jill.directional(0.6, 137.0)),
    "random_azimuth": (lambda: illumination.random_azimuth(0.5),
                       lambda: jill.random_azimuth(0.5)),
    "flux": (illumination.flux, jill.flux),
    "spotlight": (lambda: illumination.spotlight(0.8, 20.0, 0.3, 0.6),
                  lambda: jill.spotlight(0.8, 20.0, 0.3, 0.6)),
}


def folded_seed(key) -> int:
    """The uint32 seed the JAX tiled launch folds from a key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def dense_fields(nx=16, ny=16, nz=8, seed=5, ssa=0.9, empty_half=False,
                 cell_ssa=False, tabulated=False, ncomp=1):
    """[(beta, ssa, phase)] of tests/test_pallas_tile.py's small dense
    scenes: the one-component field (optionally half empty, per-cell ssa or
    a Mie-class tabulated phase function) or the gas + cloud (+ Rayleigh)
    stack of its multi-component test."""
    rs = np.random.RandomState(seed)
    if ncomp > 1:
        specs = [(0.05, 0.3, 0.0), (0.08, 0.99, 0.85),
                 (0.02, 1.0, 0.1)][:ncomp]
        comps = []
        for b0, sa, g in specs:
            beta = b0 * (0.3 + rs.rand(nx, ny, nz))
            comps.append((beta, np.full_like(beta, sa), g))
        return (nx, ny, nz), comps
    beta = 0.08 * (0.3 + rs.rand(nx, ny, nz))
    zc = (np.arange(nz) + 0.5) / nz
    beta *= np.clip(1.5 * zc, 0.2, 1.0)[None, None, :]
    if empty_half:
        beta[nx // 2:] = 0.0
    ssa_f = (np.clip(ssa - 0.3 * rs.rand(nx, ny, nz), 0.05, 1.0)
             if cell_ssa else np.full_like(beta, ssa))
    return (nx, ny, nz), [(beta, ssa_f, None if tabulated else 0.85)]


def both_domains(shape, comps, dx=12.0, dz=4.0, z_edges=None, **build):
    """(JAX domain, port domain) built from the same arrays (on an
    irregular grid with ``z_edges``)."""
    mix = np.array([0.8 * 0.7 ** (m + 1) + 0.2 * 0.3 ** (m + 1)
                    for m in range(64)])
    out = []
    for grid_cls, comp_cls, pf, pft, fn in (
            (JGrid, JComponent, JPF, JPFT, jbuild),
            (Grid, OpticalComponent, PhaseFunction, PhaseFunctionTable,
             build_domain)):
        on = {"device": "cpu"} if grid_cls is Grid else {}
        grid = (grid_cls.regular(*shape, dx, dx, dz, **on) if z_edges is None
                else grid_cls.from_edges(dx * np.arange(shape[0] + 1),
                                         dx * np.arange(shape[1] + 1),
                                         z_edges, **on))
        cs = [comp_cls(f"c{i}", beta, ssa, np.zeros(beta.shape, np.int32),
                       pft([pf(coefficients=mix) if g is None
                            else pf.henyey_greenstein(g, 64)], key=[1.0]))
              for i, (beta, ssa, g) in enumerate(comps)]
        out.append(fn(grid, cs, **{"macro_factor": 0, "n_cdf_steps": 201,
                                   **build}))
    return tuple(out)


# ---------------------------------------------------------------------------
# The scene, the source, the planner, the envelope and the fields
# ---------------------------------------------------------------------------

def test_dense_cloud_scene_matches_jax():
    grid, comps, temps = dense_cloud_scene(48, 40, 24, device="cpu")
    jgrid, jcomps, jtemps = jdense(48, 40, 24)
    assert temps is None and jtemps is None
    for a, b in zip(grid.edges_np(), jgrid.edges_np()):
        np.testing.assert_array_equal(a, b)
    for f in ("extinction", "single_scattering_albedo",
              "phase_function_index"):
        np.testing.assert_array_equal(getattr(comps[0], f),
                                      getattr(jcomps[0], f))
    np.testing.assert_array_equal(
        comps[0].phase_function_table.phase_functions[0].coefficients,
        jcomps[0].phase_function_table.phase_functions[0].coefficients)


def test_spotlight_source():
    """The spotlight carries the JAX package's float32 values; the column
    and separable kernels reject it by name, the record and tiled kernels
    take it, as in the JAX package."""
    src = illumination.spotlight(0.8, 20.0, 0.3, 0.6)
    jsrc = jill.spotlight(0.8, 20.0, 0.3, 0.6)
    for f in ("solar_mu", "solar_azimuth", "solar_x", "solar_y"):
        assert np.float32(getattr(src, f)) == np.float32(getattr(jsrc, f)), f
    with pytest.raises(ValueError, match="spotlight"):
        illumination.spotlight(0.8, 0.0, 0.0, 0.5)
    _, td = both_domains(*dense_fields())
    sfc = Surface.lambertian(0.2)
    args = dict(lw_mode=False, compute_intensity=False,
                record_scattering_orders=0, use_ray_tracing=False)
    assert rk.ineligibility_reasons(td, sfc, src, **args) == []
    for fn in (ck.col_ineligibility_reasons, sk.sep_ineligibility_reasons):
        assert any("spotlight" in r for r in fn(
            td, sfc, src, need_volume_absorption=False, **args))
    assert tk.tile_ineligibility_reasons(
        td, sfc, src, need_volume_absorption=False, **args) == []


PLAN_SHAPES = [
    ((128, 128, 64), 30.0, 20.0),   # the bench's scene
    ((64, 64, 32), 30.0, 20.0),
    ((16, 16, 8), 12.0, 4.0),
    ((40, 40, 24), 12.0, 4.0),
    ((32, 32, 18), 12.0, 4.0),
    ((97, 89, 13), 1.0, 1.0),       # primes
    ((131, 1, 257), 1.0, 1.0),      # primes, no plan
    ((128, 128, 64), 100.0, 5.0),   # anisotropic cells
    ((96, 48, 60), 0.5, 0.04),
    ((325, 325, 150), 0.1, 0.04),   # the LW flagship's grid
    ((256, 256, 64), 30.0, 20.0),   # more than 127 full tiles
]


@pytest.mark.parametrize("shape,dx,dz", PLAN_SHAPES)
def test_plan_tiles_matches_jax(shape, dx, dz):
    """The planner picks the JAX package's plan for every field count (the
    cell cap of plan_for: n_f * rows <= 1024)."""
    grid = Grid.regular(*shape, dx, dx, dz, device="cpu")
    jgrid = JGrid.regular(*shape, dx, dx, dz)
    for n_f in range(1, 7):
        rows = max(8, (1024 // n_f) // 8 * 8)
        cap = min(tk.TILE_CELLS_MAX, rows * 128)
        assert tk.plan_tiles(grid, cap) == jtile.plan_tiles(jgrid, cap), n_f


@pytest.mark.parametrize("kw", [
    {}, dict(cell_ssa=True), dict(tabulated=True), dict(ncomp=2),
    dict(ncomp=3), dict(nx=40, ny=40, nz=24, cell_ssa=True)],
    ids=["hg", "cell-ssa", "tabulated", "2-comp", "3-comp", "40x40x24"])
def test_fields_and_plan_match_jax(kw):
    """tile_fields, plan_for, the tile majorants and the per-cell fields
    equal the JAX package's _pack_tile_table after un-tiling its slabs."""
    jd, td = both_domains(*dense_fields(**kw))
    assert tk.tile_fields(td) == jtile.tile_fields(jd)
    plan = tk.plan_for(td)
    assert plan == jtile.plan_for(jd)
    nx, ny, nz = td.grid.shape
    for tiles in (plan, (8, 8, 4)) if nx == 16 else (plan,):
        tx, ty, tz = tiles
        ntx, nty, ntz = nx // tx, ny // ty, nz // tz
        n_tiles, t_cells = ntx * nty * ntz, tx * ty * tz
        tab, majs, _, t_rows = jtile._pack_tile_table(jd, tx, ty, tz)
        n_f = tk.tile_fields(td)[0]
        slabs = np.asarray(tab)[:n_tiles].reshape(n_tiles, n_f, -1)
        fields = slabs[:, :, :t_cells].reshape(
            ntx, nty, ntz, n_f, tx, ty, tz).transpose(3, 0, 4, 1, 5, 2, 6)
        got = tk.TileFields.of(td, tiles)
        np.testing.assert_array_equal(got.fields.numpy(),
                                      fields.reshape(n_f, -1))
        np.testing.assert_array_equal(got.majs.numpy(), np.asarray(majs))
        assert got.majs[-1] == 0.0


def _ineligibility_case(case):
    """(JAX args, port args) of one configuration for the envelope."""
    fkw, bkw = {}, {}
    if case == "no tile plan":
        rs = np.random.RandomState(1)
        beta = 0.01 + 0.01 * rs.rand(1, 1, 32771)
        shape_comps = ((1, 1, 32771), [(beta, np.full_like(beta, 0.9),
                                        0.85)])
    elif case == "4 components":
        shape, comps = dense_fields(ncomp=3)
        shape_comps = (shape, comps + [comps[0]])
    else:
        if case == "oversize table":
            fkw, bkw = dict(tabulated=True), dict(n_cdf_steps=140001)
        if case == "irregular grid":
            bkw = dict(z_edges=np.cumsum(np.r_[0.0, np.linspace(2, 6, 8)]))
        shape_comps = dense_fields(**fkw)
    jd, td = both_domains(*shape_comps, **bkw)
    flags = dict(lw_mode=False, compute_intensity=False,
                 record_scattering_orders=0, use_ray_tracing=False,
                 need_volume_absorption=False, need_absorption_profile=False)
    if case in flags:
        flags[case] = 1 if case == "record_scattering_orders" else True
    src, jsrc = illumination.directional(0.5, 0.0), jill.directional(0.5,
                                                                      0.0)
    sfc, jsfc = Surface.lambertian(0.2), JSurface.lambertian(0.2)
    if case == "emission":
        src = illumination.Source(kind=illumination.EMISSION)
        jsrc = dataclasses.replace(jsrc, kind=jill.EMISSION)
    if case == "per-pixel surface":
        sfc = Surface(params=np.full((2, 2, 1), 0.2, np.float32))
        jsfc = JSurface(params=np.full((2, 2, 1), 0.2, np.float32))
    return (jd, jsfc, jsrc, flags), (td, sfc, src, flags)


@pytest.mark.parametrize("case", [
    "none", "lw_mode", "compute_intensity", "record_scattering_orders",
    "use_ray_tracing", "need_volume_absorption", "need_absorption_profile",
    "emission", "per-pixel surface", "irregular grid", "4 components",
    "oversize table", "no tile plan"])
def test_ineligibility_reasons_match_jax(case):
    (jd, jsfc, jsrc, flags), (td, sfc, src, _) = _ineligibility_case(case)
    want = jtile.tile_ineligibility_reasons(jd, jsfc, jsrc, **flags)
    got = tk.tile_ineligibility_reasons(td, sfc, src, **flags)
    assert got == want
    assert (case == "none") == (got == [])
    assert tk.tile_eligible(td, sfc, src, **flags) == (got == [])


# ---------------------------------------------------------------------------
# The plain pass and the pass loop against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

def assert_columns(port, ref, n_started, name):
    port = port.numpy().astype(np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    excess = np.maximum(np.abs(port - ref) - COLUMN_RTOL * np.abs(ref), 0.0)
    assert excess.sum() <= 2.0 * PARTED_SHARE * n_started, (
        name, int((excess > 0).sum()), float(excess.sum()))


def run_both(kw, source, use_rr, max_passes, n_photons=6000, seed=3):
    """The JAX tiled kernel (interpret mode) and the port's pass loop on
    the plain pass, same seed, cohorts and injection uniforms."""
    jd, td = both_domains(*dense_fields(**kw))
    tsrc, jsrc = SOURCES[source]
    key = jrng.batch_key(seed, 0)
    fu, fd, ab, n, n_bad, n_passes, steps = jtile.run_batch_pallas_tile(
        jd, JSurface.lambertian(0.2), jsrc(), key,
        jtile.TileConfig(interpret=True, max_passes=max_passes, **GEOMETRY),
        N_POOL, n_photons, use_russian_roulette=use_rr)

    def inject(pass_i, n_pad):
        us = jax.random.uniform(jax.random.fold_in(key, pass_i), (n_pad, 4),
                                jnp.float32)
        return torch.from_numpy(np.asarray(us).T.copy())

    run = tk.run_batch_tile(
        td, Surface.lambertian(0.2), tsrc(), folded_seed(key),
        tk.TileConfig(max_passes=max_passes, **GEOMETRY), N_POOL, n_photons,
        use_russian_roulette=use_rr, launch=tk.tile_pass_plain,
        inject=inject)
    return (fu, fd, ab, int(n), int(n_bad), int(n_passes), float(steps)), run


@pytest.mark.parametrize("kw,source,use_rr,max_passes", [
    ({}, "directional", True, 4),
    (dict(empty_half=True), "directional", True, 4),
    (dict(cell_ssa=True), "random_azimuth", True, 4),
    (dict(tabulated=True), "flux", True, 4),
    (dict(ncomp=2), "spotlight", True, 4),
    (dict(ncomp=3), "directional", False, 4),
    ({}, "directional", True, 8192),
], ids=["hg", "empty-half-skip-chain", "cell-ssa-random-azimuth",
        "tabulated-flux", "2-comp-spotlight", "3-comp-no-roulette",
        "hg-whole-run"])
def test_plain_pass_matches_jax_interpret_kernel(kw, source, use_rr,
                                                 max_passes):
    (fu, fd, ab, n, n_bad, n_passes, steps), run = run_both(
        kw, source, use_rr, max_passes)
    assert (run.n_started, run.n_passes, run.n_bad) == (n, n_passes, n_bad)
    assert run.lane_steps == steps
    if max_passes < 8192:  # truncated: photons are left alive
        assert n_passes == max_passes and n_bad > 0
    else:
        assert n == 6000 and n_bad == 0
    assert_columns(run.flux_up, fu, n, "flux_up")
    assert_columns(run.flux_down, fd, n, "flux_down")
    assert_columns(run.flux_absorbed, ab, n, "flux_absorbed")


# ---------------------------------------------------------------------------
# Whole runs, statistically, and invariants of the pass loop
# ---------------------------------------------------------------------------

def _per_photon(t, n):
    return tuple(float(np.asarray(a, np.float64).sum()) / n
                 for a in (t[0], t[1], t[2]))


@pytest.fixture(scope="module")
def jax_whole_runs():
    """The dense test scene (ssa 0.95) in both packages and its R, T, A
    per photon from the JAX XLA wave kernel and the JAX tiled kernel
    (interpret mode), each with its photon count: one compile for the
    whole-run tests."""
    jd, td = both_domains(*dense_fields(ssa=0.95))
    jsfc, jsrc = JSurface.lambertian(0.2), SOURCES["directional"][1]
    xla = jintegrator.run_batch(
        jd, jsfc, jsrc(), jrng.batch_key(9, 0),
        jintegrator.KernelConfig(n_lanes=1 << 11, photons_per_lane=4,
                                 max_steps=20000, tail_compaction=False,
                                 use_pallas="off",
                                 need_volume_absorption=False))
    out = jtile.run_batch_pallas_tile(
        jd, jsfc, jsrc(), jrng.batch_key(5, 1),
        jtile.TileConfig(interpret=True, **GEOMETRY), N_POOL, 8000)
    refs = [("xla", _per_photon((xla.flux_up, xla.flux_down,
                                 xla.flux_absorbed), int(xla.n_photons)),
             int(xla.n_photons)),
            ("tile", _per_photon(out[:3], int(out[3])), int(out[3]))]
    return td, refs


def _assert_matches_jax(port, refs):
    """R, T and A of a port run within 4.5 combined sigma of each JAX run
    (the per-photon tallies are at most ~1.25, so mean / n bounds their
    variance / n)."""
    n_t = port.n_started
    got = _per_photon((port.flux_up, port.flux_down, port.flux_absorbed),
                      n_t)
    for name, want, n in refs:
        for a, b, what in zip(got, want, "RTA"):
            sigma = np.sqrt(a / n_t + b / n)
            assert abs(a - b) < 4.5 * sigma, (name, what, a, b, sigma)


def test_whole_run_matches_jax_statistically(jax_whole_runs):
    """The port's own sorted run (its injection stream, drained to empty)
    against the JAX XLA wave kernel and the JAX tiled kernel on other
    seeds: R, T and A within 4.5 combined sigma."""
    td, refs = jax_whole_runs
    port = tk.run_batch_tile(td, Surface.lambertian(0.2),
                             SOURCES["directional"][0](), 77,
                             tk.TileConfig(**{**GEOMETRY, "drain_div": 0}),
                             N_POOL, 8000)
    assert port.n_started == 8000 and port.n_bad == 0
    _assert_matches_jax(port, refs)


def test_refill_whole_run_matches_jax_statistically(jax_whole_runs):
    """The refill schedule (the plain twin of the kernel's refill mode
    under relaunch_loop, REFILL_STEPS a launch, on the 2 x 2 x 2 tiles)
    against the same JAX runs: every photon started and finished, R, T and
    A within 4.5 combined sigma."""
    td, refs = jax_whole_runs
    port = tk.run_batch_tile(
        td, Surface.lambertian(0.2), SOURCES["directional"][0](), 78,
        tk.TileConfig(refill=True, k_steps=tk.REFILL_STEPS, skip_iters=3,
                      force_tiles=(8, 8, 4), max_passes=160), N_POOL, 8000)
    assert port.n_started == 8000 and port.n_bad == 0 and port.n_tail == 0
    assert 0 < port.n_passes < 160
    _assert_matches_jax(port, refs)


@pytest.fixture(scope="module")
def dense():
    return both_domains(*dense_fields(ssa=0.999))[1]


def test_quota_drain_floor_and_lane_steps(dense):
    """Exactly n_photons start; a drain floor of pool / drain_div stops the
    loop with at most that many photons alive, counted in n_bad; with one
    step per pass the lane-steps are the photons alive at each pass's
    start."""
    sfc, src = Surface.lambertian(0.5), illumination.directional(0.5, 0.0)
    run = tk.run_batch_tile(dense, sfc, illumination.flux(), 4,
                            tk.TileConfig(**GEOMETRY), N_POOL, 1234)
    assert run.n_started == 1234 and run.n_bad == 0
    cuts = {drain_div: tk.run_batch_tile(
        dense, sfc, src, 6,
        tk.TileConfig(**{**GEOMETRY, "drain_div": drain_div}), 1024, 4096)
        for drain_div in (2, 64)}
    for drain_div, cut in cuts.items():
        assert cut.n_started == 4096
        assert cut.n_bad <= 1024 // drain_div
    assert cuts[2].n_bad > 0  # stragglers cut at the floor
    live = []

    def counting(pool, *args, **kwargs):
        live.append(int((pool.tile < 8).sum()))
        tk.tile_pass_plain(pool, *args, **kwargs)

    one = tk.run_batch_tile(
        dense, sfc, src, 8, tk.TileConfig(**{**GEOMETRY, "k_steps": 1}),
        N_POOL, 1500, launch=counting)
    assert one.n_started == 1500 and one.n_bad == 0
    assert one.lane_steps == sum(live) and one.n_passes == len(live)


def test_tail_drains_the_pool(dense):
    """Past a drain floor of half the pool, the tail (passes in which each
    photon follows its path across tiles) finishes every photon: n_bad 0
    and, without roulette, every started weight tallied; without the tail
    the floor leaves photons alive."""
    sfc, src = Surface.lambertian(0.3), illumination.directional(0.5, 0.0)
    floor = {**GEOMETRY, "drain_div": 2}
    cut = tk.run_batch_tile(dense, sfc, src, 6, tk.TileConfig(**floor),
                            1024, 4096, use_russian_roulette=False)
    assert cut.n_bad > 0 and cut.n_tail == 0
    run = tk.run_batch_tile(
        dense, sfc, src, 6,
        tk.TileConfig(**floor, tail_steps=64, tail_passes=200), 1024, 4096,
        use_russian_roulette=False)
    assert run.n_started == 4096 and run.n_bad == 0 and run.n_tail > 0
    # the sorted passes are the same: the tail starts where they stopped
    assert run.n_passes - run.n_tail == cut.n_passes
    balance = (float(run.flux_up.double().sum())
               + 0.7 * float(run.flux_down.double().sum())
               + float(run.flux_absorbed.double().sum())) / run.n_started
    assert abs(balance - 1.0) < 2e-4, balance


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_energy_balance_without_roulette(dense, source):
    """Every started weight is accounted for: with surface albedo rho,
    R + (1 - rho) T + A == 1 to float32 rounding."""
    rho = 0.3
    run = tk.run_batch_tile(dense, Surface.lambertian(rho),
                            SOURCES[source][0](), 2,
                            tk.TileConfig(**{**GEOMETRY, "drain_div": 0}),
                            N_POOL, 3000, use_russian_roulette=False)
    assert run.n_started == 3000 and run.n_bad == 0
    balance = (float(run.flux_up.double().sum())
               + (1 - rho) * float(run.flux_down.double().sum())
               + float(run.flux_absorbed.double().sum())) / run.n_started
    assert abs(balance - 1.0) < 2e-4, balance


def test_run_batch_entry_and_determinism(dense):
    """run_batch_tile_tallies (its default: the refill schedule)
    finishes every photon (n_bad 0) and reports the lane-steps and
    launches; one seed gives one result."""
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=2,
                       need_volume_absorption=False, max_steps=20000)
    src = illumination.directional(0.5, 0.0)
    t1, t2 = (tk.run_batch_tile_tallies(dense, Surface.lambertian(0.2), src,
                                        11, cfg)
              for _ in range(2))
    assert t1.n_photons == 2048 and t1.n_bad == 0 and t1.n_passes > 0
    assert t1.n_steps == t1.n_lane_steps > 0
    assert t1.volume_absorption is None
    for a, b in ((t1.flux_up, t2.flux_up), (t1.flux_down, t2.flux_down),
                 (t1.flux_absorbed, t2.flux_absorbed)):
        assert torch.equal(a, b)
    assert (t1.n_steps, t1.n_passes) == (t2.n_steps, t2.n_passes)


def test_wrapper_refuses_other_devices(dense):
    """CPU tensors take the plain pass; a CUDA tensor goes to the kernel
    (checked on the card by chip_smoke.py); anything else raises."""
    tiles = (8, 8, 4)
    prm = tk.TileParams.make(dense, Surface.lambertian(0.2),
                             illumination.directional(0.5, 0.0), tiles,
                             tk.TileConfig(**GEOMETRY), True, 1.0)
    pool = tk.TilePool.empty(128, prm.n_tiles, "meta")
    with pytest.raises(ValueError, match="meta"):
        tk.tile_pass(pool, tk.TileFields.of(dense, tiles), prm, 0, 0, 8,
                     tk.TileTally.zeros(prm, "cpu"))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

class _Picked(Exception):
    pass


def _picker(name):
    def pick(*args, **kwargs):
        raise _Picked(name)
    return pick


def _picks(monkeypatch, shape_comps, source="directional",
           need_volume_absorption=False):
    """(JAX package's kernel, port's kernel) for one domain and source
    (use_pallas="on", the choice taken at trace time, no kernel run)."""
    jd, td = both_domains(*shape_comps, n_cdf_steps=101)
    for mod, fn, name in ((jpk, "run_batch_pallas_tallies", "record"),
                          (jpc, "run_batch_pallas_col_tallies", "column"),
                          (jsep, "run_batch_pallas_sep_tallies", "separable"),
                          (jtile, "run_batch_pallas_tile_tallies", "tiled"),
                          (rk, "run_batch_record_tallies", "record"),
                          (ck, "run_batch_col_tallies", "column"),
                          (sk, "run_batch_sep_tallies", "separable"),
                          (tk, "run_batch_tile_tallies", "tiled")):
        monkeypatch.setattr(mod, fn, _picker(name))
    kw = dict(n_lanes=1024, photons_per_lane=1,
              need_volume_absorption=need_volume_absorption)
    tsrc, jsrc = SOURCES[source]
    with pytest.raises(_Picked) as jax_pick:
        jintegrator.run_batch(jd, JSurface.lambertian(0.2), jsrc(),
                              jrng.batch_key(0, 0),
                              jintegrator.KernelConfig(use_pallas="on", **kw))
    with pytest.raises(_Picked) as port_pick:
        run_batch(td, Surface.lambertian(0.2), tsrc(), 0, KernelConfig(**kw))
    return str(jax_pick.value), str(port_pick.value)


SMALL_DOMAIN_CASES = {
    "2comp-16x16x8": ((16, 16, 8), 2, "directional", False),
    "2comp-16x16x32": ((16, 16, 32), 2, "directional", False),
    "3comp-16x16x8": ((16, 16, 8), 3, "directional", False),
    **{f"{src}-{'3d' if vol else 'columns'}": ((16, 16, 8), 1, src, vol)
       for src in ("random_azimuth", "flux", "spotlight")
       for vol in (False, True)},
}


@pytest.mark.parametrize("case", sorted(SMALL_DOMAIN_CASES))
def test_small_domains_stay_on_the_record_kernel(monkeypatch, case):
    """Small non-template domains with 2-3 components or a random-azimuth,
    flux or spotlight source, with and without the 3D tally: the JAX
    package runs its record kernel, and so must the port (K5 has no lower
    cell bound, so before the record kernel took these they went to K5 or
    raised)."""
    (nx, ny, nz), ncomp, source, vol = SMALL_DOMAIN_CASES[case]
    picks = _picks(monkeypatch, dense_fields(nx, ny, nz, ncomp=ncomp),
                   source, need_volume_absorption=vol)
    assert picks == ("record", "record")


@pytest.mark.parametrize("shape", [(40, 40, 24), (32, 32, 18)],
                         ids=["past-max-cells", "record-eligible-mid-size"])
def test_dense_domains_dispatch_to_the_tiled_kernel(monkeypatch, shape):
    """tests/test_pallas_tile.py's two dispatch cases: past the record
    kernel's 36,864 cells, and a record-eligible 18,432-cell domain that
    the tiled kernel takes; both reach K5 in the port as in JAX."""
    nx, ny, nz = shape
    picks = _picks(monkeypatch, dense_fields(nx, ny, nz))
    assert picks == ("tiled", "tiled")


def test_record_eligible_domain_without_a_tile_plan_stays_on_k1(
        monkeypatch):
    """A record-eligible domain of 32,771 cells (1 x 1 x a prime: no tile
    plan) is not taken by the tiled kernel, so the JAX package keeps it on
    the record kernel (integrator.py:455-471), and so must the port."""
    case = _ineligibility_case("no tile plan")[1]
    td = case[0]
    assert not rk.ineligibility_reasons(td, case[1], case[2], False, False,
                                        0, False)
    assert tk.tile_ineligibility_reasons(td, case[1], case[2],
                                         **case[3]) == ["no tile plan"]
    rs = np.random.RandomState(1)
    beta = 0.01 + 0.01 * rs.rand(1, 1, 32771)
    picks = _picks(monkeypatch, ((1, 1, 32771),
                                 [(beta, np.full_like(beta, 0.9), 0.85)]))
    assert picks == ("record", "record")


# ---------------------------------------------------------------------------
# A dense domain file through the command line
# ---------------------------------------------------------------------------

def test_dense_deck_through_the_cli(tmp_path, capsys, monkeypatch):
    """run/dense_cloud_mono.nml, cut to 2 x 512 photons on a 24 x 24 x 32
    cut of the scene, through the port's command line on the CPU: the file
    keeps Legendre moments (the tabulated branch), the domain goes to the
    tiled kernel's plain pass with no other change, and the JSON line
    carries its passes; the means equal a direct run_batch of the same
    batches."""
    grid, comps, _ = dense_cloud_scene(24, 24, 32, device="cpu")
    io_netcdf.write_domain(str(tmp_path / "DenseCloud.dom"), grid, comps,
                           surface_albedo=0.2)
    with open(os.path.join(ROOT, "run", "dense_cloud_mono.nml")) as f:
        deck = (f.read().replace("numPhotonsPerBatch = 2097152",
                                 "numPhotonsPerBatch = 512")
                .replace("numBatches = 16", "numBatches = 2")
                .replace("nLanes = 262144", "nLanes = 512"))
    (tmp_path / "deck.nml").write_text(deck)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["total_photons"] == 1024 and out["n_bad"] == 0
    assert out["tile_passes"] > 0 and out["launches"]["tile_kernel"] == 0
    assert sorted(out["outputs"]) == ["dense_flux.out", "dense_results.nc"]

    from mcbrat3d_tpu_torch.core import rng
    from mcbrat3d_tpu_torch.driver.config import load_config
    from mcbrat3d_tpu_torch.driver.run import kernel_config_from
    cfg = load_config("deck.nml")
    g2, c2, _, attrs = io_netcdf.read_domain("DenseCloud.dom", device="cpu")
    dom = build_domain(g2, c2, n_cdf_steps=cfg.n_phase_intervals,
                       macro_factor=cfg.macro_factor)
    assert not dom.all_hg and attrs["surface_albedo"] == 0.2
    sums, passes = np.zeros(3), 0
    for b in range(2):
        t = run_batch(dom, Surface.lambertian(0.2),
                      illumination.directional(0.5, 0.0),
                      rng.batch_seed(10, b), kernel_config_from(cfg),
                      n_photons=512)
        sums += [float(a.double().sum()) for a in (t.flux_up, t.flux_down,
                                                   t.flux_absorbed)]
        passes += t.n_passes
    assert passes == out["tile_passes"]
    for got, name in zip(sums / 1024, ("up", "down", "absorbed")):
        assert out[f"mean_flux_{name}"] == pytest.approx(got, rel=1e-5)
