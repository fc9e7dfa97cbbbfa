"""PyTorch port: the tiled dense-domain kernel's refill schedule (K5).

The plain twin of the kernel's refill mode (``tile_pass_plain(...,
refill=True)``, what ``tile_pass`` runs on the CPU) under
``record_kernel.relaunch_loop``: the quota, the energy balance on the four
source kinds, determinism, the step cap and ``n_bad``, and the dispatch of
``run_batch`` to this schedule. Its whole run is held against the JAX
package's in ``test_torch_tile_kernel.py``; the CUDA kernel is held against
the twin on the card by chip_smoke.py (phase 2f).
"""

import numpy as np
import pytest
import torch

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent, build_domain
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import tile_kernel as tk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

SOURCES = {
    "directional": lambda: illumination.directional(0.6, 137.0),
    "random_azimuth": lambda: illumination.random_azimuth(0.5),
    "flux": illumination.flux,
    "spotlight": lambda: illumination.spotlight(0.8, 20.0, 0.3, 0.6),
}
# 2 x 2 x 2 tiles of a 16 x 16 x 8 domain, so photons cross tiles
REFILL = dict(refill=True, k_steps=32, skip_iters=3, force_tiles=(8, 8, 4),
              max_passes=400)
N_SLOTS = 512


def dense_domain(nx=16, ny=16, nz=8, ssa=0.999, seed=5):
    """A small dense field (tests/test_pallas_tile.py's one-component
    scene) on the CPU."""
    rs = np.random.RandomState(seed)
    beta = 0.08 * (0.3 + rs.rand(nx, ny, nz))
    zc = (np.arange(nz) + 0.5) / nz
    beta *= np.clip(1.5 * zc, 0.2, 1.0)[None, None, :]
    comp = OpticalComponent(
        "cloud", beta, np.full_like(beta, ssa), np.zeros(beta.shape, np.int32),
        PhaseFunctionTable([PhaseFunction.henyey_greenstein(0.85, 64)],
                           key=[1.0]))
    grid = Grid.regular(nx, ny, nz, 12.0, 12.0, 4.0, device="cpu")
    return build_domain(grid, [comp], macro_factor=0, n_cdf_steps=201)


@pytest.fixture(scope="module")
def dense():
    return dense_domain()


def _balance(run, rho, alive_weight=0.0):
    return (float(run.flux_up.double().sum())
            + (1 - rho) * float(run.flux_down.double().sum())
            + float(run.flux_absorbed.double().sum())
            + alive_weight) / run.n_started


@pytest.mark.parametrize("n_photons", [1234, 300], ids=["more", "fewer"])
def test_refill_starts_exactly_n_photons(dense, n_photons):
    """Exactly n_photons start, more photons than slots or fewer, and
    every one finishes; the lane-steps cover at least one step a photon."""
    run = tk.run_batch_tile(dense, Surface.lambertian(0.2),
                            SOURCES["directional"](), 3,
                            tk.TileConfig(**REFILL), N_SLOTS, n_photons)
    assert run.n_started == n_photons and run.n_bad == 0
    assert run.n_tail == 0 and 0 < run.n_passes < REFILL["max_passes"]
    assert run.lane_steps >= n_photons and run.n_real > 0


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_refill_energy_balance_without_roulette(dense, source):
    """Every started weight is accounted for: with surface albedo rho,
    R + (1 - rho) T + A == 1 to float32 rounding."""
    rho = 0.3
    run = tk.run_batch_tile(dense, Surface.lambertian(rho),
                            SOURCES[source](), 2, tk.TileConfig(**REFILL),
                            N_SLOTS, 2000, use_russian_roulette=False)
    assert run.n_started == 2000 and run.n_bad == 0
    assert abs(_balance(run, rho) - 1.0) < 2e-4


def test_refill_determinism(dense):
    """One seed gives one result, bit for bit; another seed another."""
    def go(seed):
        return tk.run_batch_tile(dense, Surface.lambertian(0.2),
                                 SOURCES["flux"](), seed,
                                 tk.TileConfig(**REFILL), N_SLOTS, 1500)

    a, b, c = go(9), go(9), go(10)
    for f in ("flux_up", "flux_down", "flux_absorbed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.n_started, a.n_passes, a.lane_steps, a.n_real) == (
        b.n_started, b.n_passes, b.lane_steps, b.n_real)
    assert not torch.equal(a.flux_up, c.flux_up)


def test_refill_n_bad_counts_photons_cut_by_the_step_cap(dense):
    """With a cap of 2 launches of 4 steps, n_bad is the photons still
    alive in the pool, the quota left unstarted is not started, and
    without roulette the tallies plus the weight still alive account for
    every started photon."""
    pools = []

    def keep(pool, *args, **kwargs):
        tk.tile_pass(pool, *args, **kwargs)
        pools[:] = [pool]

    run = tk.run_batch_tile(
        dense, Surface.lambertian(0.3), SOURCES["directional"](), 4,
        tk.TileConfig(**{**REFILL, "k_steps": 4, "max_passes": 2}),
        N_SLOTS, 4000, use_russian_roulette=False, launch=keep)
    pool = pools[0]
    alive = pool.tile < 8
    assert run.n_passes == 2 and run.n_bad == int(alive.sum()) > 0
    assert run.n_started + int(pool.quota.sum()) == 4000
    assert run.n_started < 4000
    w_alive = float(pool.st[6][alive].double().sum())
    assert abs(_balance(run, 0.3, w_alive) - 1.0) < 2e-4


def test_run_batch_takes_the_refill_schedule(monkeypatch):
    """run_batch on a dense domain past the record kernel's cells goes to
    the tiled kernel's refill schedule: every launch is a refill launch of
    REFILL_STEPS steps (the plain twin here; tk.TILE_LAUNCHES counts them
    on the card, chip_smoke 3e), their number is the batch's n_passes, and
    every photon finishes."""
    dom = dense_domain(40, 40, 24, ssa=0.99)
    calls = []
    plain = tk.tile_pass_plain

    def counting(pool, fld, prm, seed, step0, k_steps, tally, follow=False,
                 refill=False):
        calls.append((step0, k_steps, refill))
        plain(pool, fld, prm, seed, step0, k_steps, tally, follow, refill)

    monkeypatch.setattr(tk, "tile_pass_plain", counting)
    t = run_batch(dom, Surface.lambertian(0.2), SOURCES["directional"](), 5,
                  KernelConfig(n_lanes=256, photons_per_lane=2,
                               max_steps=20_000,
                               need_volume_absorption=False))
    k = tk.REFILL_STEPS
    assert t.n_photons == 512 and t.n_bad == 0
    assert calls == [(i * k, k, True) for i in range(t.n_passes)]
    assert t.n_steps == t.n_lane_steps > 0 and t.n_real > 0
