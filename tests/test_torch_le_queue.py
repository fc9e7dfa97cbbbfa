"""The local estimate's event-buffer form.

The CUDA transport kernels (record K2, column K3-d) queue each launch's
local-estimate events in struct-of-arrays buffers (``le.EventQueue``, rows
``QUEUE_FLOATS`` and ``QUEUE_INTS``) and a walk kernel then computes every
(event, direction) pair, in whatever order the queue holds them. The plain
twins, ``col_local_estimate_plain`` and ``local_estimate_plain``, take the
same buffers. On small scenes, from seeded numpy draws: any order of the
events gives the same image up to float32 rounding and exactly the same
walk iterations and cuts; a batch's events walked at once equal its steps'
events walked step by step; and a queue past its capacity raises. No JAX
kernel runs here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import build_domain
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk

torch.set_num_threads(1)

SEED = 0x5EED_1234
N_EVENTS = 300
# Images of one buffer in two orders: float32 sums of the same terms in
# another order, a few hundred terms a pixel at most.
IMAGE_RTOL = 1e-6
MUS8 = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4]
PHIS8 = [15.0, 60.0, 105.0, 150.0, 195.0, 240.0, 285.0, 330.0]
MUS6, PHIS6 = [1.0, 1.0, 0.866, 0.866, 0.5, 0.5], [0, 90, 0, 90, 0, 90]


def _unit_vectors(rs, n):
    mu = rs.uniform(-1.0, 1.0, n)
    phi = rs.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(1.0 - mu * mu)
    return s * np.cos(phi), s * np.sin(phi), mu


def _assert_same_walk(a, b, img_a, img_b, walk_a, walk_b):
    """Equal walk iterations and cuts, images within float32 rounding."""
    assert int(walk_a) == int(walk_b)
    assert int(a.counts[4]) == int(b.counts[4])
    ia, ib = img_a.double(), img_b.double()
    assert float(ia.abs().max()) > 0.0
    assert float((ia - ib).abs().max()) <= IMAGE_RTOL * float(ia.abs().max())


# ---------------------------------------------------------------------------
# The column kernel's buffers (K3-d)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def col_scene():
    """A 12 x 10 x 8 broken cloud (a column template) with the hybrid
    radiance tables, 8 directions in the column kernel's march order."""
    grid, comps, _ = broken_cloud_scene(nx=12, ny=10, nz=8, max_scale=0.01,
                                        dx=100.0, dy=100.0, dz=100.0,
                                        device="cpu")
    dom = build_domain(grid, comps, macro_factor=4, n_cdf_steps=201,
                       compute_intensity_tables=True, hybrid_width_deg=10.0)
    assert dom.col_template
    dirs = le.make_intensity_directions(MUS8, PHIS8, device="cpu")
    dirs = dirs[:, list(ck.col_dir_order(dom, dirs))]
    return dom, dirs


def _col_setup(col_scene, rr, tight=False):
    dom, dirs = col_scene
    icfg = le.IntensityConfig(n_dirs=8, use_russian_roulette=rr,
                              pallas_min_mu=0.4)
    prm = ck.ColParams.make(dom, Surface.lambertian(0.2),
                            illumination.directional(0.5, 30.0), True, 1.0,
                            False, icfg, dirs)
    if tight:  # a bound that cuts the slanted walks
        prm = dataclasses.replace(prm, k_walk=max(2, prm.k_walk // 4))
    return prm, ck.ColTables.from_domain(dom, icfg, dirs)


def _col_events(prm, seed=3):
    """N_EVENTS events in the column queue's layout, from numpy: points
    inside the domain (reflections on the surface), weights, incoming
    directions, lanes and step counters."""
    rs = np.random.RandomState(seed)
    n = N_EVENTS
    refl = rs.rand(n) < 0.3
    z = rs.uniform(prm[ck.C_Z0], prm[ck.C_ZMAX], n)
    z[refl] = prm[ck.C_ZBOT]
    ux, uy, uz = _unit_vectors(rs, n)
    f = np.stack([prm[ck.C_X0] + rs.uniform(0, prm[ck.C_LX], n),
                  prm[ck.C_Y0] + rs.uniform(0, prm[ck.C_LY], n), z,
                  rs.uniform(0.05, 1.0, n), ux, uy, uz])
    i = np.stack([rs.randint(0, 4096, n), rs.randint(0, 20_000, n), refl])
    assert f.shape[0] == len(ck.QUEUE_FLOATS)
    assert i.shape[0] == len(ck.QUEUE_INTS)
    return (torch.from_numpy(f.astype(np.float32)),
            torch.from_numpy(i.astype(np.int32)))


def _col_walk(prm, tab, f, i, seed=SEED):
    tally = ck.ColTally.zeros(prm, "cpu")
    ck.col_local_estimate_plain(tab, prm, seed, f, i, tally)
    return tally


@pytest.mark.parametrize("rr", [True, False])
@pytest.mark.parametrize("tight", [False, True])
def test_column_buffer_order_does_not_matter(col_scene, rr, tight):
    """The column twin on one buffer in its order, shuffled and reversed:
    equal walk iterations and cuts, the same image."""
    prm, tab = _col_setup(col_scene, rr, tight)
    f, i = _col_events(prm)
    base = _col_walk(prm, tab, f, i)
    assert int(base.walk) >= N_EVENTS * prm.n_dirs
    assert (int(base.counts[4]) > 0) == tight
    for perm in (torch.from_numpy(np.random.RandomState(9).permutation(
            N_EVENTS)), torch.arange(N_EVENTS - 1, -1, -1)):
        other = _col_walk(prm, tab, f[:, perm], i[:, perm])
        _assert_same_walk(base, other, base.img, other.img, base.walk,
                          other.walk)


def test_column_buffer_split_equals_whole(col_scene):
    """A buffer walked in two parts (two launches' queues) adds up to the
    buffer walked at once."""
    prm, tab = _col_setup(col_scene, True)
    f, i = _col_events(prm, seed=4)
    whole = _col_walk(prm, tab, f, i)
    parts = ck.ColTally.zeros(prm, "cpu")
    for sl in (slice(0, 111), slice(111, N_EVENTS)):
        ck.col_local_estimate_plain(tab, prm, SEED, f[:, sl], i[:, sl],
                                    parts)
    _assert_same_walk(whole, parts, whole.img, parts.img, whole.walk,
                      parts.walk)


def test_column_batch_events_walked_at_once(col_scene, monkeypatch):
    """A plain radiance batch on the column template, its steps' event
    buffers captured: walked together in one call, in reverse, they give
    the batch's image, walk iterations and cuts, and their columns are the
    batch's events."""
    dom, dirs = col_scene
    icfg = le.IntensityConfig(n_dirs=8, pallas_min_mu=0.4)
    seen = []
    walk = ck.col_local_estimate_plain

    def capture(tab, prm, seed, f, i, tally):
        seen.append((tab, prm, seed, f, i, tally))
        walk(tab, prm, seed, f, i, tally)

    monkeypatch.setattr(ck, "col_local_estimate_plain", capture)
    t = ck.run_batch_col(dom, Surface.lambertian(0.2),
                         illumination.directional(0.5, 30.0),
                         rng.batch_seed(5, 0),
                         rk.RecordConfig(rows=1, steps_per_call=32,
                                         max_steps=4096), 2,
                         intensity_config=icfg, intensity_dirs=dirs)
    tab, prm, seed, _, _, tally = seen[0]
    assert all(s[5] is tally for s in seen)
    f = torch.cat([s[3] for s in seen], dim=1).flip(1)
    i = torch.cat([s[4] for s in seen], dim=1).flip(1)
    assert f.shape[1] == t.n_le_events > len(seen)
    once = _col_walk(prm, tab, f, i, seed)
    _assert_same_walk(tally, once, tally.img, once.img, t.n_walk, once.walk)


# ---------------------------------------------------------------------------
# The record kernel's buffers (K2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_cloud():
    return make_step_cloud(ssa=0.99, macro_factor=8, n_cdf_steps=201,
                           compute_intensity_tables=True,
                           hybrid_width_deg=7.0, device="cpu")


def _rec_setup(dom, **kw):
    icfg = le.IntensityConfig(n_dirs=6, **kw)
    dirs = le.make_intensity_directions(MUS6, PHIS6, device="cpu")
    prm = rk.RecordParams.make(dom, Surface.lambertian(0.2),
                               illumination.directional(0.5, 0.0), True, 1.0,
                               False, icfg, dirs)
    return prm, rk.RecordTables.from_domain(dom, icfg, dirs)


def _rec_events(prm, seed=5):
    """N_EVENTS events in the record queue's layout: scatters (with the
    phase field: HG g or table row 0), surface reflections and atmospheric
    emissions, their capped-excess slots, lanes and step counters."""
    rs = np.random.RandomState(seed)
    n = N_EVENTS
    kind = rs.choice([rk.EV_SCATTER, rk.EV_LAMBERT, rk.EV_ISOTROPIC], n,
                     p=[0.6, 0.25, 0.15])
    z = rs.uniform(prm[rk.P_Z0], prm[rk.P_ZMAX], n)
    z[kind == rk.EV_LAMBERT] = prm[rk.P_ZBOT]
    ux, uy, uz = _unit_vectors(rs, n)
    f2 = np.full(n, 0.85 if prm.le_phase == rk.PHASE_HG else 0.0)
    f = np.stack([prm[rk.P_X0] + rs.uniform(0, prm[rk.P_LX], n),
                  prm[rk.P_Y0] + rs.uniform(0, prm[rk.P_LY], n), z,
                  rs.uniform(0.05, 1.0, n), ux, uy, uz, f2])
    slot = np.where(kind == rk.EV_SCATTER, 1, 0)
    i = np.stack([rs.randint(0, 4096, n), rs.randint(0, 20_000, n), kind,
                  slot])
    assert f.shape[0] == len(rk.QUEUE_FLOATS)
    assert i.shape[0] == len(rk.QUEUE_INTS)
    return (torch.from_numpy(f.astype(np.float32)),
            torch.from_numpy(i.astype(np.int32)))


def _rec_walk(prm, tab, f, i, seed=SEED):
    tally = rk.RecordTally.zeros(prm, "cpu")
    rk.local_estimate_plain(tab, prm, seed, f, i, tally)
    return tally


RECORD_CASES = {
    "hg_exact": dict(use_russian_roulette=False, use_hybrid_phase=False),
    "table_roulette": dict(use_russian_roulette=True, use_hybrid_phase=True),
    "cap": dict(use_russian_roulette=False, use_hybrid_phase=True,
                limit_contributions=True, max_contribution=0.05),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_buffer_order_does_not_matter(step_cloud, case):
    """The record twin on one buffer in its order and shuffled: equal
    march iterations and cuts, the same image and capped excess."""
    prm, tab = _rec_setup(step_cloud, **RECORD_CASES[case])
    f, i = _rec_events(prm)
    base = _rec_walk(prm, tab, f, i)
    assert int(base.march) >= N_EVENTS * prm.n_dirs
    perm = torch.from_numpy(np.random.RandomState(9).permutation(N_EVENTS))
    other = _rec_walk(prm, tab, f[:, perm], i[:, perm])
    _assert_same_walk(base, other, base.img, other.img, base.march,
                      other.march)
    if prm.le_cap:  # the cap clips, into the slots' excess
        assert float(base.exc.sum()) > 0.0
        torch.testing.assert_close(base.exc, other.exc, rtol=IMAGE_RTOL,
                                   atol=0.0)


def test_record_batch_events_walked_at_once(step_cloud, monkeypatch):
    """A plain radiance batch on the step cloud, its steps' event buffers
    captured: walked together in one call, shuffled, they give the batch's
    image, march iterations and cuts; every buffer holds its own step's
    counter."""
    prm, _ = _rec_setup(step_cloud)
    seen = []
    walk = rk.local_estimate_plain

    def capture(tab, prm, seed, f, i, tally):
        seen.append((tab, prm, seed, f, i, tally))
        walk(tab, prm, seed, f, i, tally)

    monkeypatch.setattr(rk, "local_estimate_plain", capture)
    dirs = le.make_intensity_directions(MUS6, PHIS6, device="cpu")
    t = rk.run_batch_record(step_cloud, Surface.lambertian(0.2),
                            illumination.directional(0.5, 0.0),
                            rng.batch_seed(6, 0),
                            rk.RecordConfig(rows=1, steps_per_call=32,
                                            max_steps=4096,
                                            vol_tally=False), 2,
                            intensity_config=le.IntensityConfig(n_dirs=6),
                            intensity_dirs=dirs)
    assert t[4] == 0  # n_bad
    tab, prm, seed, _, _, tally = seen[0]
    for s in seen:  # one step's events share its counter
        assert s[5] is tally and s[4][1].unique().numel() == 1
    f = torch.cat([s[3] for s in seen], dim=1)
    i = torch.cat([s[4] for s in seen], dim=1)
    assert f.shape[1] == int(tally.counts[5])
    perm = torch.from_numpy(np.random.RandomState(2).permutation(
        f.shape[1]))
    once = _rec_walk(prm, tab, f[:, perm], i[:, perm], seed)
    _assert_same_walk(tally, once, tally.img, once.img, tally.march,
                      once.march)


# ---------------------------------------------------------------------------
# The queue itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [ck, rk])
def test_queue_past_its_capacity_raises(kernel):
    """A fill past the capacity (the kernels count every event, stored or
    not) raises on the host; a queue too small for a launch's lanes times
    steps is refused before the launch."""
    n_f, n_i = len(kernel.QUEUE_FLOATS), len(kernel.QUEUE_INTS)
    q = le.EventQueue.empty(n_f, n_i, 16, "cpu")
    q.ctl.copy_(torch.tensor([12, 15], dtype=torch.int32))
    assert q.check() == 15
    f, i = q.queued()
    assert f.shape == (n_f, 12) and i.shape == (n_i, 12)
    q.ctl.copy_(torch.tensor([17, 17], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="not estimated"):
        q.check()
    with pytest.raises(RuntimeError, match="queue of 16"):
        q.queued()
    cpu = torch.device("cpu")
    le.check_queue(q, n_f, n_i, 16, cpu)
    with pytest.raises(ValueError, match="may queue 17"):
        le.check_queue(q, n_f, n_i, 17, cpu)
    with pytest.raises(ValueError, match="event queue"):
        le.check_queue(None, n_f, n_i, 1, cpu)
    with pytest.raises(ValueError, match="queue.f"):
        le.check_queue(q, n_f + 1, n_i, 16, cpu)


def test_tallies_make_no_queue_on_the_cpu(step_cloud):
    """The queue is the CUDA path's: a CPU tally has none, whatever the
    capacity asked for."""
    prm, _ = _rec_setup(step_cloud)
    assert rk.RecordTally.zeros(prm, "cpu", queue_capacity=4096).queue is None


def test_uniform_at_per_event_counters():
    """Uniforms keyed by a per-element step counter (a queued event's)
    equal the per-step draws of make_uniform."""
    lanes = torch.arange(0, 4096, 37, dtype=torch.int64)
    ctrs = (lanes * 7919) % 20_000
    sites = 16 + 2 * (lanes % 64)
    got = rng.uniform_at(lanes, ctrs, sites, SEED)
    want = torch.stack([rng.make_uniform(lanes[k:k + 1], SEED)(
        int(ctrs[k]), int(sites[k]))[0] for k in range(lanes.numel())])
    assert torch.equal(got, want)
