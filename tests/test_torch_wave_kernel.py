"""PyTorch port: the XLA wave kernel against the JAX package's, path for path.

The JAX package's ``run_batch(..., use_pallas="off")`` and the port's run
the same batch at the same threefry key on the CPU: the step cloud with a
directional beam and analytic HG (macro majorant), a 4-component domain
with tabulated phase rows, and a 16,384-lane wave whose stragglers are
compacted into 2,048 lanes. The ray-traced, emission and radiance cases
are in ``test_torch_wave_estimator.py``. Every draw equals JAX's bit for
bit (``tests/test_torch_threefry.py``), so the two follow the same photons.

Parted photons. XLA's CPU code evaluates log, cos, sin, arccos and pow
with its own approximations and contracts products into FMAs, so some
values differ from PyTorch's in the last bit; a photon parts where such a
difference straddles a threshold (a cell face, a roulette or null test),
and every later photon of its lane starts on other draws. A lane counts
as parted where its final state differs by more than 1e-2 (relative, in
position, direction or weight) or in its scattering order; at most 0.5%
of the lanes may part (a bound on the parted photons' share). Photon,
step and bad-photon counts are equal; each flux tally's L1 gap is within
1% of its total (a parted photon moves its weight from one bin to
another) and its domain total within 0.2%.
"""

import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.domain import domain as jdomain
from mcbrat3d_tpu.physics import phase_function as jpf
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes import step_cloud as jstep
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import integrator as jint
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain import domain as pdomain
from mcbrat3d_tpu_torch.physics import phase_function as ppf
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.collection import broken_cloud_scene
from mcbrat3d_tpu_torch.scenes import step_cloud as pstep
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import integrator, local_estimate as le

torch.set_num_threads(1)

PARTED_MAX = 5e-3  # share of lanes whose photons parted
L1_GAP = 1e-2  # per-bin L1 gap of a flux tally over its total
TOTAL_GAP = 2e-3  # gap of a flux tally's domain total
STATE_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "w")
FLUX_FIELDS = ("flux_up", "flux_down", "flux_absorbed", "volume_absorption")


def parted_lanes(js: dict, ps: dict) -> float:
    """Share of lanes whose final states differ beyond float drift."""
    bad = np.asarray(js["order"]) != ps["order"].numpy()
    bad |= np.asarray(js["alive"]) != ps["alive"].numpy()
    for f in STATE_FIELDS:
        a, b = np.asarray(js[f]), ps[f].numpy()
        bad |= np.abs(a - b) > 1e-2 * (1.0 + np.abs(a))
    return float(bad.mean())


def compare(jargs, pargs, jcfg, pcfg, seed=7, batch=2, jkw=None, pkw=None,
            fields=FLUX_FIELDS, state=True):
    """Run both packages at JAX's key of (seed, batch); assert equal counts,
    the tally gaps and the parted-lane bound. Returns (JAX, port)
    tallies."""
    jkw, pkw = jkw or {}, pkw or {}
    key = jrng.batch_key(seed, batch)
    pkey = rng.batch_key(seed, batch)
    jt = jint.run_batch(*jargs, key, jcfg, **jkw)
    pt = integrator.run_batch(*pargs, rng.batch_seed(seed, batch), pcfg,
                              key=pkey, **pkw)
    assert (int(jt.n_photons), int(jt.n_steps), int(jt.n_bad)) == (
        pt.n_photons, pt.n_steps, pt.n_bad)
    for f in fields:
        a = np.asarray(getattr(jt, f), np.float64)
        b = getattr(pt, f).numpy().astype(np.float64)
        assert a.shape == b.shape, f
        total = max(np.abs(a).sum(), 1e-6)
        assert np.abs(a - b).sum() <= L1_GAP * total, f
        assert abs(a.sum() - b.sum()) <= TOTAL_GAP * total, f
    if state:
        js = jint.run_batch(*jargs, key, jcfg, debug_state=True, **jkw)
        ps = integrator.run_batch(*pargs, 0, pcfg, key=pkey,
                                  debug_state=True, **pkw)
        assert parted_lanes(js, ps) <= PARTED_MAX
    return jt, pt


def configs(**kw):
    return (jint.KernelConfig(use_pallas="off", **kw),
            integrator.KernelConfig(use_pallas="off", **kw))


def test_step_cloud_directional_hg():
    """The step cloud (macro majorant 8, analytic HG) under a slanted beam
    over a Lambertian surface."""
    jd = jstep.make_step_cloud(ssa=0.99, macro_factor=8)
    pd = pstep.make_step_cloud(ssa=0.99, macro_factor=8, device="cpu")
    jt, pt = compare(
        (jd, JSurface.lambertian(0.2), jill.directional(0.5, 30.0)),
        (pd, Surface.lambertian(0.2), illumination.directional(0.5, 30.0)),
        *configs(n_lanes=4096, photons_per_lane=4))
    assert pt.n_photons == 16384 and pt.n_bad == 0


def four_components(pkg_step, pkg_domain, pkg_pf, device={}):
    """(grid, components) of the step cloud, a uniform gas absorber, a
    Rayleigh scatterer with its true phase function and an aerosol with
    its own 2-row HG table in the lowest 8 layers, built with one
    package's classes from the same arrays."""
    grid, comps, _ = pkg_step.step_cloud_scene(ssa=0.99, **device)
    nz = grid.shape[2]
    zeros = np.zeros((1, 1, nz), np.int32)

    def uniform(name, ext, ssa, phase):
        return pkg_domain.OpticalComponent(
            name=name, extinction=np.full((1, 1, nz), ext),
            single_scattering_albedo=np.full((1, 1, nz), ssa),
            phase_function_index=zeros,
            phase_function_table=pkg_pf.PhaseFunctionTable([phase],
                                                           key=[1.0]))
    ext = np.zeros((1, 1, nz))
    ext[..., :8] = 0.004
    pfi = zeros.copy()
    pfi[..., 4:8] = 1
    aerosol = pkg_domain.OpticalComponent(
        name="aerosol", extinction=ext,
        single_scattering_albedo=np.full((1, 1, nz), 0.9),
        phase_function_index=pfi,
        phase_function_table=pkg_pf.PhaseFunctionTable(
            [pkg_pf.PhaseFunction.henyey_greenstein(0.7, 32),
             pkg_pf.PhaseFunction.henyey_greenstein(0.5, 32)],
            key=[1.0, 2.0]))
    return grid, comps + [
        uniform("gas absorber", 0.002, 0.0,
                pkg_pf.PhaseFunction.isotropic()),
        uniform("rayleigh", 0.001, 1.0, pkg_pf.PhaseFunction.rayleigh()),
        aerosol]


def test_four_components_tabulated():
    """Four components (gas, cloud, tabulated Rayleigh, a 2-row aerosol):
    the component choice over the packed record and the inverse-CDF
    scattering, with the random-azimuth source."""
    jd = jdomain.build_domain(*four_components(jstep, jdomain, jpf),
                              n_cdf_steps=201)
    pg, pc = four_components(pstep, pdomain, ppf, dict(device="cpu"))
    pd = pdomain.build_domain(pg, pc, n_cdf_steps=201)
    assert pd.n_components == 4 and not pd.all_hg
    compare((jd, JSurface.lambertian(0.1), jill.random_azimuth(0.6)),
            (pd, Surface.lambertian(0.1), illumination.random_azimuth(0.6)),
            *configs(n_lanes=2048, photons_per_lane=4))


def test_tail_compaction():
    """16,384 lanes: once every quota is spent the survivors are
    compacted into 2,048 lanes, whose draws index the compacted wave."""
    jd = jstep.make_step_cloud(ssa=0.99)
    pd = pstep.make_step_cloud(ssa=0.99, device="cpu")
    jt, pt = compare(
        (jd, JSurface.lambertian(0.0), jill.directional(0.8, 0.0)),
        (pd, Surface.lambertian(0.0), illumination.directional(0.8, 0.0)),
        *configs(n_lanes=16384, photons_per_lane=1), state=False)
    assert pt.n_photons == 16384


def small_cloud(pkg_step, **kw):
    return pkg_step.make_step_cloud(ssa=0.99, n_columns=8, n_layers=8,
                                    tau_thick=6.0, **kw)


def test_fallback_cases_run_on_the_wave_kernel():
    """The cases the JAX package sends to its XLA path: no hand-written
    kernel takes them, so "auto" runs the wave kernel and "on" raises
    naming the predicates."""
    dirs = le.make_intensity_directions([1.0, 0.1], [0.0, 90.0],
                                        device="cpu")
    icfg = le.IntensityConfig(n_dirs=2)
    hg = small_cloud(pstep, device="cpu")
    tables = small_cloud(pstep, device="cpu", compute_intensity_tables=True,
                         hybrid_width_deg=10.0)
    g = hg.grid
    irregular_grid = Grid.from_edges(
        g.edges_np()[0], g.edges_np()[1],
        np.concatenate([[0.0], np.cumsum(np.linspace(10, 50, 8))]),
        device="cpu")
    _, comps, _ = pstep.step_cloud_scene(ssa=0.99, n_columns=8,
                                         n_layers=8, device="cpu")
    irregular = pdomain.build_domain(irregular_grid, comps)
    four = pdomain.build_domain(
        *four_components(pstep, pdomain, ppf, dict(device="cpu")),
        n_cdf_steps=201)
    bg, bc, _ = broken_cloud_scene(nx=16, ny=16, nz=16, device="cpu")
    q = np.full((1, 1, 16), 2.5e-4)
    gas = pdomain.OpticalComponent(
        "gas absorber", q, np.zeros_like(q), np.zeros(q.shape, np.int32),
        ppf.PhaseFunctionTable([ppf.PhaseFunction.isotropic()], key=[1.0]))
    gas_tables = pdomain.build_domain(bg, [bc[0], gas], macro_factor=8,
                                      n_cdf_steps=201,
                                      compute_intensity_tables=True,
                                      hybrid_width_deg=10.0)
    assert gas_tables.col_template and gas_tables.col_qz is not None
    lam, beam = Surface.lambertian(0.2), illumination.directional(0.5, 0.0)
    small = dict(n_lanes=64, photons_per_lane=1)
    cases = {
        "irregular grid": (irregular, lam, {}, None),
        "4 components": (four, lam, {}, None),
        "radiance below pallas_min_mu": (tables, lam, {}, icfg),
        "n_orders_orig_phase": (tables, lam, {}, le.IntensityConfig(
            n_dirs=1, n_orders_orig_phase=2)),
        "radiance off an RPV surface": (tables, Surface.rpv(0.2, 0.8, -0.1),
                                        {}, le.IntensityConfig(n_dirs=1)),
        "gas template with radiance tables": (
            gas_tables, lam, {}, le.IntensityConfig(n_dirs=1)),
        "useRayTracing, numRecScatOrd": (hg, lam, dict(
            use_ray_tracing=True, record_scattering_orders=3), None),
    }
    for name, (dom, sfc, kw, ic) in cases.items():
        d = None if ic is None else dirs[:, :ic.n_dirs]
        cfg = integrator.KernelConfig(**small, **kw)
        kernel, reasons = integrator.select_kernel(dom, sfc, beam, cfg, ic, d)
        assert kernel is None and reasons, name
        before = integrator.WAVE_BATCHES
        t = integrator.run_batch(dom, sfc, beam, 1, cfg, intensity_config=ic,
                                 intensity_dirs=d, key=rng.batch_key(1, 0))
        assert integrator.WAVE_BATCHES == before + 1, name
        assert t.n_photons == 64, name
        on = integrator.KernelConfig(use_pallas="on", **small, **kw)
        with pytest.raises(ValueError, match="failing record-kernel"):
            integrator.run_batch(dom, sfc, beam, 1, on, intensity_config=ic,
                                 intensity_dirs=d)
    # "off" runs the wave kernel where the record kernel would take the run
    cfg = integrator.KernelConfig(use_pallas="off", **small)
    auto = integrator.KernelConfig(**small)
    assert integrator.select_kernel(hg, lam, beam, auto)[0] == "record"
    before = integrator.WAVE_BATCHES
    integrator.run_batch(hg, lam, beam, 1, cfg, key=rng.batch_key(1, 0))
    assert integrator.WAVE_BATCHES == before + 1


def test_wave_kernel_needs_the_threefry_key():
    """A batch that goes to the wave kernel without its threefry key
    raises rather than seed itself by another rule; a batch a hand-written
    kernel takes needs none."""
    dom = small_cloud(pstep, device="cpu")
    sfc, src = Surface.lambertian(0.2), illumination.directional(0.5, 0.0)
    small = dict(n_lanes=64, photons_per_lane=1)
    before = integrator.WAVE_BATCHES
    with pytest.raises(ValueError, match="batch_key"):
        integrator.run_batch(dom, sfc, src, 1, integrator.KernelConfig(
            use_pallas="off", **small))
    assert integrator.WAVE_BATCHES == before
    t = integrator.run_batch(dom, sfc, src, 1,
                             integrator.KernelConfig(**small))
    assert t.n_photons == 64 and integrator.WAVE_BATCHES == before


def test_integrator_wrapper():
    """``Integrator.compute`` runs batch b of a seed at JAX's key and the
    kernel seed of (seed, b), normalized per column."""
    dom = small_cloud(pstep, device="cpu")
    sfc, src = Surface.lambertian(0.2), illumination.directional(0.5, 0.0)
    cfg = integrator.KernelConfig(n_lanes=64, photons_per_lane=2,
                                  use_pallas="off")
    got = integrator.Integrator(dom, sfc, cfg).compute(src, 9, 3)
    want = integrator.run_batch(
        dom, sfc, src, rng.batch_seed(9, 3), cfg,
        key=rng.batch_key(9, 3)).normalized(dom.grid)
    assert got.n_photons == want.n_photons == 128
    for f in FLUX_FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f))


def test_wave_radiance_takes_every_direction_in_one_pass(monkeypatch):
    """Past MAX_KERNEL_DIRS only a kernel's radiance is chunked: the wave
    kernel estimates all 65 directions over its one pass of photons."""
    def no_chunks(*args, **kwargs):
        raise AssertionError("the wave kernel's radiance was chunked")

    monkeypatch.setattr(integrator, "_run_batch_dir_chunked", no_chunks)
    dom = pstep.make_step_cloud(ssa=0.9, n_columns=4, n_layers=4,
                                tau_thin=0.5, tau_thick=1.0, device="cpu")
    n = le.MAX_KERNEL_DIRS + 1
    dirs = le.make_intensity_directions(np.linspace(0.2, 1.0, n),
                                        np.linspace(0.0, 350.0, n),
                                        device="cpu")
    icfg = le.IntensityConfig(n_dirs=n, use_russian_roulette=False)
    cfg = integrator.KernelConfig(n_lanes=8, photons_per_lane=1,
                                  use_pallas="off")
    t = integrator.run_batch(dom, Surface.lambertian(0.2),
                             illumination.directional(0.5, 0.0), 1, cfg,
                             intensity_config=icfg, intensity_dirs=dirs,
                             key=rng.batch_key(1, 0))
    assert t.intensity.shape == (4, 1, n)
    assert bool((t.intensity.sum(dim=(0, 1)) > 0).all())
