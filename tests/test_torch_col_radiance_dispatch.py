"""PyTorch port: where radiance goes to the column kernel's local estimate
(K3-d) and what it refuses. Past the record kernel's 36,864 cells a
radiance run goes to K3-d in both packages; each predicate of
``col_intensity_ineligibility_reasons`` refuses by name where the JAX
package's refuses too; ``IntensityConfig.pallas_min_mu`` is read as JAX
reads it (bench.py's configuration, and the record kernel's direction
floor and march bound). The local estimate against the JAX column kernel
is in ``test_torch_col_radiance.py``.
"""

import dataclasses

import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jstep_cloud
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport.local_estimate import IntensityConfig as JIcfg
from mcbrat3d_tpu.transport.local_estimate import \
    make_intensity_directions as jdirections
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import col_kernel as ck
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig, run_batch,
                                                     select_kernel)

from test_torch_col_radiance import (MUS16, PHIS16, both_domains,
                                     column_field, gas_profile)

torch.set_num_threads(1)


class _Picked(Exception):
    pass


def _picker(name):
    def pick(*args, **kwargs):
        raise _Picked(name)
    return pick


@pytest.mark.parametrize("gas", [False, True])
def test_dispatch_picks_column_radiance_where_jax_does(monkeypatch, gas):
    """Past the record kernel's 36,864 cells a radiance run goes to the
    column kernel's local estimate in both packages (use_pallas="on", the
    choice taken at trace time, no kernel run)."""
    nz = 32
    jd, td = both_domains(column_field(64, 32, nz),
                          gas_profile(nz, 50.0) if gas else None,
                          macro_factor=8, tables=not gas)
    assert 64 * 32 * nz > rk.MAX_CELLS
    for mod, fn, name in ((jpk, "run_batch_pallas_tallies", "record"),
                          (jpc, "run_batch_pallas_col_tallies", "column"),
                          (rk, "run_batch_record_tallies", "record"),
                          (ck, "run_batch_col_tallies", "column")):
        monkeypatch.setattr(mod, fn, _picker(name))
    kw = dict(n_lanes=1024, photons_per_lane=1, need_volume_absorption=False)
    with pytest.raises(_Picked) as jax_pick:
        jintegrator.run_batch(
            jd, JSurface.lambertian(0.2), jill.directional(0.5, 0.0),
            jrng.batch_key(0, 0),
            jintegrator.KernelConfig(use_pallas="on", **kw),
            intensity_config=JIcfg(n_dirs=16, pallas_min_mu=0.4),
            intensity_dirs=jdirections(MUS16, PHIS16))
    with pytest.raises(_Picked) as port_pick:
        run_batch(td, Surface.lambertian(0.2),
                  illumination.directional(0.5, 0.0), 0, KernelConfig(**kw),
                  intensity_config=le.IntensityConfig(n_dirs=16,
                                                      pallas_min_mu=0.4),
                  intensity_dirs=le.make_intensity_directions(
                      MUS16, PHIS16, device="cpu"))
    assert str(port_pick.value) == str(jax_pick.value) == "column"


# refusal -> (what the port names, domain knobs, IntensityConfig knobs,
# directions, lw_mode, source)
REFUSALS = {
    "n_dirs": ("n_dirs=65 > 64", {}, {}, ([0.8] * 65, [0.0] * 65), False,
               None),
    "mu_floor": ("pallas_min_mu=0.4", {}, {}, ([0.3], [0.0]), False, None),
    "capping": ("limit_contributions", {}, dict(limit_contributions=True),
                None, False, None),
    "orig_orders": ("n_orders_orig_phase", {},
                    dict(n_orders_orig_phase=2), None, False, None),
    "lw": ("LW/emission radiance", {}, {}, None, True, None),
    "emission": ("LW/emission radiance", {}, {}, None, False,
                 illumination.Source(kind=illumination.EMISSION)),
    "wide": ("max(nx, ny)=160 > 128", dict(shape=(160, 8, 8)), {}, None,
             False, None),
    "forward_rows": ("forward phase table has more than one row",
                     dict(gas=True, tables=True), {}, None, False, None),
    "no_forward_table": ("no forward table and not all-HG",
                         dict(tabulated=True, tables=False), {}, None,
                         False, None),
}


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_each_column_radiance_refusal_is_named(refusal):
    """Each predicate of ``col_intensity_ineligibility_reasons`` refuses by
    name where the JAX package's column predicate refuses too."""
    name, dom_kw, icfg_kw, dirs_mp, lw, source = REFUSALS[refusal]
    shape = dom_kw.get("shape", (16, 16, 8))
    gas = gas_profile(shape[2], 50.0) if dom_kw.get("gas") else None
    jd, td = both_domains(column_field(*shape), gas,
                          tables=dom_kw.get("tables", True))
    if dom_kw.get("tabulated"):
        jd, td = (dataclasses.replace(d, all_hg=False) for d in (jd, td))
    mus, phis = dirs_mp or ([1.0, 0.6], [0.0, 135.0])
    icfg = le.IntensityConfig(n_dirs=len(mus), pallas_min_mu=0.4, **icfg_kw)
    jicfg = JIcfg(n_dirs=len(mus), pallas_min_mu=0.4, **icfg_kw)
    src = source or illumination.directional(0.5, 0.0)
    jsrc = (jill.directional(0.5, 0.0) if source is None
            else jill.Source(kind=jill.EMISSION))
    jdirs = jdirections(mus, phis)
    dirs = le.make_intensity_directions(mus, phis, device="cpu")
    reasons = ck.col_intensity_ineligibility_reasons(
        td, Surface.lambertian(0.2), src, lw, 0, False, icfg, dirs, False)
    assert any(name in r for r in reasons), reasons
    assert jpc.col_intensity_ineligibility_reasons(
        jd, JSurface.lambertian(0.2), jsrc, lw, 0, False, jicfg, jdirs,
        jpk.dirs_mu_floor_ok(jicfg, jdirs), False)
    if refusal == "mu_floor":  # and run_batch says so
        with pytest.raises(ValueError, match="pallas_min_mu=0.4"):
            run_batch(td, Surface.lambertian(0.2), src, 0,
                      KernelConfig(n_lanes=1024, photons_per_lane=1,
                                   use_pallas="on"),
                      intensity_config=icfg, intensity_dirs=dirs)


def test_bench_intensity_config_constructs():
    """bench.py:558-559's configuration, field for field as in JAX."""
    icfg = le.IntensityConfig(n_dirs=16, use_russian_roulette=True,
                              use_hybrid_phase=True, pallas_min_mu=0.4)
    jicfg = JIcfg(n_dirs=16, use_russian_roulette=True,
                  use_hybrid_phase=True, pallas_min_mu=0.4)
    assert icfg.pallas_min_mu == jicfg.pallas_min_mu == 0.4
    assert (le.IntensityConfig(n_dirs=1).pallas_min_mu
            == JIcfg(n_dirs=1).pallas_min_mu == le.MIN_MU)


@pytest.fixture(scope="module")
def step_clouds():
    return (jstep_cloud(ssa=0.99, n_cdf_steps=201),
            make_step_cloud(ssa=0.99, n_cdf_steps=201, device="cpu"))


@pytest.mark.parametrize("min_mu,mu,ok", [(0.4, 0.3, False),
                                          (0.4, 0.45, True),
                                          (0.1, 0.12, True),
                                          (0.15, 0.12, False)])
def test_mu_floor_reads_pallas_min_mu(step_clouds, min_mu, mu, ok):
    """The record kernel's local estimate refuses a direction below
    ``pallas_min_mu`` by name, as JAX's dirs_mu_floor_ok does; a lowered
    floor admits it, with a march bound no smaller than JAX's
    dda_iteration_bound(grid, min_mu)."""
    jdom, dom = step_clouds
    icfg = le.IntensityConfig(n_dirs=1, use_russian_roulette=False,
                              use_hybrid_phase=False, pallas_min_mu=min_mu)
    dirs = le.make_intensity_directions([mu], [30.0], device="cpu")
    jicfg = JIcfg(n_dirs=1, pallas_min_mu=min_mu)
    assert jpk.dirs_mu_floor_ok(jicfg, jdirections([mu], [30.0])) == ok
    assert le.dirs_mu_floor_ok(icfg, dirs) == ok
    sfc, src = Surface.lambertian(0.0), illumination.directional(0.5, 0.0)
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=1, max_steps=6000)
    reasons = rk.intensity_ineligibility_reasons(dom, sfc, src, False, 0,
                                                 False, icfg, dirs)
    if not ok:
        assert any(f"pallas_min_mu={min_mu}" in r for r in reasons)
        with pytest.raises(ValueError, match="pallas_min_mu"):
            run_batch(dom, sfc, src, 0,
                      dataclasses.replace(cfg, use_pallas="on"),
                      intensity_config=icfg, intensity_dirs=dirs)
        return
    assert not reasons
    prm = rk.RecordParams.make(dom, sfc, src, True, 1.0, True, icfg, dirs)
    assert prm.k_dda >= jpk.dda_iteration_bound(jdom.grid, min_mu)
    assert select_kernel(dom, sfc, src, cfg, icfg, dirs)[0] == "record"
    out = rk.run_batch_record(dom, sfc, src, rng.batch_seed(3, 0),
                              rk.RecordConfig(rows=8, steps_per_call=16,
                                              max_steps=6000), 1,
                              n_photons=128, intensity_config=icfg,
                              intensity_dirs=dirs)
    assert out[4] == 0 and out[7] == 0  # n_bad, cut marches
    assert out[6].shape == (32, 1, 1) and float(out[6].sum()) > 0
