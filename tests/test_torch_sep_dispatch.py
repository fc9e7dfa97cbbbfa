"""PyTorch port: the separable-template kernel (K4) in the dispatch. Past
the record kernel's 36,864 cells the port's ``run_batch`` picks the kernel
the JAX package picks for a compact, full, column-template or dense
domain; ``select_kernel`` names the kernel ``run_batch`` runs; a compact
domain outside the separable kernel raises naming its failing predicates.
The plain step against the JAX separable kernel is in
``test_torch_sep_kernel.py``.
"""

import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.domain.domain import build_domain as jbuild
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.collection import lw_flagship_scene as jscene
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import integrator as jintegrator
from mcbrat3d_tpu.transport import pallas_col as jpc
from mcbrat3d_tpu.transport import pallas_kernel as jpk
from mcbrat3d_tpu.transport import pallas_sep as jsep
from mcbrat3d_tpu.transport import pallas_tile as jtile
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
from mcbrat3d_tpu_torch.transport import tile_kernel as tk
from mcbrat3d_tpu_torch.transport.integrator import (KernelConfig, run_batch,
                                                      select_kernel)

torch.set_num_threads(1)


_PORT_KERNELS = ((rk, "run_batch_record_tallies", "record"),
                 (ck, "run_batch_col_tallies", "col"),
                 (sk, "run_batch_sep_tallies", "sep"),
                 (tk, "run_batch_tile_tallies", "tile"))


class _Picked(Exception):
    pass


def _picker(name):
    def pick(*args, **kwargs):
        raise _Picked(name)
    return pick


def _components(case, port):
    """(grid, components) past the record kernel's 36,864 cells: a column
    template (64 x 32 x 32, clouds from the ground to varying heights) or
    a full-rank 40 x 40 x 30 field."""
    r = np.random.RandomState(5)
    if case == "template":
        h = r.randint(0, 33, size=(64, 32, 1))
        ext = np.where(np.arange(32) < h, 0.01 + 0.01 * r.rand(64, 32, 1),
                       0.0)
    else:
        ext = 0.02 + 0.01 * r.rand(40, 40, 30)
    args = (ext, np.full_like(ext, 0.9), np.zeros(ext.shape, np.int32))
    shape = ext.shape
    if port:
        grid = Grid.regular(*shape, 0.1, 0.1, 0.1, device="cpu")
        return grid, [OpticalComponent(
            case, *args, PhaseFunctionTable(
                [PhaseFunction.henyey_greenstein(0.85, 32)], key=[1.0]))]
    from mcbrat3d_tpu.core.grid import Grid as JGrid
    from mcbrat3d_tpu.domain.domain import OpticalComponent as JComp
    from mcbrat3d_tpu.physics.phase_function import PhaseFunction as JPF
    from mcbrat3d_tpu.physics.phase_function import PhaseFunctionTable as JPFT
    return JGrid.regular(*shape, 0.1, 0.1, 0.1), [JComp(
        case, *args, JPFT([JPF.henyey_greenstein(0.85, 32)], key=[1.0]))]


@pytest.mark.parametrize("case", ["compact", "full", "template", "dense"])
def test_dispatch_picks_the_kernel_jax_picks(monkeypatch, case):
    """A compact LW flagship bin and its full build go to the separable
    kernel, a column template to the column kernel and a dense field past
    every template to the tiled kernel (K5), in the port as in the JAX
    package (use_pallas="on", the choice taken at trace time, no kernel
    run)."""
    for mod, fn, name in ((jpk, "run_batch_pallas_tallies", "record"),
                          (jpc, "run_batch_pallas_col_tallies", "column"),
                          (jsep, "run_batch_pallas_sep_tallies", "separable"),
                          (jtile, "run_batch_pallas_tile_tallies", "tiled"),
                          (rk, "run_batch_record_tallies", "record"),
                          (ck, "run_batch_col_tallies", "column"),
                          (sk, "run_batch_sep_tallies", "separable"),
                          (tk, "run_batch_tile_tallies", "tiled")):
        monkeypatch.setattr(mod, fn, _picker(name))
    lw = case == "compact"
    if case in ("compact", "full"):
        kw = dict(temps=None, macro_factor=8, n_cdf_steps=101,
                  lambda_um=10.0, device_fields=case)
        jg, jc, jt = jscene(nx=16, ny=16, nz=150)
        tg, tc, tt = lw_flagship_scene(nx=16, ny=16, nz=150, device="cpu")
        jd = jbuild(jg, jc, **dict(kw, temps=jt))
        td = build_domain(tg, tc, **dict(kw, temps=tt))
    else:
        jd = jbuild(*_components(case, False), n_cdf_steps=101,
                    macro_factor=8)
        td = build_domain(*_components(case, True), n_cdf_steps=101,
                          macro_factor=8)
    if lw:
        jsrc = jill.emission_separable(jd, 288.0, 0.95)
        tsrc = illumination.emission_separable(td, 288.0, 0.95)
    else:
        jsrc, tsrc = jill.directional(0.5, 0.0), illumination.directional(
            0.5, 0.0)
    # the tiled kernel tallies no profile
    kw = dict(n_lanes=1024, photons_per_lane=1, need_volume_absorption=False,
              need_absorption_profile=case != "dense", lw_mode=lw)
    with pytest.raises(_Picked) as jax_pick:
        jintegrator.run_batch(jd, JSurface.lambertian(0.05), jsrc,
                              jrng.batch_key(0, 0),
                              jintegrator.KernelConfig(use_pallas="on", **kw))
    expect = {"compact": "separable", "full": "separable",
              "template": "column", "dense": "tiled"}[case]
    assert str(jax_pick.value) == expect
    with pytest.raises(_Picked) as port_pick:
        run_batch(td, Surface.lambertian(0.05), tsrc, 0, KernelConfig(**kw))
    assert str(port_pick.value) == expect


@pytest.mark.parametrize("case", ["record", "compact", "full", "template",
                                  "dense", "refused"])
def test_select_kernel_names_the_kernel_run_batch_runs(monkeypatch, case):
    """``select_kernel`` names the kernel ``run_batch`` launches (or None
    where it raises), and every kernel tried before it has failing
    predicates: a small step cloud on the record kernel, the four cases of
    the dispatch test above, and a compact domain with a directional source,
    which no ported kernel takes."""
    for mod, fn, name in _PORT_KERNELS:
        monkeypatch.setattr(mod, fn, _picker(name))
    lw = case == "compact"
    if case in ("compact", "full", "refused"):
        grid, comps, temps = lw_flagship_scene(nx=16, ny=16, nz=150,
                                               device="cpu")
        dom = build_domain(grid, comps, temps=temps, macro_factor=8,
                           n_cdf_steps=101, lambda_um=10.0,
                           device_fields="full" if case == "full"
                           else "compact")
    elif case == "record":
        dom = build_domain(
            Grid.regular(8, 8, 8, 0.1, 0.1, 0.1, device="cpu"),
            [OpticalComponent(
                "c", np.full((8, 8, 8), 2.0), np.full((8, 8, 8), 0.9),
                np.zeros((8, 8, 8), np.int32),
                PhaseFunctionTable([PhaseFunction.henyey_greenstein(0.85, 32)],
                                   key=[1.0]))], n_cdf_steps=101)
    else:
        dom = build_domain(*_components(case, True), n_cdf_steps=101,
                           macro_factor=8)
    src = (illumination.emission_separable(dom, 288.0, 0.95) if lw
           else illumination.directional(0.5, 0.0))
    # the refused case asks for the 3D tally, which the compact domain lacks
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=1,
                       need_volume_absorption=case == "refused",
                       need_absorption_profile=case != "dense", lw_mode=lw)
    kernel, reasons = select_kernel(dom, Surface.lambertian(0.05), src, cfg)
    assert kernel == {"record": "record", "compact": "sep", "full": "sep",
                      "template": "col", "dense": "tile",
                      "refused": None}[case]
    if kernel is None:
        with pytest.raises(ValueError, match="compact"):
            run_batch(dom, Surface.lambertian(0.05), src, 0, cfg)
        assert list(reasons) == ["record", "col", "sep", "tile"]
    else:
        with pytest.raises(_Picked) as pick:
            run_batch(dom, Surface.lambertian(0.05), src, 0, cfg)
        assert str(pick.value) == kernel
        assert reasons.pop(kernel) == []
    assert all(reasons.values()), reasons


def test_compact_domain_outside_the_kernel_raises():
    """A compact domain reaches the separable kernel or raises naming its
    failing predicates (integrator.py:539-554)."""
    grid, comps, temps = lw_flagship_scene(nx=16, ny=16, nz=150, device="cpu")
    dom = build_domain(grid, comps, temps=temps, macro_factor=8,
                       n_cdf_steps=101, lambda_um=10.0,
                       device_fields="compact")
    with pytest.raises(ValueError, match="compact.*3D tally"):
        run_batch(dom, Surface.lambertian(0.05),
                  illumination.directional(0.5, 0.0), 0,
                  KernelConfig(n_lanes=1024, photons_per_lane=1))
