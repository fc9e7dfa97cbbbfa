"""PyTorch port: domain building, netCDF I/O and namelist parsing against
the JAX package.

Both packages flatten the same float64 NumPy inputs into float32 records,
so the port's arrays must equal JAX's exactly.
"""

import glob
import os
import dataclasses

import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core.grid import Grid as JGrid
from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.domain.domain import OpticalComponent as JComp
from mcbrat3d_tpu.domain.domain import build_domain as jbuild
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.physics.phase_function import PhaseFunction as JPF
from mcbrat3d_tpu.physics.phase_function import PhaseFunctionTable as JPFT
from mcbrat3d_tpu.scenes.step_cloud import step_cloud_scene as jscene
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain import io_netcdf as tio
from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent, build_domain,
                                              domain_from_numpy)
from mcbrat3d_tpu_torch.driver.config import load_config
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.scenes.step_cloud import step_cloud_scene

torch.set_num_threads(1)

RUN_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "run")


def jax_arrays(dom):
    """A JAX OpticalDomain's fields as the dict domain_from_numpy takes."""
    xe, ye, ze = (np.asarray(e) for e in (dom.grid.x_edges, dom.grid.y_edges,
                                          dom.grid.z_edges))
    return dict(x_edges=xe, y_edges=ye, z_edges=ze,
                xy_regular=dom.grid.xy_regular, z_regular=dom.grid.z_regular,
                total_ext=np.asarray(dom.total_ext),
                cum_ext=np.asarray(dom.cum_ext), ssa=np.asarray(dom.ssa),
                phase_index=np.asarray(dom.phase_index),
                cell_records=np.asarray(dom.cell_records),
                inverse=np.asarray(dom.tables.inverse),
                offsets=np.asarray(dom.tables.offsets), all_hg=dom.all_hg,
                uniform_ssa=dom.uniform_ssa, uniform_hg=dom.uniform_hg,
                macro_factor=dom.macro_factor)


def assert_same_domain(tdom, jdom):
    np.testing.assert_array_equal(tdom.cell_records.numpy(),
                                  np.asarray(jdom.cell_records))
    np.testing.assert_array_equal(tdom.total_ext.numpy(),
                                  np.asarray(jdom.total_ext))
    np.testing.assert_array_equal(tdom.cum_ext.numpy(),
                                  np.asarray(jdom.cum_ext))
    np.testing.assert_array_equal(tdom.ssa.numpy(), np.asarray(jdom.ssa))
    np.testing.assert_array_equal(tdom.phase_index.numpy(),
                                  np.asarray(jdom.phase_index))
    np.testing.assert_array_equal(tdom.tables.inverse.numpy(),
                                  np.asarray(jdom.tables.inverse))
    np.testing.assert_array_equal(tdom.grid.z_edges.numpy(),
                                  np.asarray(jdom.grid.z_edges))
    assert tdom.max_extinction == float(jdom.max_extinction)
    assert (tdom.all_hg, tdom.uniform_ssa, tdom.uniform_hg,
            tdom.macro_factor) == (jdom.all_hg, jdom.uniform_ssa,
                                   jdom.uniform_hg, jdom.macro_factor)
    assert (tdom.grid.xy_regular, tdom.grid.z_regular) == (
        jdom.grid.xy_regular, jdom.grid.z_regular)


def random_hg_components(port: bool):
    """Seeded random 8x4x6 two-entry HG domain (non-uniform ssa and g)."""
    rs = np.random.default_rng(5)
    nx, ny, nz = 8, 4, 6
    ext = rs.uniform(0.0, 3.0, (nx, ny, nz))
    ext[rs.random((nx, ny, nz)) < 0.3] = 0.0
    ssa = rs.uniform(0.5, 1.0, (nx, ny, nz))
    pfi = rs.integers(0, 2, (nx, ny, nz)).astype(np.int32)
    PF, PFT, Comp, G = ((PhaseFunction, PhaseFunctionTable, OpticalComponent,
                         Grid) if port else (JPF, JPFT, JComp, JGrid))
    table = PFT([PF.henyey_greenstein(0.85, 32),
                 PF.henyey_greenstein(-0.3, 32)], key=[1.0, 2.0])
    grid = G.regular(nx, ny, nz, 0.1, 0.2, 0.05)
    return grid, [Comp("rand", ext, ssa, pfi, table)]


@pytest.mark.parametrize("macro_factor", [0, 8, 16])
def test_build_domain_step_cloud_matches_jax(macro_factor):
    jg, jc, _ = jscene(ssa=0.99)
    tg, tc, _ = step_cloud_scene(ssa=0.99)
    kw = dict(n_cdf_steps=501, macro_factor=macro_factor)
    assert_same_domain(build_domain(tg, tc, **kw), jbuild(jg, jc, **kw))


def test_build_domain_random_hg_matches_jax():
    tg, tc = random_hg_components(port=True)
    jg, jc = random_hg_components(port=False)
    tdom = build_domain(tg, tc, n_cdf_steps=301, macro_factor=2)
    jdom = jbuild(jg, jc, n_cdf_steps=301, macro_factor=2)
    assert not tdom.uniform_ssa and not tdom.uniform_hg
    assert_same_domain(tdom, jdom)


def test_domain_from_numpy_of_jax_domain():
    jg, jc = random_hg_components(port=False)
    jdom = jbuild(jg, jc, n_cdf_steps=301, macro_factor=4)
    assert_same_domain(domain_from_numpy(jax_arrays(jdom)), jdom)


def test_unported_domain_options_raise():
    tg, tc, _ = step_cloud_scene()
    with pytest.raises(NotImplementedError, match="K4"):
        build_domain(tg, tc, device_fields="compact")
    with pytest.raises(NotImplementedError, match="K2"):
        build_domain(tg, tc, compute_intensity_tables=True)


def _component_fields(c):
    return (c.name, c.z_level_base, c.extinction, c.single_scattering_albedo,
            c.phase_function_index,
            [p.coefficients for p in c.phase_function_table.phase_functions])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_netcdf_round_trip_across_packages(tmp_path, writer):
    """One package writes the step-cloud domain file, the other reads it."""
    path = str(tmp_path / "step.dom")
    if writer == "port":
        g, comps, _ = step_cloud_scene(ssa=0.99)
        tio.write_domain(path, g, comps, surface_albedo=0.1)
        rg, rcomps, _, attrs = jio.read_domain(path)
        edges = [np.asarray(e) for e in (rg.x_edges, rg.y_edges, rg.z_edges)]
    else:
        g, comps, _ = jscene(ssa=0.99)
        jio.write_domain(path, g, comps, surface_albedo=0.1)
        rg, rcomps, _, attrs = tio.read_domain(path)
        edges = [e.numpy() for e in (rg.x_edges, rg.y_edges, rg.z_edges)]
    for got, want in zip(edges, g.edges_np()):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert attrs["surface_albedo"] == 0.1
    assert len(rcomps) == len(comps) == 1
    got, want = _component_fields(rcomps[0]), _component_fields(comps[0])
    assert got[:2] == want[:2]
    for a, b in zip(got[2:5], want[2:5]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[5][0], want[5][0], rtol=1e-6)


@pytest.mark.parametrize(
    "deck", sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(RUN_DIR, "*.nml"))))
def test_load_config_matches_jax(deck):
    path = os.path.join(RUN_DIR, deck)
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(
        jload(path))
