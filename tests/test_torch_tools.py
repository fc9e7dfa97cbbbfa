"""PyTorch port: scenes, domain-building tools, their subcommands and the
reference tracer, against the JAX package on the same inputs.

Every scene of ``scenes/collection.py`` the JAX package has (with
synthetic field files for the Landsat and radar readers) equals JAX's:
grid edges, extinction, single-scattering albedo, temperatures and phase
coefficients within rtol 1e-6, phase indices equal. The physical- and
optical-properties converters and the Rayleigh transmission tool equal
JAX's the same way; ``mkdomain`` (every registered scene), ``physprops``,
``optprops`` and ``rayleightrans`` write files that JAX's readers read and
that equal the files JAX's tools write; ``analyze`` prints JAX's summary.
The scalar reference tracer (``csrc/host/tracer.cpp``) gives JAX's
numbers on a tiny case within rtol 1e-12 (its OpenMP threads' sums are
added in no fixed order).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.domain.common import (CommonDomain,
                                        num_conc_from_pressure, write_common)
from mcbrat3d_tpu.core.grid import Grid as JGrid
from mcbrat3d_tpu.physics import phase_function as jpf
from mcbrat3d_tpu.scenes import collection as jsc
from mcbrat3d_tpu.tools import analyze_results as jan
from mcbrat3d_tpu.tools import molec_scatt_trans as jmst
from mcbrat3d_tpu.tools import optical_to_domain as jo2d
from mcbrat3d_tpu.tools import physical_to_domain as jp2d
from mcbrat3d_tpu.tools import reference_tracer as jtracer
from mcbrat3d_tpu.tools import scene_cli as jscene_cli
from mcbrat3d_tpu_torch.domain import io_netcdf
from mcbrat3d_tpu_torch.domain.common import read_common
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.physics import phase_function as ppf
from mcbrat3d_tpu_torch.scenes import collection as sc
from mcbrat3d_tpu_torch.tools import analyze_results
from mcbrat3d_tpu_torch.tools import molec_scatt_trans as mst
from mcbrat3d_tpu_torch.tools import optical_to_domain as o2d
from mcbrat3d_tpu_torch.tools import physical_to_domain as p2d
from mcbrat3d_tpu_torch.tools import reference_tracer, scene_cli

RTOL = 1e-6


def assert_components_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.name, a.z_level_base) == (b.name, b.z_level_base)
        for f in ("extinction", "single_scattering_albedo"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, err_msg=f)
        np.testing.assert_array_equal(a.phase_function_index,
                                      b.phase_function_index)
        ta, tb = a.phase_function_table, b.phase_function_table
        np.testing.assert_allclose(ta.key, tb.key, rtol=RTOL)
        assert len(ta.phase_functions) == len(tb.phase_functions)
        for pa, pb in zip(ta.phase_functions, tb.phase_functions):
            if pb.coefficients is None:
                np.testing.assert_allclose(pa.values, pb.values, rtol=RTOL)
            else:
                np.testing.assert_allclose(pa.coefficients, pb.coefficients,
                                           rtol=RTOL)


def assert_scene_equal(got, want):
    (g, comps, temps), (jg, jcomps, jtemps) = got, want
    for a, b in zip(g.edges_np(), jg.edges_np()):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    assert str(g.device) == "cpu"
    assert_components_equal(comps, jcomps)
    assert (temps is None) == (jtemps is None)
    if temps is not None:
        np.testing.assert_allclose(temps, jtemps, rtol=RTOL)


def field_files(tmp_path):
    rs = np.random.RandomState(0)
    tau = np.round(rs.rand(4, 8) * 20, 2)
    thick = np.round(0.2 + rs.rand(4, 8), 2)  # km
    radar = np.round(rs.rand(6, 16) * 0.05, 4)
    paths = {name: str(tmp_path / f"{name}.txt")
             for name in ("tau", "dz", "radar")}
    np.savetxt(paths["tau"], tau, fmt="%7.2f")
    np.savetxt(paths["dz"], thick, fmt="%7.2f")
    np.savetxt(paths["radar"], radar, fmt="%9.4f")
    return paths


def table(pkg):
    return pkg.PhaseFunctionTable(
        [pkg.PhaseFunction.henyey_greenstein(0.8, 16),
         pkg.PhaseFunction.henyey_greenstein(0.85, 16)],
        key=[5.0, 15.0], extinction=[300.0, 100.0],
        single_scattering_albedo=[0.999, 0.995])


SCENES = [
    ("step_cloud_2tau_scene", dict(n_columns=20, n_layers=5)),
    ("cubic_cloud_scene", dict(tau=8.0, nx=8, ny=8, nz=8)),
    ("homog_bb_scene", dict(beta_ext=5.0, iso_temp=280.0)),
    ("homog_bb_scene", dict(hg_phase=False, nx=4, ny=3, nz=2)),
    ("inhomog_bb_scene", dict(pattern="gaussian", nx=8, ny=8, nz=4)),
    ("inhomog_bb_scene", dict(pattern="step", nx=8, ny=4, nz=3)),
    ("inhomog_bb_scene", dict(pattern="checker", nx=8, ny=8, nz=2)),
    ("landsat_cloud_scene", dict(nx=8, ny=4, delta_z=100.0)),
    ("radar_cloud_scene", dict(n_columns=16, n_layers=6)),
    ("modis_scene", {}),
]


@pytest.mark.parametrize("name,kw", SCENES)
def test_scene_equals_jax(name, kw, tmp_path):
    files = field_files(tmp_path)
    if name == "landsat_cloud_scene":
        kw = dict(kw, tau_file=files["tau"], dz_file=files["dz"])
    if name == "radar_cloud_scene":
        kw = dict(kw, tau_file=files["radar"])
    if name == "modis_scene":
        rs = np.random.RandomState(5)
        lwc = rs.rand(4, 3, 2) * (rs.rand(4, 3, 2) > 0.3)
        reff = 5.0 + 10.0 * rs.rand(4, 3, 2)
        kw = dict(lwc=lwc, reff=reff, dx=0.5, dy=0.25,
                  z_edges=[0.0, 0.2, 0.5], temps=np.full((4, 3, 2), 280.0))
        got = sc.modis_scene(mie_table=table(ppf), device="cpu", **kw)
        want = jsc.modis_scene(mie_table=table(jpf), **kw)
    else:
        got = getattr(sc, name)(device="cpu", **kw)
        want = getattr(jsc, name)(**kw)
    assert_scene_equal(got, want)


def test_hg_phase_values_and_scenes_default_to_the_card():
    np.testing.assert_array_equal(sc.hg_phase_values(0.7, 37),
                                  jsc.hg_phase_values(0.7, 37))
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sc.cubic_cloud_scene(nx=2, ny=2, nz=2)


def _jax_domain(path):
    grid, comps, temps, attrs = jio.read_domain(path)
    return (grid, comps, temps), attrs


def test_mkdomain_every_scene_writes_jax_files(tmp_path, capsys):
    files = field_files(tmp_path)
    params = {
        "step_cloud": ["ssa=0.99"], "plane_parallel": ["tau=2.0", "nz=4"],
        "step_cloud_2tau": ["n_columns=10", "n_layers=4"],
        "cubic": ["nx=8", "ny=8", "nz=8"], "homog_bb": ["nx=3"],
        "inhomog_bb": ["pattern=checker", "nx=8", "ny=8", "nz=2"],
        "landsat": [f"tau_file={files['tau']}", f"dz_file={files['dz']}",
                    "nx=8", "ny=4"],
        "radar": [f"tau_file={files['radar']}", "n_columns=16",
                  "n_layers=6"],
        "broken_cloud": ["nx=16", "ny=16", "nz=8"]}
    assert sorted(scene_cli.SCENES) == sorted(jscene_cli.SCENES) \
        == sorted(params)
    for scene, p in params.items():
        mine, theirs = str(tmp_path / f"{scene}.dom"), str(
            tmp_path / f"{scene}.jax.dom")
        assert cli.main(["mkdomain", scene, mine, *p]) == 0
        assert jscene_cli.main(scene, theirs, p) == 0
        (g, c, t), _ = _jax_domain(mine)
        (jg, jc, jt), _ = _jax_domain(theirs)
        for a, b in zip(g.edges_np(), jg.edges_np()):
            np.testing.assert_array_equal(a, b)
        assert_components_equal(c, jc)
        np.testing.assert_array_equal(t, jt)
    assert cli.main(["mkdomain", "no_such_scene", "x.dom"]) == 2


def write_type2(path):
    path.write_text("2\n2 1 2\n0.5 0.5\n0.0 0.25 0.5\n290.0 285.0 280.0\n"
                    "1 1 1 0.3 10.0\n2 1 2 0.5 12.5\n")


@pytest.mark.parametrize("case", ["type1", "type2", "type3", "type4"])
def test_physical_to_domain_equals_jax(case, tmp_path):
    f = tmp_path / "p.txt"
    kw = {}
    if case == "type1":
        f.write_text("1\n1 1 1\n1.0 1.0\n0.0 0.5\n290. 285.\n1 1 1 0.3\n")
    elif case == "type2":
        write_type2(f)
        kw = dict(molec_abs=np.array([0.01, 0.02]), rayleigh_wavelen=0.65)
    elif case == "type3":
        f.write_text("3\n1 1 1\n1.0 1.0\n0.0 0.5\n290. 285.\n"
                     "1 1 1 2  1 0.2 8.0  2 0.1 12.0\n")
    else:
        f.write_text("4\n2 2 3\n1.0 1.0\n0.0 1.0 2.0 3.0\n"
                     "288. 281.5 275. 268.5\n")
        kw = dict(rayleigh_wavelen=0.55)
    pf, jpf_ = p2d.read_particle_file(str(f)), jp2d.read_particle_file(str(f))
    for a, b in zip(pf.mass + pf.reff, jpf_.mass + jpf_.reff):
        np.testing.assert_array_equal(a, b)
    assert pf.table_index == jpf_.table_index
    n = max(pf.table_index, default=-1) + 1
    got = p2d.particles_to_components(pf, [table(ppf)] * n, device="cpu",
                                      **kw)
    want = jp2d.particles_to_components(jpf_, [table(jpf)] * n, **kw)
    assert_scene_equal(got, want)
    np.testing.assert_allclose(p2d.rayleigh_profile([0.0, 1.0, 2.5],
                                                    [288.0, 281.0, 270.0],
                                                    0.5),
                               jp2d.rayleigh_profile([0.0, 1.0, 2.5],
                                                     [288.0, 281.0, 270.0],
                                                     0.5), rtol=RTOL)


def test_physprops_and_optprops_write_jax_files(tmp_path, capsys):
    pfile, tfile, gas = (tmp_path / "p.txt", tmp_path / "t.pft",
                         tmp_path / "gas.txt")
    write_type2(pfile)
    io_netcdf.write_phase_function_table(table(ppf), str(tfile))
    gas.write_text("2\n0.0 0.25 0.5\n0.01 0.02\n")
    out = tmp_path / "pp.dom"
    (tmp_path / "pp.nml").write_text(f"""&physprops
  particlefilename = '{pfile}'
  scattablefiles = '{tfile}'
  outputfilename = '{out}'
  molecabsfilename = '{gas}'
  rayleighwavelength = 0.65
/
""")
    assert cli.main(["physprops", str(tmp_path / "pp.nml")]) == 0
    jp2d.convert(str(pfile), [str(tfile)], str(tmp_path / "pp.jax.dom"),
                 molec_abs_file=str(gas), rayleigh_wavelen=0.65)
    got, _ = _jax_domain(str(out))
    want, _ = _jax_domain(str(tmp_path / "pp.jax.dom"))
    assert len(got[1]) == 3
    assert_components_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])

    chi = " ".join(f"{(2*l+1)*0.5**l:.6f}" for l in range(1, 5))
    shdom = tmp_path / "shdom.txt"
    shdom.write_text(
        "T\n2 1 2\n0.5 0.5 0.0 0.25 0.5\n2\n"
        f"4 {chi}\n1 0.0\n"
        "1 1 1 290. 10.0 0.99 1\n"
        "2 1 1 290. 5.0 0.95 2\n"
        "1 1 2 285. 2.0 1.0 1\n"
        "2 1 2 285. 0.0 0.0 1\n")
    g, comp, temps = o2d.read_shdom_optical_file(str(shdom), device="cpu")
    jg, jcomp, jtemps = jo2d.read_shdom_optical_file(str(shdom))
    assert_scene_equal((g, [comp], temps), (jg, [jcomp], jtemps))
    assert cli.main(["optprops", str(shdom), str(tmp_path / "o.dom"),
                     "--surface-albedo", "0.1"]) == 0
    jo2d.convert(str(shdom), str(tmp_path / "o.jax.dom"), surface_albedo=0.1)
    got, attrs = _jax_domain(str(tmp_path / "o.dom"))
    want, jattrs = _jax_domain(str(tmp_path / "o.jax.dom"))
    assert attrs["surface_albedo"] == jattrs["surface_albedo"] == 0.1
    assert_components_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_rayleightrans_equals_jax(tmp_path, capsys):
    nz = 6
    grid = JGrid.regular(1, 1, nz, 500.0, 500.0, 1000.0)
    temps = np.linspace(288.0, 250.0, nz).reshape(1, 1, nz)
    pressure = np.linspace(1000.0, 500.0, nz)
    path = str(tmp_path / "common.nc")
    write_common(path, CommonDomain(
        grid=grid, temps=temps,
        num_conc=num_conc_from_pressure(pressure.reshape(1, 1, nz), temps)),
        pressure_hpa=pressure)
    lam = np.array([0.3, 0.5, 0.8])
    np.testing.assert_allclose(
        mst.rayleigh_transmission(read_common(path, device="cpu"), lam),
        jmst.rayleigh_transmission(jmst.read_common(path), lam), rtol=1e-12)
    out, jout = str(tmp_path / "r.txt"), str(tmp_path / "rj.txt")
    assert cli.main(["rayleightrans", path, "-o", out, "--n-lambda",
                     "7"]) == 0
    jmst.main(path, jout, n_lambda=7)
    got, want = np.loadtxt(out), np.loadtxt(jout)
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_analyze_prints_jax_summary(tmp_path, capsys):
    dom = str(tmp_path / "s.dom")
    nc = str(tmp_path / "res.nc")
    assert cli.main(["mkdomain", "step_cloud", dom, "ssa=0.99"]) == 0
    (tmp_path / "d.nml").write_text(f"""&radiativeTransfer
  solarMu = 0.5
/
&monteCarlo
  numPhotonsPerBatch = 2048
  numBatches = 2
  nPhaseIntervals = 201
/
&algorithms
  nLanes = 512
/
&output
  reportAbsorptionProfile = .true.
/
&fileNames
  domainFileName = '{dom}'
  outputNetcdfFile = '{nc}'
/
""")
    assert cli.main(["run", str(tmp_path / "d.nml"), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["total_photons"] == 4096
    assert cli.main(["analyze", nc]) == 0
    printed = capsys.readouterr().out.strip()
    assert printed == analyze_results.summarize(nc) == jan.summarize(nc)
    assert "energy budget" in printed and "absorptionProfile" in printed


def test_reference_tracer_equals_jax():
    rs = np.random.RandomState(2)
    ext = 0.02 * rs.rand(4, 2, 6)
    args = (ext, 0.97, 25.0, 25.0, 20.0, 0.85, 0.6, 0.2, 20_000)
    got = reference_tracer.trace(*args, seed=3, want_flux_up=True)
    want = jtracer.trace(*args, seed=3, want_flux_up=True)
    for k in ("R", "T", "A"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    np.testing.assert_allclose(got["flux_up"], want["flux_up"], rtol=1e-12)
    # every photon leaves the top, is absorbed, or is absorbed by the
    # surface (albedo 0.2) at each of its landings
    assert got["R"] + got["A"] + 0.8 * got["T"] == pytest.approx(1.0,
                                                                abs=1e-9)


def test_new_modules_import_no_jax():
    """The checkpoint, observability, Mie and tool modules stand alone."""
    mods = ["driver.checkpoint", "core.observability", "physics.mie",
            "physics.refractive", "tools.mie_table", "tools.ssp_create",
            "tools.physical_to_domain", "tools.optical_to_domain",
            "tools.molec_scatt_trans", "tools.analyze_results",
            "tools.reference_tracer", "tools.scene_cli"]
    code = ("import sys\n"
            + "".join(f"import mcbrat3d_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'mcbrat3d_tpu.'))]\n"
            "assert not bad, bad\n")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
