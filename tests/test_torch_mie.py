"""PyTorch port: the host native libraries and the Mie table toolchain
against the JAX package.

* ``sources.illumination.walker_alias`` (``csrc/host/alias.cpp``) equals
  its plain version ``_walker_alias`` and the JAX package's
  ``native/alias.cpp`` result bit for bit on a seeded 10^5-entry
  distribution; an all-zero or empty one takes the plain rule, as JAX's
  does; a source that does not compile raises.
* ``physics.refractive`` equals JAX's bit for bit; ``physics.mie``'s native
  and NumPy series equal JAX's within rtol 1e-12 (both builds of mie.cpp
  use the same g++ flags, so they agree bit for bit on one machine).
* ``tools.mie_table`` (centre-wavelength and band-averaged) and
  ``tools.ssp_create`` (one worker process) equal JAX's on the same inputs:
  arrays within rtol 1e-6, integer indices equal; the ``mie`` and
  ``mkssp`` subcommands write files that JAX's readers read.
"""

import numpy as np
import pytest

from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.domain import ssp as jssp
from mcbrat3d_tpu.physics import mie as jmie
from mcbrat3d_tpu.physics import refractive as jref
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.tools import mie_table as jmt
from mcbrat3d_tpu.tools import ssp_create as jsc
from mcbrat3d_tpu_torch import _build
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.physics import mie, refractive
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.tools import mie_table, ssp_create

RTOL = 1e-6


def test_native_alias_bit_equal():
    p = np.random.RandomState(11).rand(100_000)
    p[::7] = 0.0
    prob, alias = illumination.walker_alias(p)
    pprob, palias = illumination._walker_alias(p)
    jprob, jalias = jill._walker_alias(p)
    assert jill._ALIAS_NATIVE is not None, "native/alias.cpp did not build"
    for got in ((pprob, palias), (jprob, jalias)):
        np.testing.assert_array_equal(prob, got[0])
        np.testing.assert_array_equal(alias, got[1])
    for q in (np.zeros(6), np.zeros(0)):
        for a, b in zip(illumination.walker_alias(q), jill._walker_alias(q)):
            np.testing.assert_array_equal(a, b)


def test_failed_host_build_raises(tmp_path, monkeypatch):
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "alias.cpp").write_text("not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(illumination, "_ALIAS_FN", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on host/alias.cpp"):
        illumination.walker_alias(np.ones(4))
    assert not list((tmp_path / "build").glob("*.so"))


def test_refractive_index_equals_jax():
    lam_w = np.r_[np.geomspace(0.2, 1000.0, 41), 2000.0, 3e4, 1e5]
    lam_i = np.r_[np.geomspace(0.045, 167.0, 37), 500.0, 1e4, 8e6]
    for t in (250.0, 283.0, 300.0):
        np.testing.assert_array_equal(refractive.refwat(lam_w, t),
                                      jref.refwat(lam_w, t))
    for t in (200.0, 243.0, 260.0, 280.0):
        np.testing.assert_array_equal(refractive.refice(lam_i, t),
                                      jref.refice(lam_i, t))
    assert refractive.refractive_index("W", 0.67) == \
        jref.refractive_index("W", 0.67)
    with pytest.raises(ValueError):
        refractive.refwat(0.1)


@pytest.mark.parametrize("m", [complex(1.33, -1e-8), complex(1.2, -0.05),
                               complex(1.78, -0.004)])
def test_mie_batch_equals_jax(m):
    x = np.r_[0.05, np.linspace(0.5, 60.0, 24), 180.0]
    mu = np.polynomial.legendre.leggauss(96)[0]
    native = mie.mie_batch(x, m, mu)
    for got, want in zip(native, jmie.mie_batch(x, m, mu)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    plain = mie.mie_batch(x, m, mu, force_numpy=True)
    for got, want in zip(plain,
                         jmie.mie_batch(x, m, mu, force_numpy=True)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # the native series against its plain version
    for got, want in zip(native, plain):
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def assert_tables_equal(got, want):
    assert got.n_entries == want.n_entries
    np.testing.assert_allclose(got.key, want.key, rtol=RTOL)
    np.testing.assert_allclose(got.extinction, want.extinction, rtol=RTOL)
    np.testing.assert_allclose(got.single_scattering_albedo,
                               want.single_scattering_albedo, rtol=RTOL)
    for a, b in zip(got.phase_functions, want.phase_functions):
        assert a.coefficients.size == b.coefficients.size
        np.testing.assert_allclose(a.coefficients, b.coefficients,
                                   rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(wavelen1=0.67, partype="W", sretab=5.0, eretab=15.0, nretanb=3,
         maxradius=30.0),
    dict(wavelen1=10.0, wavelen2=11.0, avgflag="A", deltawave=0.5,
         partype="W", sretab=8.0, eretab=8.0, nretanb=1, maxradius=25.0,
         max_legendre=64),
    dict(wavelen1=3.7, partype="I", distflag="L", alpha=0.4, sretab=10.0,
         eretab=20.0, nretanb=2, maxradius=40.0, max_legendre=256)])
def test_mie_table_equals_jax(kw):
    assert_tables_equal(mie_table.make_mie_table(mie_table.MieTableConfig(
        **kw)), jmt.make_mie_table(jmt.MieTableConfig(**kw)))


def test_ssp_create_equals_jax():
    kw = dict(lambdas_um=[0.55, 0.87], sretab=6.0, eretab=12.0, n_reff=3,
              maxradius=25.0, surface_albedo=[0.1, 0.2])
    got = ssp_create.create_ssp_table(
        ssp_create.SSPCreateConfig(n_workers=1, **kw))
    want = jsc.create_ssp_table(jsc.SSPCreateConfig(**kw))
    np.testing.assert_allclose(got.freq_hz, want.freq_hz, rtol=RTOL)
    np.testing.assert_allclose(got.surface_albedo, want.surface_albedo)
    (g,), (w,) = got.components, want.components
    for f in ("key", "extinction", "ssa", "legendre_coeffs"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=RTOL,
                                   atol=1e-12, err_msg=f)
    for f in ("legendre_start", "legendre_length"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_mie_and_mkssp_subcommands_write_jax_readable_files(tmp_path,
                                                            capsys):
    nml = tmp_path / "mie.nml"
    out = tmp_path / "water.pft"
    nml.write_text(f"""&mie_table_input
  wavelen1 = 0.67
  partype = 'W'
  distflag = 'G'
  alpha = 7.0
  nretab = 2
  sretab = 5.0
  eretab = 10.0
  maxradius = 25.0
  mietabfile = '{out}'
/
""")
    assert cli.main(["mie", str(nml)]) == 0
    want = jmt.make_mie_table(jmt.MieTableConfig(
        wavelen1=0.67, nretanb=2, sretab=5.0, eretab=10.0, maxradius=25.0))
    assert_tables_equal(jio.read_phase_function_table_file(str(out)), want)
    ssp_out = tmp_path / "ssp.nc"
    (tmp_path / "ssp.nml").write_text(f"""&ssp_input
  lambdas = 0.55, 0.67
  sretab = 6.0
  eretab = 9.0
  nretab = 2
  maxradius = 20.0
  surfacealbedo = 0.05
  sspfile = '{ssp_out}'
/
""")
    assert cli.main(["mkssp", str(tmp_path / "ssp.nml")]) == 0
    table = jssp.read_ssp_table(str(ssp_out))
    assert table.n_lambda == 2
    np.testing.assert_allclose(table.lambdas_um, [0.55, 0.67], rtol=1e-6)
    np.testing.assert_allclose(table.surface_albedo, [0.05, 0.05])
    assert table.components[0].extinction.shape == (2, 2)
