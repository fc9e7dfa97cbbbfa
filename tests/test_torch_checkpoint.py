"""PyTorch port: checkpoints and resume, against an uninterrupted run and
the JAX package's checkpoint files.

A run stopped after some batches, saved (``driver.checkpoint``) and
resumed gives the uninterrupted run's results: means within rtol 1e-12 and
standard errors within rtol 1e-9 (``tests/test_driver.py``'s
tolerances; the resumed run adds the checkpoint's float64 sums to its own
instead of carrying one compensated sum). Held on the step cloud through
``run_simulation`` (4,096 photons x 6 batches, stopped at 3, on the record
kernel's plain twin), through the command line (the deck's checkpointFile,
as ``tests/test_driver.py:252``), and on a 4-bin shortwave broadband deck
stopped after its first two bins' batches, whose resume builds no domain
for them. A file written by either package loads in the other with an
equal state.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mcbrat3d_tpu.core.accumulate import MomentAccumulator as JAcc
from mcbrat3d_tpu.driver import checkpoint as jckpt
from mcbrat3d_tpu_torch.core.accumulate import (DeviceMomentAccumulator,
                                                MomentAccumulator)
from mcbrat3d_tpu_torch.driver import checkpoint as ckpt
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.driver.config import SimulationConfig, load_config
from mcbrat3d_tpu_torch.driver.run import run_simulation
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import broadband
from mcbrat3d_tpu_torch.tools.sw_inputs import write_sw_broadband_inputs

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
MEAN_RTOL, STDERR_RTOL = 1e-12, 1e-9


def assert_same_results(a, b):
    assert (a.total_photons, a.n_batches) == (b.total_photons, b.n_batches)
    assert sorted(a.mean) == sorted(b.mean)
    for k in a.mean:
        np.testing.assert_allclose(a.mean[k], b.mean[k], rtol=MEAN_RTOL,
                                   err_msg=k)
        np.testing.assert_allclose(a.stderr[k], b.stderr[k],
                                   rtol=STDERR_RTOL, err_msg=k)


def step_cfg(**kw):
    base = dict(num_photons_per_batch=4096, num_batches=6, iseed=7,
                n_lanes=1024, n_phase_intervals=501,
                report_volume_absorption=True)
    base.update(kw)
    return SimulationConfig(**base)


def test_resume_equals_uninterrupted_run(tmp_path):
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=501, device="cpu")
    sfc, src = Surface.lambertian(0.0), illumination.directional(0.5, 0.0)
    full = run_simulation(dom, sfc, src, step_cfg())
    path = str(tmp_path / "ck.npz")
    saved = []

    def save(b, acc, chunk):
        saved.append(b)
        assert isinstance(acc, DeviceMomentAccumulator)
        ckpt.save_checkpoint(path, b, acc, chunk)

    half = run_simulation(dom, sfc, src,
                          step_cfg(num_batches=3, checkpoint_every_batches=1),
                          checkpoint_cb=save)
    assert saved == [1, 2, 3] and half.n_batches == 3
    next_batch, acc, chunk = ckpt.load_checkpoint(path, with_meta=True)
    assert (next_batch, acc.n_batches, chunk) == (3, 3, 4096)
    resumed = run_simulation(dom, sfc, src, step_cfg(), accumulator=acc,
                             start_batch=next_batch,
                             resume_chunk_size=chunk)
    assert full.n_bad == 0
    assert "volume_absorption" in full.mean
    assert_same_results(resumed, full)
    with pytest.raises(ValueError, match="chunk size 2048"):
        run_simulation(dom, sfc, src, step_cfg(), accumulator=acc,
                       start_batch=next_batch, resume_chunk_size=2048)


def test_checkpoint_files_interchange(tmp_path):
    """The same keys both ways: JAX's loader reads the port's file (the
    moments of a DeviceMomentAccumulator with a resume base), the port's
    reads JAX's, each giving an equal state."""
    r = np.random.RandomState(3)
    base = MomentAccumulator()
    dacc = DeviceMomentAccumulator(base=base)
    jacc = JAcc()
    for i in range(4):
        arrays = {"flux_up": r.rand(4, 3), "mean_flux_up": r.rand()}
        w = 1000.0 + i
        if i == 0:
            base.add(w, arrays)
        else:
            dacc.add(w, {k: torch.as_tensor(np.asarray(v))
                         for k, v in arrays.items()})
        jacc.add(w, arrays)
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    ckpt.save_checkpoint(port_file, 4, dacc, 4096)
    jckpt.save_checkpoint(jax_file, 4, jacc, 4096)
    jb, jloaded, jchunk = jckpt.load_checkpoint(port_file, with_meta=True)
    pb, ploaded, pchunk = ckpt.load_checkpoint(jax_file, with_meta=True)
    assert (jb, jchunk, pb, pchunk) == (4, 4096, 4, 4096)
    for got in (jloaded.state_dict(), ploaded.state_dict()):
        want = jacc.state_dict()
        assert (got["n_batches"], sorted(got["sum_wx"])) == (
            want["n_batches"], sorted(want["sum_wx"]))
        assert got["sum_w"] == pytest.approx(want["sum_w"], rel=1e-15)
        for key in ("sum_wx", "sum_wx2"):
            for name in want[key]:
                np.testing.assert_allclose(got[key][name], want[key][name],
                                           rtol=1e-14)
    # a MomentAccumulator round-trips bit for bit
    ckpt.save_checkpoint(port_file, 4, ploaded, 4096)
    again = ckpt.load_checkpoint(port_file)[1].state_dict()
    for name, v in ploaded.state_dict()["sum_wx2"].items():
        np.testing.assert_array_equal(again["sum_wx2"][name], v)


def _deck(tmp_path, dom, n_batches, out, ck=None):
    ck_lines = (f"  checkpointFile = '{ck}'\n"
                "  checkpointEveryBatches = 1\n") if ck else ""
    p = tmp_path / f"r{n_batches}{bool(ck)}.nml"
    p.write_text(f"""
&radiativeTransfer
  solarMu = 0.5
/
&monteCarlo
  numPhotonsPerBatch = 4096
  numBatches = {n_batches}
  iseed = 7
  nPhaseIntervals = 501
{ck_lines}/
&algorithms
  nLanes = 1024
/
&fileNames
  domainFileName = '{dom}'
  outputNetcdfFile = '{out}'
/
""")
    return str(p)


def test_cli_resume_via_namelist(tmp_path, capsys):
    """checkpointFile / checkpointEveryBatches: a second invocation
    resumes from the saved state and matches an uninterrupted run."""
    dom = str(tmp_path / "step.dom")
    assert cli.main(["mkdomain", "step_cloud", dom, "ssa=0.99"]) == 0
    ck = str(tmp_path / "run.ck.npz")
    full_nc, res_nc = str(tmp_path / "full.nc"), str(tmp_path / "res.nc")
    lines = []
    for n, out, with_ck in ((4, full_nc, None), (2, "x.nc", ck),
                            (4, res_nc, ck)):
        capsys.readouterr()
        out = out if out != "x.nc" else str(tmp_path / out)
        deck = _deck(tmp_path, dom, n, out, with_ck)
        assert cli.main(["run", deck, "--device", "cpu"]) == 0
        lines.append(json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]))
    assert ckpt.load_checkpoint(ck)[0] == 4
    assert lines[1]["n_batches"] == 2
    assert lines[2]["total_photons"] == lines[0]["total_photons"] == 4 * 4096
    for k in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed"):
        assert lines[2][k] == pytest.approx(lines[0][k], rel=MEAN_RTOL)
    with netcdf_file(full_nc, "r", mmap=False) as a, \
            netcdf_file(res_nc, "r", mmap=False) as b:
        for v in ("fluxUp", "fluxDown", "fluxAbsorbed"):
            np.testing.assert_allclose(np.array(b.variables[v][:]),
                                       np.array(a.variables[v][:]),
                                       rtol=MEAN_RTOL)


class _Stop(Exception):
    pass


def test_broadband_resume_skips_covered_bins(tmp_path, monkeypatch):
    """A 4-bin, 8 x 8 x 8 cut of run/broadband_sw.nml (record kernel's
    plain twin) stopped after the global batch that ends its second bin
    with photons, then resumed: equal to the uninterrupted run, and the
    resumed run builds no domain for the bins the checkpoint covers."""
    write_sw_broadband_inputs(str(tmp_path), n=8, n_lambda=4)
    with open(os.path.join(ROOT, "run", "broadband_sw.nml")) as f:
        deck = f.read()
    for a, b in (("numLambda = 16", "numLambda = 4"),
                 ("numPhotonsPerBatch = 262144", "numPhotonsPerBatch = 1024"),
                 ("numBatches = 16", "numBatches = 4"),
                 ("nPhaseIntervals = 9001", "nPhaseIntervals = 201"),
                 ("nLanes = 65536", "nLanes = 512"),
                 ("common_sw.nc", str(tmp_path / "common_sw.nc")),
                 ("ssp_solar.nc", str(tmp_path / "ssp_solar.nc")),
                 ("'solar.nc'", f"'{tmp_path / 'solar.nc'}'")):
        assert a in deck, a
        deck = deck.replace(a, b)
    (tmp_path / "deck.nml").write_text(deck)
    cfg = load_config(str(tmp_path / "deck.nml"))
    built = []
    build = broadband.components_from_ssp

    def counting(common, ssp, li, **kw):
        built.append(li)
        return build(common, ssp, li, **kw)

    monkeypatch.setattr(broadband, "components_from_ssp", counting)
    run_cfg = dataclasses.replace(cfg, checkpoint_every_batches=1)
    ends = []  # (global batches done, bins built so far) after each batch
    full = broadband.run_broadband(
        run_cfg, "cpu",
        checkpoint_cb=lambda b, acc, chunk: ends.append((b, list(built))))
    bins = list(built)
    assert len(bins) == len(set(bins)) >= 3, bins
    assert full.n_bad == 0 and ends[-1][0] == full.n_batches
    # stop after the last batch of the second bin with photons
    stop_at = max(b for b, seen in ends if len(seen) <= 2)
    path = str(tmp_path / "ck.npz")

    def save_then_stop(b, acc, chunk):
        ckpt.save_checkpoint(path, b, acc, chunk)
        if b == stop_at:
            raise _Stop

    built.clear()
    with pytest.raises(_Stop):
        broadband.run_broadband(run_cfg, "cpu", checkpoint_cb=save_then_stop)
    assert built == bins[:2]
    next_batch, acc, chunk = ckpt.load_checkpoint(path, with_meta=True)
    assert next_batch == stop_at and chunk == 1024
    built.clear()
    resumed = broadband.run_broadband(cfg, "cpu", accumulator=acc,
                                      start_batch=next_batch,
                                      resume_chunk_size=chunk)
    assert built == bins[2:]
    assert resumed.solar_flux == full.solar_flux
    assert_same_results(resumed, full)
