"""PyTorch port end to end through its command line, on the CPU.

``mkdomain step_cloud`` then ``run`` a namelist deck with ``--device cpu``:
the output files must carry the JAX driver's schema, the domain means must
match the frozen step-cloud goldens, and the port must not import JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from mcbrat3d_tpu.domain import io_netcdf as jio
from mcbrat3d_tpu.driver import output as joutput
from mcbrat3d_tpu.driver.config import load_config as jload
from mcbrat3d_tpu.driver.run import Results as JResults
from mcbrat3d_tpu_torch.driver import cli
from mcbrat3d_tpu_torch.driver.config import load_config
from mcbrat3d_tpu_torch.driver.simulate import simulate_from_config

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
GOLDEN_RTA = (0.47656, 0.32485, 0.19860)  # tests/test_golden.py (0.99, 0.5)


def write_deck(path, n_per_batch, n_batches):
    with open(os.path.join(ROOT, "run", "step_cloud_mono.nml")) as f:
        text = f.read()
    text = text.replace("numPhotonsPerBatch = 1048576",
                        f"numPhotonsPerBatch = {n_per_batch}")
    text = text.replace("numBatches = 16", f"numBatches = {n_batches}")
    with open(path, "w") as f:
        f.write(text)


def run_cli(tmp_path, capsys, n_per_batch, n_batches, *scene_params):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(["mkdomain", "step_cloud", "StepCloud.dom",
                         "ssa=0.99", *scene_params]) == 0
        write_deck("deck.nml", n_per_batch, n_batches)
        capsys.readouterr()
        assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        os.chdir(cwd)


def jax_results_from_port_files(run_dir, cfg):
    """A JAX driver Results holding the numbers of the port's output
    files, so the JAX writers can produce their version of them."""
    mean, err = {}, {}
    with netcdf_file(os.path.join(run_dir, "StepCloud_results.nc"), "r",
                     mmap=False) as nc:
        v = nc.variables
        for key, name in (("flux_up", "fluxUp"), ("flux_down", "fluxDown"),
                          ("flux_absorbed", "fluxAbsorbed"),
                          ("volume_absorption", "absorbedVolume"),
                          ("absorption_profile", "absorptionProfile")):
            mean[key] = np.array(v[name][:]).T
            err[key] = np.array(v[name + "_StdErr"][:]).T
        total = int(nc.totalPhotons)
        n_batches = int(nc.numBatches)
    with open(os.path.join(run_dir, "StepCloud_flux.out")) as f:
        means = [ln for ln in f if not ln.startswith("!")][0].split()
    for i, key in enumerate(("mean_flux_up", "mean_flux_down",
                             "mean_flux_absorbed")):
        mean[key], err[key] = float(means[2 * i]), float(means[2 * i + 1])
    return JResults(mean=mean, stderr=err, total_photons=total,
                    n_batches=n_batches, solar_flux=1.0, elapsed_seconds=0.0,
                    config=cfg)


def test_cli_outputs_have_the_jax_schema(tmp_path, capsys):
    out = run_cli(tmp_path, capsys, 1 << 15, 2)
    assert out["total_photons"] == 2 << 15 and out["n_batches"] == 2
    assert out["n_bad"] == 0
    jdir = tmp_path / "jax"
    jdir.mkdir()
    cfg = jload(str(tmp_path / "deck.nml"))
    grid = jio.read_domain(str(tmp_path / "StepCloud.dom"))[0]
    results = jax_results_from_port_files(str(tmp_path), cfg)
    cwd = os.getcwd()
    os.chdir(jdir)
    try:
        written = joutput.write_all(results, grid)
    finally:
        os.chdir(cwd)
    assert sorted(written) == sorted(out["outputs"])
    with open(tmp_path / "StepCloud_flux.out") as f:
        port_text = f.read()
    with open(jdir / "StepCloud_flux.out") as f:
        assert port_text == f.read()
    with netcdf_file(str(tmp_path / "StepCloud_results.nc"), "r",
                     mmap=False) as a, \
            netcdf_file(str(jdir / "StepCloud_results.nc"), "r",
                        mmap=False) as b:
        assert dict(a.dimensions) == dict(b.dimensions)
        assert sorted(a.variables) == sorted(b.variables)
        for name in a.variables:
            assert a.variables[name].dimensions == \
                b.variables[name].dimensions
            np.testing.assert_array_equal(a.variables[name][:],
                                          b.variables[name][:])
        assert sorted(a._attributes) == sorted(b._attributes)


def test_cli_radiance_outputs_have_the_jax_schema(tmp_path, capsys):
    """run/step_cloud_radiance.nml at 2 x 1,024 photons (with a netCDF
    output added): the radiance file and the netCDF intensity variables
    equal what the JAX writers make of the same numbers."""
    with open(os.path.join(ROOT, "run", "step_cloud_radiance.nml")) as f:
        text = f.read()
    text = text.replace("numPhotonsPerBatch = 262144",
                        "numPhotonsPerBatch = 1024")
    text = text.replace("numBatches = 8", "numBatches = 2")
    text = text.replace("&fileNames\n", "&fileNames\n  outputNetcdfFile = "
                        "'StepCloud_radiance.nc'\n")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(["mkdomain", "step_cloud", "StepCloud.dom",
                         "ssa=0.99"]) == 0
        with open("deck.nml", "w") as f:
            f.write(text)
        capsys.readouterr()
        assert cli.main(["run", "deck.nml", "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        os.chdir(cwd)
    assert out["total_photons"] == 2048 and out["n_bad"] == 0
    assert len(out["mean_intensity"]) == 6
    assert min(out["mean_intensity"]) > 0
    cfg = jload(str(tmp_path / "deck.nml"))
    mean, err = {}, {}
    with netcdf_file(str(tmp_path / "StepCloud_radiance.nc"), "r",
                     mmap=False) as nc:
        v = nc.variables
        for key, name in (("flux_up", "fluxUp"), ("flux_down", "fluxDown"),
                          ("flux_absorbed", "fluxAbsorbed"),
                          ("intensity", "intensity")):
            mean[key] = np.array(v[name][:]).T
            err[key] = np.array(v[name + "_StdErr"][:]).T
        assert mean["intensity"].shape == (32, 1, 6)
        total, n_batches = int(nc.totalPhotons), int(nc.numBatches)
    results = JResults(mean=mean, stderr=err, total_photons=total,
                       n_batches=n_batches, solar_flux=1.0,
                       elapsed_seconds=0.0, config=cfg)
    grid = jio.read_domain(str(tmp_path / "StepCloud.dom"))[0]
    jdir = tmp_path / "jax"
    jdir.mkdir()
    os.chdir(jdir)
    try:
        written = joutput.write_all(results, grid)
    finally:
        os.chdir(cwd)
    assert sorted(written) == sorted(out["outputs"])
    with open(tmp_path / "StepCloud_radiance.out") as f:
        port_text = f.read()
    with open(jdir / "StepCloud_radiance.out") as f:
        assert port_text == f.read()
    with netcdf_file(str(tmp_path / "StepCloud_radiance.nc"), "r",
                     mmap=False) as a, \
            netcdf_file(str(jdir / "StepCloud_radiance.nc"), "r",
                        mmap=False) as b:
        assert dict(a.dimensions) == dict(b.dimensions)
        assert sorted(a.variables) == sorted(b.variables)
        for name in a.variables:
            assert a.variables[name].dimensions == \
                b.variables[name].dimensions
            np.testing.assert_array_equal(a.variables[name][:],
                                          b.variables[name][:])


def test_cli_cuda_without_a_card_raises(monkeypatch):
    """--device cuda (the default) never falls back to the CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck = os.path.join(ROOT, "run", "step_cloud_radiance.nml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", deck, "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", deck])


def test_cli_matches_step_cloud_goldens(tmp_path, capsys):
    """2^18 photons through the deck against the goldens, with
    tests/test_golden.py's 4.5-sigma formula. The domain file stores the
    HG phase function as Legendre moments, so the run samples a tabulated
    inverse CDF; 512 moments keep that table within 1e-4 of analytic HG
    in R (the default 64 shift R by -1.9e-3, in the JAX package too)."""
    out = run_cli(tmp_path, capsys, 1 << 18, 1, "n_legendre=512")
    n = out["total_photons"]
    assert n == 1 << 18 and out["n_bad"] == 0
    got = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    for g, want, name in zip(got, GOLDEN_RTA, "RTA"):
        sigma = np.sqrt(max(want * (1 - want), 1e-8) / n) + 8e-5
        assert g == pytest.approx(want, abs=4.5 * sigma), name


@pytest.mark.parametrize("deck", ["step_cloud_mono.nml", "broadband_lw.nml"])
def test_checkpoint_decks_raise(deck, tmp_path):
    """A deck whose checkpointFile was written with another batch size is
    refused, monochromatic or broadband, before any batch runs (the
    broadband deck before it reads its inputs): batch b's streams depend
    on the batch size, so such a resume would redo or skip photons."""
    ck = str(tmp_path / "run.ckpt.npz")
    np.savez(ck, next_batch=np.int64(2), chunk_size=np.int64(12345),
             sum_w=np.float64(24690.0), n_batches=np.int64(2))
    cfg = dataclasses.replace(load_config(os.path.join(ROOT, "run", deck)),
                              checkpoint_file=ck,
                              checkpoint_every_batches=2)
    if not cfg.is_longwave:
        dom = str(tmp_path / "StepCloud.dom")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["mkdomain", "step_cloud", dom]) == 0
        cfg = dataclasses.replace(cfg, domain_file=dom)
    with pytest.raises(ValueError, match="chunk size 12345"):
        simulate_from_config(cfg, "cpu")


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import mcbrat3d_tpu_torch.driver.cli\n"
            "import mcbrat3d_tpu_torch.driver.simulate\n"
            "import mcbrat3d_tpu_torch.transport.record_kernel\n"
            "import mcbrat3d_tpu_torch.scenes.plane_parallel\n"
            "import mcbrat3d_tpu_torch.scenes.collection\n"
            "import mcbrat3d_tpu_torch.spectral.broadband\n"
            "import mcbrat3d_tpu_torch.transport.sep_kernel\n"
            "import mcbrat3d_tpu_torch.transport.tile_kernel\n"
            "import mcbrat3d_tpu_torch.physics.rayleigh\n"
            "import mcbrat3d_tpu_torch.parallel.distributed\n"
            "import mcbrat3d_tpu_torch.parallel.launch\n"
            "import mcbrat3d_tpu_torch.parallel.mesh\n"
            "import mcbrat3d_tpu_torch._build\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'mcbrat3d_tpu.'))]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
