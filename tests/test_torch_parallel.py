"""PyTorch port: photon data-parallel batches over torch.distributed ranks
(``mcbrat3d_tpu_torch.parallel``), on gloo ranks on the CPU.

The counterparts of ``tests/test_parallel.py`` (an n-rank global batch
equals the sum of the n correspondingly numbered serial sub-batches, on the
wave kernel and on the record kernel's plain twin, within that test's rtol
1e-6; conservation; the exact global photon count; direction-chunked
radiance) and of ``tests/test_multihost.py`` (every rank holds the same
tallies bit for bit; four ranks equal four serial sub-batches; the host
moment merge). The wave kernel's 2-rank batch is held against the JAX
package's ``run_batch_sharded`` on two CPU devices path for path (equal
photons, steps and bad photons; flux tallies within the wave kernel's 1%
L1 and 0.2% total, ``tests/test_torch_wave_kernel.py``). The drivers over
two ranks equal their serial reconstructions (batch b is the sum of
sub-batches 2b and 2b + 1): ``run_simulation`` within 1e-12 on every mean,
``run_broadband`` too; the command line under two ranks writes its files
and prints its JSON line once, from rank 0.

The ranks are started once per group size (``launch.spawn``; the rank
functions are in ``tests/torch_parallel_worker.py``, which imports no
JAX); each rank also runs a plain sub-batch of another rank's stream, so
the serial references run in parallel too.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from mcbrat3d_tpu.driver.config import SimulationConfig as JSimulationConfig
from mcbrat3d_tpu.driver.run import kernel_config_from as jkernel_config_from
from mcbrat3d_tpu.parallel import mesh as jmesh
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake_step_cloud
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport.integrator import KernelConfig as JKernelConfig
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.accumulate import (DeviceMomentAccumulator,
                                                MomentAccumulator)
from mcbrat3d_tpu_torch.driver import checkpoint as ckpt
from mcbrat3d_tpu_torch.driver import cli, simulate
from mcbrat3d_tpu_torch.driver.run import kernel_config_from, run_simulation
from mcbrat3d_tpu_torch.parallel import distributed, launch
from mcbrat3d_tpu_torch.parallel import mesh as pmesh
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.step_cloud import (make_step_cloud,
                                                   make_step_cloud_multi)
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.spectral import broadband
from mcbrat3d_tpu_torch.tools.sw_inputs import write_sw_broadband_inputs
from mcbrat3d_tpu_torch.transport.integrator import run_batch
from mcbrat3d_tpu_torch.transport import local_estimate as le

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SUBBATCH_RTOL = 1e-6  # tests/test_parallel.py's
CONSERVATION_RTOL = 1e-5
MEAN_RTOL, STDERR_RTOL = 1e-12, 1e-9  # tests/test_multihost.py's
L1_GAP, TOTAL_GAP = 1e-2, 2e-3  # tests/test_torch_wave_kernel.py's
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


def fake_group(n):
    """A PhotonGroup of n ranks for the refusals, which raise before any
    collective."""
    return pmesh.PhotonGroup(rank=0, size=n,
                             device=torch.device("cpu"))


def summed(parts):
    """The sum of host tallies (``w.host``'s dicts)."""
    out = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out[k] + v if k in out else v
    return out


def serial_sum(domain, surface, source, seed, global_batch, config, mesh,
               icfg=None, idirs=None, n_photons=None):
    """``run_batch_sharded``'s global batch as one process's serial
    sub-batches ``global_batch * n + d``, summed (the reconstruction)."""
    n, parts = mesh.size, []
    for d in range(n):
        stream = global_batch * n + d
        local = None if n_photons is None else \
            n_photons // n + int(d < n_photons % n)
        parts.append(run_batch(domain, surface, source,
                               rng.batch_seed(seed, stream), config,
                               n_photons=local, intensity_config=icfg,
                               intensity_dirs=idirs,
                               key=rng.batch_key(seed, stream)))
    fields = {k: sum(getattr(t, k) for t in parts)
              for k in pmesh.TALLY_FIELDS + pmesh.COUNT_FIELDS
              if getattr(parts[0], k) is not None}
    return dataclasses.replace(parts[0], **fields)


def assert_same_results(got, want):
    assert (got["total_photons"], got["n_batches"], got["n_bad"]) == (
        want.total_photons, want.n_batches, want.n_bad)
    assert sorted(got["mean"]) == sorted(want.mean)
    for k in want.mean:
        np.testing.assert_allclose(got["mean"][k], want.mean[k],
                                   rtol=MEAN_RTOL, err_msg=k)
        np.testing.assert_allclose(got["stderr"][k], want.stderr[k],
                                   rtol=STDERR_RTOL, err_msg=k)


@pytest.fixture(scope="module")
def deck_dir(tmp_path_factory):
    """A 4-bin, 8 x 8 x 8 cut of run/broadband_sw.nml (sw.nml) and a
    2-batch step-cloud deck (step.nml, StepCloud.dom)."""
    d = tmp_path_factory.mktemp("decks")
    write_sw_broadband_inputs(str(d), n=8, n_lambda=4)
    with open(os.path.join(ROOT, "run", "broadband_sw.nml")) as f:
        deck = f.read()
    for a, b in (("numLambda = 16", "numLambda = 4"),
                 ("numPhotonsPerBatch = 262144", "numPhotonsPerBatch = 256"),
                 ("numBatches = 16", "numBatches = 4"),
                 ("nPhaseIntervals = 9001", "nPhaseIntervals = 201"),
                 ("nLanes = 65536", "nLanes = 128"),
                 ("common_sw.nc", str(d / "common_sw.nc")),
                 ("ssp_solar.nc", str(d / "ssp_solar.nc")),
                 ("'solar.nc'", f"'{d / 'solar.nc'}'")):
        assert a in deck, a
        deck = deck.replace(a, b)
    (d / "sw.nml").write_text(deck)
    assert cli.main(["mkdomain", "step_cloud", str(d / "StepCloud.dom"),
                     "ssa=0.99"]) == 0
    (d / "step.nml").write_text(f"""
&radiativeTransfer
  solarMu = 0.5
/
&monteCarlo
  numPhotonsPerBatch = 512
  numBatches = 2
  iseed = 7
  nPhaseIntervals = 501
/
&algorithms
  nLanes = 256
/
&fileNames
  domainFileName = '{d / "StepCloud.dom"}'
  outputFluxFile = '{d / "step_flux.out"}'
  outputNetcdfFile = '{d / "step.nc"}'
/
""")
    return str(d)


@pytest.fixture(scope="module")
def two(deck_dir):
    return launch.spawn(w.two_rank_cases, 2, "cpu", backend="gloo",
                        args=(deck_dir,), timeout=300)


@pytest.fixture(scope="module")
def four():
    return launch.spawn(w.four_rank_cases, 4, "cpu", backend="gloo",
                        timeout=300)


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is None
    assert distributed.initialize(device="cpu") is None
    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert pmesh.resolve_mesh("auto") is None
    assert pmesh.resolve_mesh(None) is None
    group = fake_group(2)
    assert pmesh.resolve_mesh(group) is group
    with pytest.raises(ValueError, match="needs a process group"):
        pmesh.make_mesh()


def test_is_master_without_a_group():
    assert distributed.is_master()
    distributed.synchronize()  # no barrier for one process
    distributed.shutdown()
    assert distributed.device() is None


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """Two NCCL ranks on a host without a card: refused before the group
    forms, naming both numbers."""
    env = dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT="29517")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"2 ranks .* {cards} CUDA cards"):
        distributed.initialize()
    assert not distributed.is_initialized()


@pytest.mark.parametrize("kernel", ["wave", "k1"])
def test_sharded_equals_serial_subbatches(two, kernel):
    """Rank d ran stream 3 * 2 + d: the sharded batch equals the sum of the
    two serial sub-batches (each run plainly by the other rank)."""
    assert [r["mesh"] for r in two] == [(0, 2, "cpu"), (1, 2, "cpu")]
    streams = sorted(r[kernel + "_serial"][0] for r in two)
    assert streams == [6, 7]
    serial = summed(r[kernel + "_serial"][1] for r in two)
    got = two[0][kernel]
    assert got["n_photons"] == serial["n_photons"] == 2 * 256
    for k in ("n_steps", "n_lane_steps", "n_bad"):
        assert got[k] == serial[k], k
    assert sorted(k for k in got if k in pmesh.TALLY_FIELDS) == sorted(
        k for k in serial if k in pmesh.TALLY_FIELDS)
    for k in pmesh.TALLY_FIELDS:
        if k in got:
            np.testing.assert_allclose(got[k], serial[k],
                                       rtol=SUBBATCH_RTOL, err_msg=k)


def test_sharded_conservation(two):
    t = two[0]["conservation"]
    total = float(t["flux_up"].sum()) + float(t["flux_down"].sum())
    np.testing.assert_allclose(total, t["n_photons"], rtol=CONSERVATION_RTOL)


def test_sharded_n_photons_exact(two):
    assert [r["n_requested"]["n_photons"] for r in two] == [w.N_REQUESTED] * 2


@pytest.mark.parametrize("case", ["capacity", "no_forward_tables"])
def test_sharded_refusals(case):
    """JAX's refusals, raised before any transport or collective."""
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=201, device="cpu")
    args = (dom, Surface.lambertian(0.0), illumination.directional(0.5, 0.0),
            0, 0, w.config("on"), fake_group(2))
    if case == "capacity":
        with pytest.raises(ValueError, match="exceeds the group's capacity"):
            pmesh.run_batch_sharded(*args, n_photons=2 * 256 + 1)
    else:
        # the true Rayleigh phase function: a tabulated row, no tables
        dom = make_step_cloud_multi(analytic=False, n_cdf_steps=201,
                                    device="cpu")
        dirs = le.make_intensity_directions([1.0], [0.0], device="cpu")
        # under "auto" no kernel takes it and run_batch refuses it
        with pytest.raises(ValueError, match="no forward phase tables"):
            pmesh.run_batch_sharded(dom, *args[1:5], w.config("auto"),
                                    args[6], le.IntensityConfig(n_dirs=1),
                                    dirs)


def test_sharded_dir_chunked_radiance(two):
    """Four directions past MAX_KERNEL_DIRS = 2: the last chunk's image and
    the fluxes equal the two-direction pass's."""
    four, pair = two[0]["chunked"]
    assert four["intensity"].shape[-1] == 4
    np.testing.assert_array_equal(four["intensity"][:, :, 2:],
                                  pair["intensity"])
    np.testing.assert_array_equal(four["flux_up"], pair["flux_up"])
    assert four["n_photons"] == pair["n_photons"] == 2 * 128


def test_sharded_wave_kernel_matches_jax(two):
    """JAX's run_batch_sharded on two CPU devices (the XLA path) against the
    port's two ranks on the wave kernel, same seed and global batch."""
    import jax
    mesh = jmesh.make_mesh(jax.devices()[:2])
    case = w.STEP
    jt = jmesh.run_batch_sharded(
        jmake_step_cloud(ssa=case["ssa"]),
        JSurface.lambertian(case["surface"]),
        jill.directional(case["mu"], 0.0), seed=case["seed"],
        global_batch=case["batch"],
        config=JKernelConfig(n_lanes=256, photons_per_lane=1, max_steps=4000,
                             use_pallas="off"), mesh=mesh)
    pt = two[0]["wave"]
    assert (int(jt.n_photons), int(jt.n_steps), int(jt.n_bad)) == (
        pt["n_photons"], pt["n_steps"], pt["n_bad"])
    for f in ("flux_up", "flux_down", "flux_absorbed", "volume_absorption"):
        a = np.asarray(getattr(jt, f), np.float64)
        b = pt[f].astype(np.float64)
        total = max(np.abs(a).sum(), 1e-6)
        assert np.abs(a - b).sum() <= L1_GAP * total, f
        assert abs(a.sum() - b.sum()) <= TOTAL_GAP * total, f


def test_every_rank_sees_identical_tallies(four):
    first = four[0][0]
    assert first["n_photons"] == 4 * w.MULTIHOST.photons_per_batch
    for t, _, _ in four[1:]:
        assert sorted(t) == sorted(first)
        for k, v in t.items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


def test_four_ranks_equal_four_serial_subbatches(four):
    assert sorted(s for _, (s, _), _ in four) == [0, 1, 2, 3]
    serial = summed(local for _, (_, local), _ in four)
    got = four[0][0]
    for k in ("n_photons", "n_steps", "n_lane_steps", "n_bad"):
        assert got[k] == serial[k], k
    for k in ("flux_up", "flux_down", "flux_absorbed", "volume_absorption"):
        np.testing.assert_allclose(got[k], serial[k], rtol=SUBBATCH_RTOL,
                                   err_msg=k)


def test_moment_merge_reproduces_serial_accumulation(four):
    """MomentAccumulator.merge of the ranks' state_dicts (one batch of each
    process) against one accumulation of the same batches."""
    accs = [MomentAccumulator.from_state_dict(s) for _, _, s in four]
    merged = accs[0]
    for a in accs[1:]:
        merged.merge(a)
    serial = MomentAccumulator()
    for _, (_, local), _ in four:
        serial.add(float(local["n_photons"]),
                   {"flux_up": local["flux_up"].astype(np.float64)
                    / local["n_photons"]})
    assert merged.n_batches == serial.n_batches == 4
    np.testing.assert_allclose(merged.mean("flux_up"),
                               serial.mean("flux_up"), rtol=MEAN_RTOL)
    np.testing.assert_allclose(merged.stderr("flux_up"),
                               serial.stderr("flux_up"), rtol=STDERR_RTOL,
                               atol=0)


def test_run_simulation_equals_serial_reconstruction(two):
    """run_simulation over two ranks against batch b built here as the sum
    of sub-batches 2b and 2b + 1 (251 and 250 of the 501 photons)."""
    cfg = w.step_config()
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=501, device="cpu")
    sfc, src = Surface.lambertian(0.0), illumination.directional(0.5, 0.0)
    kcfg = kernel_config_from(cfg, n_devices=2)
    acc = DeviceMomentAccumulator()
    n_bad = 0
    for b in range(cfg.num_batches):
        t = serial_sum(dom, sfc, src, cfg.iseed, b, kcfg, fake_group(2),
                       n_photons=cfg.num_photons_per_batch)
        n_bad += t.n_bad
        acc.add_tallies(t, dom.grid)
    want = acc.finalize()
    got, chunks = two[0]["run_simulation"]
    assert chunks == [(b, 2 * 251) for b in (1, 2)]
    assert (got["total_photons"], got["n_batches"], got["n_bad"]) == (
        2 * 501, 2, n_bad)
    assert sorted(got["mean"]) == sorted(want._sum_wx)
    for k in want._sum_wx:
        np.testing.assert_allclose(got["mean"][k], want.mean(k),
                                   rtol=MEAN_RTOL, err_msg=k)
        np.testing.assert_allclose(got["stderr"][k], want.stderr(k),
                                   rtol=STDERR_RTOL, err_msg=k)
    for k, v in two[1]["run_simulation"][0]["mean"].items():
        np.testing.assert_array_equal(v, got["mean"][k], err_msg=k)


@pytest.mark.parametrize("driver", ["run_simulation", "run_broadband",
                                    "simulate_from_config"])
def test_resume_under_another_rank_count_raises(driver, deck_dir, tmp_path):
    """A checkpoint of one rank resumed over two, and one of two ranks
    resumed in one process, are refused before any transport. At 501
    photons a batch the chunk differs (512: 2 x 256 lanes, against 2 x
    251); at the main deck's 2^20 photons on 2^17 lanes it does not (2^17
    x 8 on one rank, 2 x 2^17 x 4 on two) and the rank count does: batch b
    of the one-rank run is stream b, of the two-rank run streams 2b and 2b
    + 1."""
    small = w.step_config()
    deck = w.step_config(num_photons_per_batch=1 << 20, n_lanes=1 << 17)
    assert kernel_config_from(small).photons_per_batch == 512
    assert kernel_config_from(deck).photons_per_batch == 2 * \
        kernel_config_from(deck, n_devices=2).photons_per_batch == 1 << 20
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=201, device="cpu")

    def resume(cfg, match):
        if driver == "simulate_from_config":
            # a two-rank checkpoint resumed by one process (mesh "auto")
            path = str(tmp_path / "run.ckpt.npz")
            ckpt.save_checkpoint(
                path, 1, MomentAccumulator(),
                2 * kernel_config_from(cfg, n_devices=2).photons_per_batch,
                n_ranks=2)
            run = lambda: simulate.simulate_from_config(dataclasses.replace(
                cfg, domain_file=os.path.join(deck_dir, "StepCloud.dom"),
                checkpoint_file=path), "cpu")
        else:
            # a one-rank checkpoint resumed over two ranks
            kw = dict(mesh=fake_group(2), accumulator=MomentAccumulator(),
                      start_batch=1, resume_ranks=1,
                      resume_chunk_size=kernel_config_from(
                          cfg).photons_per_batch)
            if driver == "run_simulation":
                run = lambda: run_simulation(
                    dom, Surface.lambertian(0.0),
                    illumination.directional(0.5, 0.0), cfg, **kw)
            else:
                run = lambda: broadband.run_broadband(dataclasses.replace(
                    w.broadband_deck(deck_dir),
                    num_photons_per_batch=cfg.num_photons_per_batch,
                    n_lanes=cfg.n_lanes), "cpu", **kw)
        with pytest.raises(ValueError, match=match):
            run()

    resume(small, "chunk size 5(12|02)")
    resume(deck, r"written by \d rank\(s\) but this run has \d")


def test_run_broadband_equals_serial_reconstruction(two, deck_dir,
                                                    monkeypatch):
    """The 4-bin SW cut over two ranks against run_broadband whose every
    chunk is the sum of the two serial sub-batches, run in this process."""
    monkeypatch.setattr(broadband, "run_batch_sharded", serial_sum)
    want = broadband.run_broadband(w.broadband_deck(deck_dir), "cpu",
                                   mesh=fake_group(2))
    assert want.total_photons == 4 * 256
    assert_same_results(two[0]["broadband"], want)


@pytest.mark.parametrize("photons,lanes,n", [
    (1_048_576, 65_536, 1), (1_048_576, 65_536, 4), (501, 256, 2),
    (1000, 4096, 3)])
def test_kernel_config_from_matches_jax(photons, lanes, n):
    kw = dict(num_photons_per_batch=photons, n_lanes=lanes)
    p = kernel_config_from(w.step_config(**kw), n_devices=n)
    j = jkernel_config_from(JSimulationConfig(**kw), n_devices=n)
    assert (p.n_lanes, p.photons_per_lane) == (j.n_lanes, j.photons_per_lane)
    assert p.photons_per_batch * n >= photons


def test_cli_under_two_ranks_writes_once(two, deck_dir):
    (rc0, lines0, writes0), (rc1, lines1, writes1) = (r["cli"] for r in two)
    assert (rc0, rc1) == (0, 0)
    assert (writes0, writes1) == (1, 0)
    assert lines1 == [] and len(lines0) == 1
    line = lines0[0]
    assert line["world_size"] == 2 and line["device"] == "cpu"
    assert (line["total_photons"], line["n_batches"]) == (2 * 512, 2)
    assert sorted(os.path.basename(f) for f in line["outputs"]) == [
        "step.nc", "step_flux.out"]
    for f in line["outputs"]:
        assert os.path.getsize(f) > 0, f


def test_dryrun_multichip(capsys):
    launch.dryrun_multichip(2, device="cpu", backend="gloo")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): OK, 512 photons" in out


def test_spawn_raises_and_stops_every_rank():
    """Rank 1 raises while rank 0 waits at a barrier it cannot pass: spawn
    raises with rank 1's traceback once both are stopped."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        launch.spawn(w.fail_on_rank_one, 2, "cpu", timeout=120)
    assert time.perf_counter() - t0 < 60
