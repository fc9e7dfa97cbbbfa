"""PyTorch port: the gather and tally probes P1-P5 against the TPU probe
kernels.

Each variant's plain twin (``mcbrat3d_tpu_torch.tools.probes``, what the
CUDA kernels are held against on the card by chip_smoke.py phase 5) against
its TPU probe kernel run by JAX in Pallas interpret mode, on the same numpy
inputs at a small size (8 rows of 128 lanes, 4 chained iterations; P1 at
its fixed 16 rows, P5 at 64 rows of indices). The probe tools are loaded
from their files, with PROBE_BLK and PROBE_INNER set first.

Float32 gathers are equal exactly. The variants that round through
bfloat16 (one-hot MXU products of a bf16 table, hi/lo splits) get a table
of bf16-exact values, so that their chains follow the same indices, and
are held within 2e-2 (tools/probe_gather3.py's allowance); the two tallies
whose values are formed in the kernel (i * 0.013, not bf16-exact) run one
iteration, as their chains would part after it. The column march is held
within 1e-5: XLA's CPU jit contracts its height 3 + (s - sig0) * g into an
FMA, and one ulp of a height up to 30 (1.9e-6) moves each of the 4 lerped
reads by up to as much (2e-6 seen).
"""

import ast
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mcbrat3d_tpu_torch.tools import probes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BLK, INNER = 8, 4
BF16_TOL = 2e-2


def _load(rel):
    """A probe tool module, loaded from its file with PROBE_BLK and
    PROBE_INNER set."""
    os.environ["PROBE_BLK"] = str(BLK)
    os.environ["PROBE_INNER"] = str(INNER)
    spec = importlib.util.spec_from_file_location(
        "probe_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {name: _load(f"tools/{name}.py")
            for name in ("probe_gather", "probe_gather2", "probe_gather3",
                         "probe_tally")}


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(v, blk):
    tab, idx = probes.probe_inputs(v, blk)
    return (_bf16_exact(tab) if v.bf16 else tab), idx


def _pallas(kernel, blk, *args):
    call = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((blk, 128), jnp.float32),
        interpret=True)
    return np.asarray(call(*(jnp.asarray(a) for a in args)))


def _port(v, tab, idx, inner):
    out = probes.run_variant(v, torch.tensor(tab), torch.tensor(idx),
                             inner=inner, plain=True)
    return out.numpy().reshape(-1)


def _compare(v, got, want):
    want = np.asarray(want, np.float32).reshape(-1)
    if v.bf16:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    else:
        np.testing.assert_array_equal(got, want)


P1 = ["onehot", "lane", "sub", "row8", "wide"]


@pytest.mark.parametrize("name", P1)
def test_p1_gather_matches_the_tpu_probe(tools, name):
    """P1, one gather a call (tools/probe_gather.py, 16 rows)."""
    mod = tools["probe_gather"]
    v = probes.VARIANTS[f"p1_{name}"]
    tab, idx = _inputs(v, mod.BLK)
    want = _pallas(getattr(mod, f"probe_{name}")(), mod.BLK, idx, tab)
    _compare(v, _port(v, tab, idx, 1), want)


@pytest.mark.parametrize("name", ["onehot", "row8", "lane"])
def test_p2_gather_chain_matches_the_tpu_probe(tools, name):
    """P2, chained gathers from 1,024 entries (tools/probe_gather2.py)."""
    mod = tools["probe_gather2"]
    v = probes.VARIANTS[f"p2_{name}"]
    tab, idx = _inputs(v, BLK)
    want = _pallas(getattr(mod, f"make_{name}")(), BLK, idx, tab)
    _compare(v, _port(v, tab, idx, INNER), want)


def _p3_sliced_table(mod, vals):
    """tools/probe_gather3.py main's bf16 hi/lo encoding of ``vals``."""
    vpad = np.zeros(mod.N_SL * 128 * 128, np.float32)
    vpad[:mod.N_TAB] = vals
    v2 = vpad.reshape(mod.N_SL, 128, 128)
    hi16 = np.asarray(jnp.asarray(v2, jnp.bfloat16))
    lo16 = np.asarray(jnp.asarray(v2 - hi16.astype(np.float32),
                                  jnp.bfloat16))
    tab = np.zeros((mod.N_SL * 256, 128), hi16.dtype)
    for s in range(mod.N_SL):
        tab[s * 256:s * 256 + 128] = hi16[s].T
        tab[s * 256 + 128:(s + 1) * 256] = lo16[s].T
    return jnp.asarray(tab, jnp.bfloat16)


@pytest.mark.parametrize("name", ["sliced", "grp8", "grp8x2"])
def test_p3_wide_gather_chain_matches_the_tpu_probe(tools, name):
    """P3, chained gathers from 106,496 entries (tools/probe_gather3.py),
    one table or the sum of two. The TPU probe's grp8 picks the row within
    a group of 8 at the lane it then gathers (the row of idx[s, lo], not
    of idx[s, l]), so it is tab[idx] only where the 8 rows of a group are
    equal (its own --interpret check fails otherwise): its tables here
    repeat each group's first row, which holds the group pick, the lane
    pick and the chain."""
    mod = tools["probe_gather3"]
    v = probes.VARIANTS[f"p3_{name}"]
    tab, idx = _inputs(v, BLK)
    if name != "sliced":
        rows = tab.reshape(v.n_fields, mod.N_ROWS // 8, 8, 128)
        tab = np.broadcast_to(rows[:, :, :1], rows.shape).reshape(-1).copy()
    kernel, tab_shape, _ = getattr(mod, f"make_{name}")()
    jtab = (_p3_sliced_table(mod, tab) if name == "sliced"
            else tab.reshape(tab_shape))
    want = _pallas(kernel, BLK, idx, jtab)
    _compare(v, _port(v, tab, idx, INNER), want)


@pytest.mark.parametrize("name", ["onehot_f32", "onehot_bf16", "dotonly",
                                  "tally_full", "colscan"])
def test_p4_tally_chain_matches_the_tpu_probe(tools, name):
    """P4, chained tally and column-march bodies (tools/probe_tally.py)."""
    mod = tools["probe_tally"]
    v = probes.VARIANTS[f"p4_{name}"]
    tab, idx = probes.probe_inputs(v, BLK)
    inner = 1 if name in ("dotonly", "tally_full") else INNER
    mod.INNER = inner
    try:
        want = _pallas(mod.VARIANTS[name](), BLK, idx, tab)
    finally:
        mod.INNER = INNER
    got = _port(v, tab, idx, inner)
    if name == "colscan":
        np.testing.assert_allclose(got, want.reshape(-1), rtol=0,
                                   atol=1e-5)
        assert want.max() > 0
    else:
        _compare(v, got, want)


def _p5_namespace(records):
    """native/pallas_gather_experiment.py's definitions and its packing of
    ``records`` (bp, E, K), without its run: its top-level statements up to
    its index draw, the records assignment replaced by ``records``."""
    tree = ast.parse((ROOT / "native/pallas_gather_experiment.py")
                     .read_text())
    body = []
    for node in tree.body:
        targets = [t.id for t in getattr(node, "targets", [])
                   if isinstance(t, ast.Name)]
        if "idx" in targets:
            break
        if "records" not in targets:
            body.append(node)
    ns = {"records": records}
    exec(compile(ast.Module(body=body, type_ignores=[]),
                 "pallas_gather_experiment.py", "exec"), ns)
    return ns


def test_p5_record_gather_matches_the_tpu_probe():
    """P5, 4 fields of 1,024 records at 64 x 128 indices
    (native/pallas_gather_experiment.py's gather kernel, bf16 MXU
    products)."""
    v = probes.VARIANTS["p5_records"]
    records, idx = probes.probe_inputs(v, 64)
    ns = _p5_namespace(jnp.asarray(records))
    ns["S"] = idx.shape[0]
    call = pl.pallas_call(
        ns["gather_kernel"],
        out_shape=jax.ShapeDtypeStruct((ns["R"], ns["S"], 128), jnp.float32),
        interpret=True)
    want = np.asarray(call(ns["bp"], ns["E"], ns["K"], jnp.asarray(idx)))
    got = probes.run_variant(v, torch.tensor(records), torch.tensor(idx),
                             plain=True).numpy()
    assert got.shape == (4, idx.size)
    np.testing.assert_allclose(got, want.reshape(4, -1), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_array_equal(got, records[idx.reshape(-1)].T)


def test_probes_cli_runs_every_variant_on_the_cpu(capsys):
    """The command line on the CPU: every variant's plain twin at its TPU
    shape (the inner loop cut to 2), its bytes a launch, no times."""
    assert probes.main(["all", "--device", "cpu", "--inner", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(probes.VARIANTS)
    for line, name in zip(lines, probes.VARIANTS):
        assert line.startswith(f"{name}: ") and "ns per" not in line
