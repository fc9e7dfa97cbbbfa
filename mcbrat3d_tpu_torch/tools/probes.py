"""Gather and tally probes P1-P5 as micro-benchmarks on the card.

    python -m mcbrat3d_tpu_torch.tools.probes VARIANT|all [--inner N]
        [--device cuda|cpu]

prints, for each variant at its TPU probe's shape, the ms a launch of
``inner`` iterations takes on the device, the ns per iteration, the bytes
one launch must move and the device time of one PyTorch call that computes
one iteration (``tab[idx]`` for a gather, ``index_add_`` for a tally),
where there is one. Every time is the device's: the variant's launches (or
the PyTorch calls) are captured in one CUDA graph and the graph's replay is
timed with CUDA events, so the host's launch rate does not enter. A chained
variant's ns per iteration is its marginal cost, (t(64 inner) - t(inner)) /
(63 inner), as the TPU probes' in-kernel loops amortized their launches; a
one-gather variant's is the launch's time. ``--device cpu`` runs the plain
PyTorch twins instead and prints no times.

The TPU probes timed ways to build a per-lane gather or tally out of
one-hot MXU contractions, bf16 hi/lo splits, row-group selects and
same-shape dynamic gathers (``tools/probe_gather.py``,
``probe_gather2.py``, ``probe_gather3.py``, ``probe_tally.py`` and
``native/pallas_gather_experiment.py``). Each variant here computes what
its TPU namesake computes, with exact float32 reads in place of the
one-hot products and hi/lo splits; its inputs are the TPU probe's own
(the same numpy seeds and shapes), so BLK rows of 128 lanes:

* P1 (one gather a call, 1,024-entry table [8, 128]): ``p1_onehot``,
  ``p1_row8``, ``p1_wide`` read tab[i]; ``p1_lane`` tab[i & 127];
  ``p1_sub`` tab[(i >> 7) * 128 + lane % 128] (the sublane pick).
* P2 (INNER chained gathers): ``p2_onehot``, ``p2_row8`` from 1,024
  entries, ``p2_lane`` from the first 128.
* P3 (chained gathers from 832 x 128 = 106,496 entries): ``p3_sliced``,
  ``p3_grp8`` one table, ``p3_grp8x2`` the sum of two.
* P4 (chained tally bodies): ``p4_onehot_f32``, ``p4_onehot_bf16``: v =
  [i == 0] + [i == 1]; ``p4_dotonly``: the values i * 0.013 tallied at the
  lanes' start columns, each lane reading twice its own column's bin;
  ``p4_tally_full``: the values tallied at i in 1,024 bins, each lane
  reading the bin of its column in row 0; ``p4_colscan``: the closed-form
  column-march body over a [64, 128] table (its dead index update is
  dropped).
* P5 (``p5_records``): the 4 fields of 1,024 records at [512, 128]
  indices, out[r] = records[idx, r].

A chain moves lane l from its start idx0 to (idx0 + int(v * 997)) & mask
after each value v (the TPU probes' ``_perturb``), so no read can be
hoisted; the output is each lane's sum of its values. The kernels are
``csrc/probe_kernels.cu`` (``gather_chain``, ``tally_chain``); the plain
twins (``gather_chain_plain``, ``tally_chain_plain``) are what a CPU
tensor runs and what ``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import sys

import numpy as np
import torch

# Kernel launches made by the wrappers in this process.
GATHER_LAUNCHES = 0
TALLY_LAUNCHES = 0

# csrc/probe_kernels.cu modes
G_FLAT, G_SUB, G_RECORDS = range(3)
T_ONEHOT, T_DOTONLY, T_FULL, T_COLSCAN = range(4)
ALL_BITS = -1
# P3's table (tools/probe_gather3.py N_ROWS x 128) and P4's column-march
# table rows (probe_tally.py NX)
P3_ENTRIES = 832 * 128
COLSCAN_NX = 32
# Tables up to this size are copied into shared memory.
SMEM_TABLE_BYTES = 48 * 1024
# A chained variant's ns per iteration is timed over this many times its
# iterations, less its own launch (the fixed cost of a launch: its start,
# the table's copy to shared memory, the output's store).
MARGINAL_FACTOR = 64


@dataclasses.dataclass(frozen=True)
class Variant:
    """One TPU probe variant: which kernel computes it and how, its TPU
    source (file:line of its pallas_call), its shape and its rep count."""

    name: str
    source: str
    kernel: str          # "gather" or "tally"
    mode: int
    blk: int             # rows of 128 lanes
    inner: int           # iterations per launch
    reps: int            # launches timed (the TPU probe's REPS)
    n_tab: int = 1024    # entries per table (records for P5)
    n_fields: int = 1    # tables summed, or fields per record
    mask: int = 1023
    init_mask: int = ALL_BITS
    bf16: bool = False   # the TPU variant rounded through bfloat16


_P1 = "tools/probe_gather.py:39"
_P2 = "tools/probe_gather2.py:114"
_P3 = "tools/probe_gather3.py:191"
_P4 = "tools/probe_tally.py:178"
_P5 = "native/pallas_gather_experiment.py:34"
VARIANTS = {v.name: v for v in (
    Variant("p1_onehot", _P1, "gather", G_FLAT, 16, 1, 200, bf16=True),
    Variant("p1_lane", _P1, "gather", G_FLAT, 16, 1, 200, init_mask=127),
    Variant("p1_sub", _P1, "gather", G_SUB, 16, 1, 200),
    Variant("p1_row8", _P1, "gather", G_FLAT, 16, 1, 200),
    Variant("p1_wide", _P1, "gather", G_FLAT, 16, 1, 200),
    Variant("p2_onehot", _P2, "gather", G_FLAT, 16, 256, 8, bf16=True),
    Variant("p2_row8", _P2, "gather", G_FLAT, 16, 256, 8),
    Variant("p2_lane", _P2, "gather", G_FLAT, 16, 256, 8, mask=127,
            init_mask=127),
    Variant("p3_sliced", _P3, "gather", G_FLAT, 16, 64, 8,
            n_tab=P3_ENTRIES, mask=P3_ENTRIES - 1, bf16=True),
    Variant("p3_grp8", _P3, "gather", G_FLAT, 16, 64, 8, n_tab=P3_ENTRIES,
            mask=P3_ENTRIES - 1),
    Variant("p3_grp8x2", _P3, "gather", G_FLAT, 16, 64, 8,
            n_tab=P3_ENTRIES, n_fields=2, mask=P3_ENTRIES - 1),
    Variant("p4_onehot_f32", _P4, "tally", T_ONEHOT, 16, 128, 8, mask=127),
    Variant("p4_onehot_bf16", _P4, "tally", T_ONEHOT, 16, 128, 8, mask=127,
            bf16=True),
    Variant("p4_dotonly", _P4, "tally", T_DOTONLY, 16, 128, 8, mask=127,
            bf16=True),
    Variant("p4_tally_full", _P4, "tally", T_FULL, 16, 128, 8, mask=1023,
            bf16=True),
    Variant("p4_colscan", _P4, "tally", T_COLSCAN, 16, 128, 8, mask=127),
    Variant("p5_records", _P5, "gather", G_RECORDS, 512, 1, 300, n_fields=4),
)}


def probe_inputs(v: Variant, blk: int = None):
    """(table, start indices) as the TPU probe makes them: numpy
    RandomState(0), indices first ([blk, 128] int32), then the table
    (float32: [8, 128] for P1/P2, 106,496 entries for P3, stacked twice for
    grp8x2, [64, 128] for P4, [1024, 4] records for P5)."""
    blk = v.blk if blk is None else blk
    rs = np.random.RandomState(0)
    hi = P3_ENTRIES if v.n_tab == P3_ENTRIES else 1024
    idx = rs.randint(0, hi, (blk, 128)).astype(np.int32)
    if v.source == _P3:
        tab = np.tile(rs.rand(P3_ENTRIES).astype(np.float32), v.n_fields)
    elif v.source == _P4:
        tab = rs.rand(2 * COLSCAN_NX, 128).astype(np.float32)
    elif v.source == _P5:
        tab = rs.rand(v.n_tab, v.n_fields).astype(np.float32)
    else:
        tab = rs.rand(8, 128).astype(np.float32)
    return tab, idx


def _perturb(idx0, v, mask):
    return (idx0 + (v * 997.0).to(torch.int32)) & mask


def gather_chain_plain(tab: torch.Tensor, idx0: torch.Tensor, inner: int,
                       mask: int, mode: int, n_fields: int = 1,
                       init_mask: int = ALL_BITS) -> torch.Tensor:
    """``gather_chain`` in plain PyTorch: ``tab`` flat float32 (n_fields
    tables of n_tab entries, or n_tab records of n_fields floats), ``idx0``
    [n] int32; returns [n] float32 (the lanes' sums), or [n_fields, n] for
    G_RECORDS."""
    tab = tab.reshape(-1)
    idx0 = idx0.reshape(-1) & init_mask
    if mode == G_RECORDS:
        return tab.reshape(-1, n_fields)[idx0.long()].T.contiguous()
    n_tab = tab.numel() // n_fields
    col = torch.arange(idx0.numel(), device=idx0.device) % 128
    i, acc = idx0, torch.zeros(idx0.shape, dtype=torch.float32,
                               device=idx0.device)
    for _ in range(inner):
        if mode == G_SUB:
            v = tab[(i.long() >> 7) * 128 + col]
        else:
            v = tab[i.long()]
            for f in range(1, n_fields):
                v = v + tab[f * n_tab + i.long()]
        acc = acc + v
        i = _perturb(idx0, v, mask)
    return acc


def _colscan_step(tab, sig0, c):
    """One column-march body (tools/probe_tally.py make_colscan) for every
    lane at iteration ``c``, in float32."""
    rows = tab.reshape(2 * COLSCAN_NX, 128)[2 * (c & (COLSCAN_NX - 1)):][:2]
    cf = float(c)
    q = torch.ceil((sig0 - cf) * (1.0 / COLSCAN_NX))
    j = cf + float(COLSCAN_NX) * q
    s_in = torch.maximum(j, sig0)
    s_out = j + 1.0
    z_in = torch.clamp(3.0 + (s_in - sig0) * 1.7, 0.0, 30.0)
    z_out = torch.clamp(3.0 + (s_out - sig0) * 1.7, 0.0, 30.0)
    out = []
    for z in (z_in, z_out):
        u = torch.clamp(z, 0.0, 32.0)
        k = u.to(torch.int32)
        f = u - k.to(torch.float32)
        out.append(rows[0][k.long()] * (1.0 - f) + rows[1][k.long()] * f)
    return torch.clamp(out[0] - out[1], min=0.0)


def tally_chain_plain(tab: torch.Tensor, idx0: torch.Tensor, inner: int,
                      mask: int, mode: int) -> torch.Tensor:
    """``tally_chain`` in plain PyTorch: ``idx0`` [n] int32 (masked with
    ``mask`` first), ``tab`` T_COLSCAN's [64, 128] float32 table; returns
    the lanes' sums [n] float32. The bins sum in float64 and round once,
    as the kernel's do (exact, so independent of the order)."""
    idx0 = idx0.reshape(-1) & mask
    dev = idx0.device
    col = torch.arange(idx0.numel(), device=dev) % 128
    acc = torch.zeros(idx0.shape, dtype=torch.float32, device=dev)
    if mode == T_COLSCAN:
        sig0 = idx0.to(torch.float32) * 0.25
        for c in range(inner):
            acc = acc + _colscan_step(tab, sig0, c)
        return acc
    i = idx0
    for _ in range(inner):
        if mode == T_ONEHOT:
            v = (i == 0).to(torch.float32) + (i == 1).to(torch.float32)
        else:
            val = i.to(torch.float32) * 0.013
            bins = torch.zeros(1024, dtype=torch.float64, device=dev)
            bins.index_add_(0, (idx0 if mode == T_DOTONLY else i).long(),
                            val.double())
            v = bins[col].to(torch.float32)
            if mode == T_DOTONLY:
                v = v + v
        acc = acc + v
        i = _perturb(idx0, v, mask)
    return acc


_P = ctypes.c_void_p
_I = ctypes.c_int


def _library():
    from mcbrat3d_tpu_torch import _build
    lib = _build.load("probe_kernels")
    if not getattr(lib, "_mcb_typed", False):
        lib.probe_gather_chain.restype = _I
        lib.probe_gather_chain.argtypes = ([_P, _I, _I, _P, _P] + [_I] * 6
                                           + [_P])
        lib.probe_tally_chain.restype = _I
        lib.probe_tally_chain.argtypes = [_P, _P, _P] + [_I] * 4 + [_P]
        lib._mcb_typed = True
    return lib


def _check(t, name, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def gather_chain(tab: torch.Tensor, idx0: torch.Tensor, inner: int,
                 mask: int, mode: int, n_fields: int = 1,
                 init_mask: int = ALL_BITS) -> torch.Tensor:
    """The gather chain: the CUDA kernel for tensors on a CUDA device (the
    table in shared memory when it fits in ``SMEM_TABLE_BYTES``, else read
    from global memory), the plain twin on the CPU."""
    global GATHER_LAUNCHES
    if idx0.device.type == "cpu":
        return gather_chain_plain(tab, idx0, inner, mask, mode, n_fields,
                                  init_mask)
    if not idx0.is_cuda:
        raise ValueError(f"no probe kernel for device {idx0.device}")
    _check(tab, "tab", torch.float32, idx0.device)
    _check(idx0, "idx0", torch.int32, idx0.device)
    n = idx0.numel()
    use_smem = tab.numel() * 4 <= SMEM_TABLE_BYTES
    out = torch.empty((n_fields * n) if mode == G_RECORDS else n,
                      dtype=torch.float32, device=idx0.device)
    err = _library().probe_gather_chain(
        tab.data_ptr(), tab.numel() // n_fields, n_fields, idx0.data_ptr(),
        out.data_ptr(), n, inner, init_mask, mask, mode, int(use_smem),
        torch.cuda.current_stream(idx0.device).cuda_stream)
    GATHER_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"probe gather_chain launch failed: CUDA error "
                           f"{err}")
    return out.reshape(n_fields, n) if mode == G_RECORDS else out


def tally_chain(tab: torch.Tensor, idx0: torch.Tensor, inner: int,
                mask: int, mode: int) -> torch.Tensor:
    """The tally chain: the CUDA kernel for tensors on a CUDA device, the
    plain twin on the CPU."""
    global TALLY_LAUNCHES
    if idx0.device.type == "cpu":
        return tally_chain_plain(tab, idx0, inner, mask, mode)
    if not idx0.is_cuda:
        raise ValueError(f"no probe kernel for device {idx0.device}")
    _check(tab, "tab", torch.float32, idx0.device)
    _check(idx0, "idx0", torch.int32, idx0.device)
    n = idx0.numel()
    out = torch.empty(n, dtype=torch.float32, device=idx0.device)
    err = _library().probe_tally_chain(
        tab.data_ptr(), idx0.data_ptr(), out.data_ptr(), n, inner, mask,
        mode, torch.cuda.current_stream(idx0.device).cuda_stream)
    TALLY_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"probe tally_chain launch failed: CUDA error "
                           f"{err}")
    return out


def run_variant(v: Variant, tab: torch.Tensor, idx0: torch.Tensor,
                inner: int = None, plain: bool = False) -> torch.Tensor:
    """One launch of variant ``v`` (its kernel, or with ``plain`` its plain
    twin) on the inputs of ``probe_inputs``."""
    inner = v.inner if inner is None else inner
    idx0 = idx0.reshape(-1)
    tab = tab.reshape(-1)
    if v.kernel == "tally":
        fn = tally_chain_plain if plain else tally_chain
        return fn(tab, idx0, inner, v.mask, v.mode)
    if plain:
        return gather_chain_plain(tab, idx0, inner, v.mask, v.mode,
                                  v.n_fields, v.init_mask)
    return gather_chain(tab, idx0, inner, v.mask, v.mode, v.n_fields,
                        v.init_mask)


def launch_bytes(v: Variant, n: int) -> int:
    """Bytes one launch must move: the indices read once, the table read
    once, the output written once."""
    if v.kernel == "tally":  # only the column march reads a table
        n_tab = 2 * COLSCAN_NX * 128 if v.mode == T_COLSCAN else 0
    else:
        n_tab = v.n_tab * v.n_fields
    n_out = v.n_fields * n if v.mode == G_RECORDS else n
    return 4 * (n + n_tab + n_out)


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after a warm-up call on a side stream), the graph replayed once
    to warm it and once between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library_call(v: Variant, tab: torch.Tensor, idx0: torch.Tensor):
    """The one PyTorch call that computes one iteration of ``v``, or None:
    ``tab[idx]`` for a gather, ``index_add_`` of the values for a tally."""
    idx = idx0.reshape(-1).long()
    if v.kernel == "gather":
        flat = tab.reshape(-1)
        if v.mode == G_RECORDS:
            rec = flat.reshape(-1, v.n_fields)
            return lambda: rec[idx]
        return lambda: flat[idx]
    if v.mode in (T_DOTONLY, T_FULL):
        val = (idx & v.mask).to(torch.float32) * 0.013
        bins = torch.zeros(1024, dtype=torch.float32, device=idx.device)
        return lambda: bins.index_add_(0, idx & v.mask, val)
    return None


def measure(v: Variant, inner: int = None, device: str = "cuda") -> dict:
    """Run variant ``v`` through its kernel (or on the CPU its plain twin)
    at its TPU shape; returns the output and, on the card, the device ms a
    launch, the ns per iteration, the bytes of one launch and the library
    call's device ns per iteration."""
    from mcbrat3d_tpu_torch.core import device as dev_mod

    dev = dev_mod.resolve(device)
    inner = v.inner if inner is None else inner
    tab_np, idx_np = probe_inputs(v)
    tab = torch.tensor(tab_np, device=dev).reshape(-1)
    idx0 = torch.tensor(idx_np, device=dev).reshape(-1)
    n = idx0.numel()
    res = dict(variant=v.name, lanes=n, inner=inner,
               bytes=launch_bytes(v, n))
    def run(n_iter=inner):
        return run_variant(v, tab, idx0, n_iter)

    res["out"] = run()
    if dev.type != "cuda":
        return res
    ms = device_ms(run, v.reps)
    res["ms"] = ms
    if inner > 1:
        long_ms = device_ms(lambda: run(MARGINAL_FACTOR * inner), v.reps)
        res["ns_per_iter"] = (1e6 * (long_ms - ms)
                              / ((MARGINAL_FACTOR - 1) * inner))
    else:
        res["ns_per_iter"] = 1e6 * ms
    lib = library_call(v, tab, idx0)
    res["library_ns"] = None if lib is None else 1e6 * device_ms(lib,
                                                                 v.reps)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", choices=(*VARIANTS, "all"))
    ap.add_argument("--inner", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = list(VARIANTS) if args.variant == "all" else [args.variant]
    for name in names:
        r = measure(VARIANTS[name], args.inner, args.device)
        line = (f"{name}: {r['lanes']} lanes, inner {r['inner']}, "
                f"{r['bytes']} bytes a launch, checksum "
                f"{float(r['out'].double().sum()):.6f}")
        if "ns_per_iter" in r:
            lib = r["library_ns"]
            line += (f", {r['ms']:.5f} ms a launch, {r['ns_per_iter']:.3f} "
                     "ns per iteration, library "
                     + ("none" if lib is None else f"{lib:.3f} ns"))
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
