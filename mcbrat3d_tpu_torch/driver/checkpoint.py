"""Checkpoint and resume of long runs (PyTorch port).

Counterpart of ``mcbrat3d_tpu.driver.checkpoint``, with the same ``.npz``
keys, so a file written by either package loads in the other. The
reference designed periodic checkpoints of the accumulated moments but
left them commented out (reference: Drivers/monteCarloDriver.f95:127-134,
753-801). The counter-based random numbers need no state (batch b's
streams are a function of (iseed, b)), so a checkpoint is the moments and
the next batch index, written to a temporary file and moved into place.
"""

from __future__ import annotations

import os

import numpy as np

from mcbrat3d_tpu_torch.core.accumulate import MomentAccumulator


def save_checkpoint(path: str, next_batch: int, acc,
                    chunk_size: int = 0, n_ranks: int = 0) -> None:
    """Write ``acc``'s moments (a ``MomentAccumulator`` or a
    ``DeviceMomentAccumulator``) and ``next_batch`` to ``path``.
    ``chunk_size`` is the photons of one global batch and ``n_ranks`` the
    ranks it was spread over (0: not recorded); a resume checks both,
    since the batch numbering depends on them. ``n_ranks`` is a key of the
    port's alone, which the JAX package's loader ignores."""
    state = acc.state_dict()
    payload = {
        "next_batch": np.int64(next_batch),
        "chunk_size": np.int64(chunk_size),
        "n_ranks": np.int64(n_ranks),
        "sum_w": np.float64(state["sum_w"]),
        "n_batches": np.int64(state["n_batches"]),
    }
    for k, v in state["sum_wx"].items():
        payload[f"wx:{k}"] = v
    for k, v in state["sum_wx2"].items():
        payload[f"wx2:{k}"] = v
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, with_meta: bool = False):
    """Returns (next_batch, MomentAccumulator[, chunk_size]); a file
    without ``chunk_size`` gives 0."""
    with np.load(path) as z:
        state = {
            "sum_w": float(z["sum_w"]),
            "n_batches": int(z["n_batches"]),
            "sum_wx": {k[3:]: z[k] for k in z.files if k.startswith("wx:")},
            "sum_wx2": {k[4:]: z[k] for k in z.files if k.startswith("wx2:")},
        }
        acc = MomentAccumulator.from_state_dict(state)
        if with_meta:
            chunk = int(z["chunk_size"]) if "chunk_size" in z.files else 0
            return int(z["next_batch"]), acc, chunk
        return int(z["next_batch"]), acc


def load_ranks(path: str) -> int:
    """The rank count a checkpoint was written under; 0 for a file without
    it (the JAX package's, or the port's before it recorded one)."""
    with np.load(path) as z:
        return int(z["n_ranks"]) if "n_ranks" in z.files else 0


def check_resume(chunk_size: int, n_ranks: int, resume_chunk_size=None,
                 resume_ranks=None) -> None:
    """Refuse to resume a run of ``n_ranks`` ranks and ``chunk_size``
    photons a global batch from a checkpoint written with others (None:
    not recorded). Batch b of an n-rank run traces streams b * n .. b * n
    + n - 1, so under another rank count the resumed batches would trace
    streams the checkpoint already holds, even where the chunk sizes
    agree (2^20 photons on 2^17 lanes: 8 photons a lane on one rank, 4 on
    each of two)."""
    if resume_chunk_size is not None and resume_chunk_size != chunk_size:
        raise ValueError(
            f"checkpoint was written with chunk size {resume_chunk_size} "
            f"(photons_per_batch x ranks) but this run uses {chunk_size}; "
            "resume with the same rank count and batch size")
    if resume_ranks is not None and resume_ranks != n_ranks:
        raise ValueError(
            f"checkpoint was written by {resume_ranks} rank(s) but this run "
            f"has {n_ranks}: its batches trace other photon streams; resume "
            "with the same rank count")
