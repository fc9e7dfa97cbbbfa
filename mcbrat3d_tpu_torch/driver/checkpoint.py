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
                    chunk_size: int = 0) -> None:
    """Write ``acc``'s moments (a ``MomentAccumulator`` or a
    ``DeviceMomentAccumulator``) and ``next_batch`` to ``path``.
    ``chunk_size`` is the photons of one global batch; a resume checks it,
    since the batch numbering depends on it."""
    state = acc.state_dict()
    payload = {
        "next_batch": np.int64(next_batch),
        "chunk_size": np.int64(chunk_size),
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
