"""Tally accumulation of the XLA wave kernel (PyTorch port).

Counterpart of ``mcbrat3d_tpu.transport.tally``: a flat float32 buffer
to which each lane adds one value at one index per call. The JAX package
picks a one-hot bfloat16 matmul for small buffers (a TPU construct that
rides the MXU); on the card one ``index_add_`` serves every size.
"""

from __future__ import annotations

import torch


def make_accumulator():
    """Return add(buf, idx, val) -> buf for a flat float32 tally buffer of
    any size: ``val[i]`` added at ``idx[i]`` in place."""

    def add(buf: torch.Tensor, idx: torch.Tensor,
            val: torch.Tensor) -> torch.Tensor:
        return buf.index_add_(0, idx.to(torch.int64), val)

    return add
