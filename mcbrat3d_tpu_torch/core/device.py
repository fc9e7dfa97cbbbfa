"""The device a builder places its tensors on.

Every public builder of the port (scenes, domains read or converted,
radiance directions) defaults to the card and raises where there is none;
the CPU path is taken only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (pass device='cpu' for the CPU path)")
    return dev
