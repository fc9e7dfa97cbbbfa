"""Host-side moment accumulation over batches (PyTorch port).

Counterpart of ``mcbrat3d_tpu.core.accumulate.MomentAccumulator``: in-kernel
tallies stay float32 per batch and are promoted to float64 across batches
(the reference's batch-moment structure,
Drivers/monteCarloDriver.f95:1023-1052).
"""

from __future__ import annotations

import numpy as np


class MomentAccumulator:
    """Photon-weighted first/second moments over batches (host-side, f64).

    Matches the driver's accumulation of sum(w*x) and sum(w*x^2) per batch,
    where w is the batch photon count (reference:
    Drivers/monteCarloDriver.f95:1023-1052), and the mean/stderr finalization
    mean = sum(w x)/sum(w), stderr = sqrt(max(0, E[x^2]-E[x]^2)/(n-1))
    (reference: Drivers/monteCarloDriver.f95:1188-1228).
    """

    def __init__(self):
        self._sum_wx = {}
        self._sum_wx2 = {}
        self._sum_w = 0.0
        self._n_batches = 0

    def add(self, weight: float, arrays: dict):
        self._sum_w += float(weight)
        self._n_batches += 1
        for name, arr in arrays.items():
            a = np.asarray(arr, np.float64)
            if name not in self._sum_wx:
                self._sum_wx[name] = np.zeros_like(a)
                self._sum_wx2[name] = np.zeros_like(a)
            self._sum_wx[name] += weight * a
            self._sum_wx2[name] += weight * a * a

    @property
    def n_batches(self) -> int:
        return self._n_batches

    @property
    def total_weight(self) -> float:
        return self._sum_w

    def mean(self, name: str) -> np.ndarray:
        return self._sum_wx[name] / self._sum_w

    def stderr(self, name: str) -> np.ndarray:
        if self._n_batches < 2:
            return np.zeros_like(self._sum_wx[name])
        ex = self._sum_wx[name] / self._sum_w
        ex2 = self._sum_wx2[name] / self._sum_w
        var = np.maximum(0.0, ex2 - ex * ex)
        return np.sqrt(var / (self._n_batches - 1))
