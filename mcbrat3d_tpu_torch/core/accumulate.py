"""Numerically careful accumulation helpers (PyTorch port).

Counterpart of ``mcbrat3d_tpu.core.accumulate``: ``kahan_cumsum`` for the
long host-side spectral sums (reference:
src/emissionAndBroadBandWeights.f95:188-197, 505-508), the host
``MomentAccumulator`` and the device-resident ``DeviceMomentAccumulator``
of the broadband loop. In-kernel tallies stay float32 per batch and are
promoted to float64 across batches (the reference's batch-moment
structure, Drivers/monteCarloDriver.f95:1023-1052).
"""

from __future__ import annotations

import numpy as np
import torch


def kahan_cumsum(x: np.ndarray, block: int = 65536) -> np.ndarray:
    """Compensated (Kahan-Neumaier) cumulative sum along the last axis.

    Neumaier's variant also survives the case where the running sum is
    smaller than the incoming term, which plain Kahan mishandles.

    Long 1D inputs (production LW domains flatten ~16M voxels into one
    emission CDF) use a blocked formulation: vectorized f64 ``np.cumsum``
    within each block (error <= block * eps, ~1e-11 relative) plus a
    Neumaier-compensated carry across blocks, so the global error stays at
    the compensated level without a 16M-iteration Python loop.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1 and x.size > 4 * block:
        out = np.empty_like(x)
        s = 0.0
        c = 0.0
        for i0 in range(0, x.size, block):
            seg = np.cumsum(x[i0:i0 + block])
            out[i0:i0 + block] = (s + c) + seg
            v = float(seg[-1])
            t = s + v
            c += (s - t) + v if abs(s) >= abs(v) else (v - t) + s
            s = t
        return out
    out = np.empty_like(x)
    s = np.zeros(x.shape[:-1], np.float64)
    c = np.zeros(x.shape[:-1], np.float64)
    for i in range(x.shape[-1]):
        v = x[..., i]
        t = s + v
        c = c + np.where(np.abs(s) >= np.abs(v), (s - t) + v, (v - t) + s)
        s = t
        out[..., i] = s + c
    return out


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

    def merge(self, other: "MomentAccumulator") -> None:
        """Add another accumulator's moments into this one (a resumed
        run's base, a reduction across processes)."""
        self._sum_w += other._sum_w
        self._n_batches += other._n_batches
        for name in other._sum_wx:
            if name not in self._sum_wx:
                self._sum_wx[name] = other._sum_wx[name].copy()
                self._sum_wx2[name] = other._sum_wx2[name].copy()
            else:
                self._sum_wx[name] += other._sum_wx[name]
                self._sum_wx2[name] += other._sum_wx2[name]

    def state_dict(self) -> dict:
        """The state a checkpoint saves (``driver.checkpoint``)."""
        return {
            "sum_w": self._sum_w,
            "n_batches": self._n_batches,
            "sum_wx": dict(self._sum_wx),
            "sum_wx2": dict(self._sum_wx2),
        }

    @staticmethod
    def from_state_dict(state: dict) -> "MomentAccumulator":
        acc = MomentAccumulator()
        acc._sum_w = float(state["sum_w"])
        acc._n_batches = int(state["n_batches"])
        acc._sum_wx = {k: np.asarray(v, np.float64)
                       for k, v in state["sum_wx"].items()}
        acc._sum_wx2 = {k: np.asarray(v, np.float64)
                        for k, v in state["sum_wx2"].items()}
        return acc


def _neumaier(s: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> None:
    """s + c += v, Neumaier-compensated, in place."""
    t = s + v
    c += torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
    s.copy_(t)


class DeviceMomentAccumulator:
    """Moment accumulation on the tallies' device for per-bin loops.

    Counterpart of ``mcbrat3d_tpu.core.accumulate.DeviceMomentAccumulator``:
    sum(w x), sum(w x^2) and sum(w) are kept as Neumaier-compensated float64
    (sum, carry) pairs in tensors on the device, so a batch adds its moments
    without a host sync or fetch; ``finalize()`` fetches them once into a
    host ``MomentAccumulator`` (sum + carry in float64). The JAX package
    keeps float32 pairs; float64 on the card costs nothing here (a few
    hundred thousand values per batch) and makes the carry a formality.
    A resumed run passes the checkpoint's moments as ``base``; ``finalize``
    adds them in.
    """

    def __init__(self, base: MomentAccumulator = None):
        self._base = base if base is not None else MomentAccumulator()
        self._state = {}    # name -> [s_wx, c_wx, s_wx2, c_wx2]
        self._w = None      # [s_w, c_w]
        self._n_batches = 0

    def add(self, weight, arrays: dict) -> None:
        """Add one batch: ``weight`` (photons of the batch, a number or a
        scalar tensor) and ``arrays`` name -> tensor on one device."""
        dev = next(iter(arrays.values())).device
        w = torch.as_tensor(weight, dtype=torch.float64, device=dev)
        if self._w is None:
            self._w = [torch.zeros((), dtype=torch.float64, device=dev)
                       for _ in range(2)]
        _neumaier(*self._w, w)
        for name, a in arrays.items():
            a = a.to(torch.float64)
            if name not in self._state:
                self._state[name] = [torch.zeros_like(a) for _ in range(4)]
            s1, c1, s2, c2 = self._state[name]
            _neumaier(s1, c1, w * a)
            _neumaier(s2, c2, w * a * a)
        self._n_batches += 1

    def add_tallies(self, t, grid) -> None:
        """One batch from raw ``Tallies``: per-column normalization
        (``Tallies.normalized``), the drivers' array layout and the moment
        update, all on the device. The layout: the flux fields, their domain
        means and the horizontally averaged absorption profile (reference:
        Integrators/monteCarloRadiativeTransfer.f95:845-1042), the 3D field
        where it was tallied, and the radiance image with its per-direction
        domain mean, so that mean has its standard error, and the boundary
        fluxes by scattering order where they were tallied, with their
        per-order domain means."""
        tn = t.normalized(grid)
        arrays = {
            "flux_up": tn.flux_up,
            "flux_down": tn.flux_down,
            "flux_absorbed": tn.flux_absorbed,
            "mean_flux_up": tn.flux_up.mean(),
            "mean_flux_down": tn.flux_down.mean(),
            "mean_flux_absorbed": tn.flux_absorbed.mean(),
        }
        if tn.volume_absorption is not None:
            arrays["volume_absorption"] = tn.volume_absorption
        # the column and separable kernels tally the z marginal themselves;
        # otherwise it is the column mean of the 3D field
        if tn.absorption_profile is not None:
            arrays["absorption_profile"] = tn.absorption_profile
        elif tn.volume_absorption is not None:
            arrays["absorption_profile"] = tn.volume_absorption.mean(
                dim=(0, 1))
        if tn.intensity is not None:
            arrays["intensity"] = tn.intensity
            arrays["mean_intensity"] = tn.intensity.mean(dim=(0, 1))
        if tn.flux_up_by_order is not None:
            for name in ("flux_up_by_order", "flux_down_by_order"):
                arrays[name] = getattr(tn, name)
                arrays["mean_" + name] = arrays[name].mean(dim=(0, 1))
        self.add(float(t.n_photons), arrays)

    @property
    def n_batches(self) -> int:
        return self._n_batches + self._base.n_batches

    def finalize(self) -> MomentAccumulator:
        """The one host fetch: the device sums as a host float64
        ``MomentAccumulator``, merged with the ``base``."""
        out = MomentAccumulator()
        out.merge(self._base)
        if self._w is None:
            return out
        dev = MomentAccumulator()
        dev._sum_w = float(self._w[0]) + float(self._w[1])
        dev._n_batches = self._n_batches
        for name, (s1, c1, s2, c2) in self._state.items():
            dev._sum_wx[name] = (s1 + c1).cpu().numpy()
            dev._sum_wx2[name] = (s2 + c2).cpu().numpy()
        out.merge(dev)
        return out

    def state_dict(self) -> dict:
        """What a checkpoint saves: ``finalize``'s state, so a checkpoint
        costs one host fetch of the moments."""
        return self.finalize().state_dict()
