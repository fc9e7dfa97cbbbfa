"""Domain grid geometry with regular-spacing flags.

PyTorch counterpart of ``mcbrat3d_tpu.core.grid`` (reference:
Integrators/monteCarloRadiativeTransfer.f95:1551-1592, the
``xyRegularlySpaced`` / ``zRegularlySpaced`` fast paths). Edges live as
float32 tensors on the grid's device; float64 host copies serve setup code
(writers, normalization) without a device round trip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mcbrat3d_tpu_torch.core.device import resolve


def _regular(e: np.ndarray) -> bool:
    d = np.diff(e)
    return bool(np.all(np.abs(d - d[0]) <= 4 * np.spacing(e[-1]))) and e.size > 1


@dataclasses.dataclass(frozen=True)
class Grid:
    """Cell-edge geometry of the 3D domain (periodic in x and y).

    Edge tensors have length n+1 for n cells (float32, on ``device``: the
    card unless the caller asks for the CPU; raises where there is none).
    """

    x_edges: torch.Tensor
    y_edges: torch.Tensor
    z_edges: torch.Tensor
    xy_regular: bool = True
    z_regular: bool = True

    @staticmethod
    def from_edges(x_edges, y_edges, z_edges, device="cuda") -> "Grid":
        """Build a Grid, detecting regular spacing on the float32 edges
        (same rule as the JAX package)."""
        xe = np.asarray(x_edges, np.float32)
        ye = np.asarray(y_edges, np.float32)
        ze = np.asarray(z_edges, np.float32)
        return Grid._make(xe, ye, ze, _regular(xe) and _regular(ye),
                          _regular(ze), device)

    @staticmethod
    def regular(nx, ny, nz, dx, dy, dz, x0=0.0, y0=0.0, z0=0.0,
                device="cuda") -> "Grid":
        xe = (x0 + dx * np.arange(nx + 1)).astype(np.float32)
        ye = (y0 + dy * np.arange(ny + 1)).astype(np.float32)
        ze = (z0 + dz * np.arange(nz + 1)).astype(np.float32)
        return Grid._make(xe, ye, ze, True, True, device)

    @staticmethod
    def _make(xe, ye, ze, xy_regular, z_regular, device) -> "Grid":
        device = resolve(device)
        g = Grid(x_edges=torch.tensor(xe, device=device),
                 y_edges=torch.tensor(ye, device=device),
                 z_edges=torch.tensor(ze, device=device),
                 xy_regular=xy_regular, z_regular=z_regular)
        object.__setattr__(g, "_edges_f32", (xe, ye, ze))
        return g

    def edges_np(self):
        """(x_edges, y_edges, z_edges) as float64 NumPy arrays."""
        return tuple(np.asarray(e, np.float64) for e in self._edges_f32)

    def edges_f32(self):
        """(x_edges, y_edges, z_edges) as the float32 host arrays the
        device tensors were made from."""
        return self._edges_f32

    @property
    def device(self) -> torch.device:
        return self.x_edges.device

    @property
    def nx(self) -> int:
        return self.x_edges.shape[0] - 1

    @property
    def ny(self) -> int:
        return self.y_edges.shape[0] - 1

    @property
    def nz(self) -> int:
        return self.z_edges.shape[0] - 1

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    # ---- geometry on tensors (the XLA wave kernel's; JAX's Grid) ----
    @property
    def x0(self):
        return self.x_edges[0]

    @property
    def y0(self):
        return self.y_edges[0]

    @property
    def z0(self):
        return self.z_edges[0]

    @property
    def x_max(self):
        return self.x_edges[-1]

    @property
    def y_max(self):
        return self.y_edges[-1]

    @property
    def z_max(self):
        return self.z_edges[-1]

    def wrap_x(self, x):
        """Periodic wrap in x (reference:
        Integrators/monteCarloRadiativeTransfer.f95:1898-1917)."""
        return self.x0 + torch.remainder(x - self.x0, self.x_max - self.x0)

    def wrap_y(self, y):
        return self.y0 + torch.remainder(y - self.y0, self.y_max - self.y0)

    def locate_x(self, x):
        """Cell index (int64) along x of positions inside the domain."""
        return _locate(x, self.x_edges, self.xy_regular)

    def locate_y(self, y):
        return _locate(y, self.y_edges, self.xy_regular)

    def locate_z(self, z):
        return _locate(z, self.z_edges, self.z_regular)

    def z_from_fraction(self, zf):
        """A fractional height in [0, 1] as a physical z, layerwise so each
        layer gets a uniform share (reference:
        Integrators/monteCarloRadiativeTransfer.f95:484-494)."""
        if self.z_regular:
            return self.z0 + zf * (self.z_max - self.z0)
        t = zf * self.nz
        k = torch.clamp(torch.floor(t).long(), 0, self.nz - 1)
        frac = t - k.to(torch.float32)
        lo = self.z_edges[k]
        return lo + frac * (self.z_edges[k + 1] - lo)


def _locate(pos, edges, regular: bool):
    """Index of the cell holding ``pos``, clipped to the valid range."""
    n = edges.shape[0] - 1
    if regular:
        inv_d = n / (edges[-1] - edges[0])
        idx = torch.floor((pos - edges[0]) * inv_d).long()
    else:
        idx = torch.searchsorted(edges, pos.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, n - 1)
