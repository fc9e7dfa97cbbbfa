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


def _regular(e: np.ndarray) -> bool:
    d = np.diff(e)
    return bool(np.all(np.abs(d - d[0]) <= 4 * np.spacing(e[-1]))) and e.size > 1


@dataclasses.dataclass(frozen=True)
class Grid:
    """Cell-edge geometry of the 3D domain (periodic in x and y).

    Edge tensors have length n+1 for n cells (float32, on ``device``).
    """

    x_edges: torch.Tensor
    y_edges: torch.Tensor
    z_edges: torch.Tensor
    xy_regular: bool = True
    z_regular: bool = True

    @staticmethod
    def from_edges(x_edges, y_edges, z_edges, device="cpu") -> "Grid":
        """Build a Grid, detecting regular spacing on the float32 edges
        (same rule as the JAX package)."""
        xe = np.asarray(x_edges, np.float32)
        ye = np.asarray(y_edges, np.float32)
        ze = np.asarray(z_edges, np.float32)
        return Grid._make(xe, ye, ze, _regular(xe) and _regular(ye),
                          _regular(ze), device)

    @staticmethod
    def regular(nx, ny, nz, dx, dy, dz, x0=0.0, y0=0.0, z0=0.0,
                device="cpu") -> "Grid":
        xe = (x0 + dx * np.arange(nx + 1)).astype(np.float32)
        ye = (y0 + dy * np.arange(ny + 1)).astype(np.float32)
        ze = (z0 + dz * np.arange(nz + 1)).astype(np.float32)
        return Grid._make(xe, ye, ze, True, True, device)

    @staticmethod
    def _make(xe, ye, ze, xy_regular, z_regular, device) -> "Grid":
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
