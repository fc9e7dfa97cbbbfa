"""Surface reflection (PyTorch port): the Lambertian surface, uniform or
with a per-pixel albedo grid.

Counterpart of ``mcbrat3d_tpu.physics.surface`` (reference:
src/surfaceProperties.f95:32-161). The column kernel reflects off both;
the record kernel off the uniform one (its per-pixel albedo and the RPV
BRDF, K1-d, are still to port).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Surface:
    """Surface description: per-pixel parameters + a named BRDF.

    ``params``: [nx_s, ny_s, P] float32 parameter grid; for a uniform
    Lambertian surface it is [1, 1, 1] = albedo.
    """

    params: np.ndarray
    brdf_name: str = "Lambertian"
    temperature: float = 0.0
    emissivity: float = 1.0

    @staticmethod
    def lambertian(albedo: float, temperature: float = 0.0,
                   emissivity: float = 1.0) -> "Surface":
        return Surface(params=np.full((1, 1, 1), albedo, np.float32),
                       brdf_name="Lambertian",
                       temperature=temperature, emissivity=emissivity)

    @property
    def is_uniform_lambertian(self) -> bool:
        return (self.brdf_name == "Lambertian"
                and self.params.shape[0] == 1 and self.params.shape[1] == 1)

    @property
    def is_uniform_rpv(self) -> bool:
        """Uniform scalar-parameter RPV surface."""
        return (self.brdf_name == "RPV"
                and self.params.shape[0] == 1 and self.params.shape[1] == 1)

    @property
    def is_lambertian_grid(self) -> bool:
        """Lambertian BRDF with a per-pixel albedo grid (any resolution;
        reference per-pixel surface grid: src/surfaceProperties.f95:32-36).
        """
        return self.brdf_name == "Lambertian" and self.params.shape[2] == 1

    @property
    def albedo(self) -> float:
        """Uniform Lambertian albedo (float32 value)."""
        return float(self.params.reshape(-1)[0])
