"""Surface reflection (PyTorch port): the uniform Lambertian surface.

Counterpart of ``mcbrat3d_tpu.physics.surface`` (reference:
src/surfaceProperties.f95:32-161). Only the uniform Lambertian surface is
ported so far; RPV and per-pixel albedo grids follow with the record
kernel's envelope (ROADMAP Queue 1 item 10).
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
    def albedo(self) -> float:
        """Uniform Lambertian albedo (float32 value)."""
        return float(self.params.reshape(-1)[0])
