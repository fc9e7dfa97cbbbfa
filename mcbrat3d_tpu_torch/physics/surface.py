"""Surface reflection (PyTorch port): the Lambertian albedo, uniform or per
pixel, the Rahman-Pinty-Verstraete BRDF and the BRDF extension point.

Counterpart of ``mcbrat3d_tpu.physics.surface`` (reference:
src/surfaceProperties.f95:32-161): a per-pixel parameter grid (x, y) ->
params with a reflectance function of (params, mu_in, mu_out, phi_in,
phi_out) on tensors. The record kernel reflects off a uniform Lambertian
or RPV surface and off a per-pixel Lambertian grid, the column kernel off
both Lambertian forms; ``Surface.reflectance`` is the general lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def lambertian_reflectance(params, mu_in, mu_out, phi_in, phi_out):
    """R = albedo, independent of geometry
    (reference: src/surfaceProperties.f95:153-161)."""
    return params[..., 0]


def rpv_reflectance(params, mu_in, mu_out, phi_in, phi_out):
    """Rahman-Pinty-Verstraete BRDF (the standard land-surface model).

    params = (rho0, k, theta_hg): amplitude, Minnaert exponent, HG
    asymmetry of the scattering lobe (theta < 0: backscattering surfaces).
    Returns the weight multiplier applied at a surface bounce for the
    sampled outgoing direction (reference extension point:
    src/surfaceProperties.f95:119-147)."""
    rho0 = params[..., 0]
    k = params[..., 1]
    theta = params[..., 2]
    mu_i = torch.abs(mu_in)
    mu_r = torch.clamp(torch.abs(mu_out), 1e-6, 1.0)
    si = torch.sqrt(torch.clamp(1.0 - mu_i ** 2, min=0.0))
    sr = torch.sqrt(torch.clamp(1.0 - mu_r ** 2, min=0.0))
    cos_dphi = torch.cos(phi_out - phi_in)
    # phase angle between incident and reflected rays
    cos_g = mu_i * mu_r + si * sr * cos_dphi
    minnaert = (mu_i * mu_r * (mu_i + mu_r)) ** (k - 1.0)
    hg = (1.0 - theta ** 2) / (1.0 + theta ** 2
                               + 2.0 * theta * cos_g) ** 1.5
    t_i = torch.tan(torch.acos(torch.clamp(mu_i, 1e-6, 1.0)))
    t_r = torch.tan(torch.acos(mu_r))
    cap_g = torch.sqrt(torch.clamp(t_i ** 2 + t_r ** 2
                                   - 2.0 * t_i * t_r * cos_dphi, min=0.0))
    hot = 1.0 + (1.0 - rho0) / (1.0 + cap_g)
    return rho0 * minnaert * hg * hot


# Registry of named BRDF kernels; each maps
# (params[..., P], mu_in, mu_out, phi_in, phi_out) -> reflectance.
BRDF_REGISTRY: dict = {"Lambertian": lambertian_reflectance,
                       "RPV": rpv_reflectance}


def register_brdf(name: str, fn: Callable) -> None:
    BRDF_REGISTRY[name] = fn


@dataclasses.dataclass(frozen=True)
class Surface:
    """Surface description: per-pixel parameters + a named BRDF.

    ``params``: [nx_s, ny_s, P] float32 parameter grid (any resolution; a
    photon's (x, y) maps fractionally onto it); for a uniform Lambertian
    surface it is [1, 1, 1] = albedo.
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

    @staticmethod
    def rpv(rho0: float, k: float = 1.0, theta: float = 0.0,
            temperature: float = 0.0, emissivity: float = 1.0) -> "Surface":
        """Uniform Rahman-Pinty-Verstraete surface."""
        p = np.asarray([rho0, k, theta], np.float32).reshape(1, 1, 3)
        return Surface(params=p, brdf_name="RPV",
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
        """The first parameter of the first pixel (float32 value): the
        uniform Lambertian albedo, or rho0 of a uniform RPV surface."""
        return float(self.params.reshape(-1)[0])

    def reflectance(self, x_frac, y_frac, mu_in, mu_out, phi_in, phi_out):
        """Reflectance for photons at fractional domain position (x, y)."""
        fn = BRDF_REGISTRY[self.brdf_name]
        nxs, nys, _ = self.params.shape
        ix = torch.clamp((x_frac * nxs).to(torch.int64), 0, nxs - 1)
        iy = torch.clamp((y_frac * nys).to(torch.int64), 0, nys - 1)
        params = torch.as_tensor(self.params, device=x_frac.device)[ix, iy]
        return fn(params, mu_in, mu_out, phi_in, phi_out)


def column_albedo(surface: Surface, nx: int, ny: int,
                  device) -> torch.Tensor:
    """A per-pixel albedo grid as one albedo per domain column, [nx*ny]
    float32 in column order ix*ny + iy: each pixel repeated over the
    nx/nxs x ny/nys columns it tiles, which is the reference's fractional
    lookup exactly when the pixels tile whole columns (the record and
    column kernels' surface_px_ok; pallas_kernel.py:2601-2622 and
    pallas_col.py:1291-1307 without their [rows, 128] and bf16 hi/lo
    packing); cached on the surface per grid shape and device."""
    key = ("_col_albedo", nx, ny, str(device))
    cache = surface.__dict__
    if key not in cache:
        p = np.asarray(surface.params[:, :, 0], np.float32)
        nxs, nys = p.shape
        col = np.repeat(np.repeat(p, nx // nxs, axis=0), ny // nys, axis=1)
        cache[key] = torch.tensor(col.reshape(-1), device=device)
    return cache[key]
