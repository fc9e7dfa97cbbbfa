"""Photon sources (PyTorch port): the directional solar beam, the beam
with a random azimuth and the isotropic (cosine-weighted) flux.

Counterpart of ``mcbrat3d_tpu.sources.illumination`` (reference:
src/monteCarloIllumination.f95:62-101). The transport kernel samples the
source on the fly when a lane refills, so a Source is a few parameters.
The record kernel takes ``directional`` only; the column kernel all three.
Spotlight and emission sources arrive with the record kernel's envelope
(ROADMAP Queue 1 items 4 and 10).
"""

from __future__ import annotations

import dataclasses

import numpy as np

DIRECTIONAL = "directional"
RANDOM_AZIMUTH = "random_azimuth"
FLUX = "flux"
SPOTLIGHT = "spotlight"
EMISSION = "emission"


@dataclasses.dataclass(frozen=True)
class Source:
    """Photon source parameters (float32 values held as Python floats)."""

    kind: str
    solar_mu: float = 0.0       # |mu0|; photons travel with mu = -|mu0|
    solar_azimuth: float = 0.0  # radians


def directional(solar_mu: float, solar_azimuth_deg: float) -> Source:
    """Solar beam (reference: src/monteCarloIllumination.f95:62-101)."""
    if abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30:
        raise ValueError("solar_mu out of bounds")
    if not 0.0 <= solar_azimuth_deg <= 360.0:
        raise ValueError("solar azimuth out of bounds")
    return Source(kind=DIRECTIONAL,
                  solar_mu=float(np.float32(abs(solar_mu))),
                  solar_azimuth=float(np.float32(
                      np.deg2rad(solar_azimuth_deg))))


def random_azimuth(solar_mu: float) -> Source:
    """Beam at |mu0| with an azimuth drawn per photon."""
    if abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30:
        raise ValueError("solar_mu out of bounds")
    return Source(kind=RANDOM_AZIMUTH,
                  solar_mu=float(np.float32(abs(solar_mu))))


def flux() -> Source:
    """Isotropic downward flux: mu = -sqrt(u), azimuth uniform."""
    return Source(kind=FLUX)
