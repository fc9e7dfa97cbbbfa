"""Counter-based random numbers for the PyTorch port.

Every uniform is a pure function of (lane, step counter, draw site, seed):
two rounds of the murmur3 finalizer over the counter-mixed lane index, bit
for bit the mixer of the JAX record kernel's CPU path
(``mcbrat3d_tpu.transport.pallas_kernel._make_uniform`` with ``_N_SITES`` =
256). There is no generator state, so the CUDA kernel, the plain PyTorch
step and the JAX reference draw identical numbers for the same inputs, and
a lane may skip a draw it does not need without shifting any other.

uint32 arithmetic is carried in int64 tensors masked to 32 bits after each
multiply (PyTorch has no uint32 shifts on the CPU); the low 32 bits of a
wrapped int64 product are the uint32 product.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFF_FFFF
N_SITES = 256

# Draw sites of the record kernel's flux path (one stream per purpose;
# pallas_kernel.py:891-1017, :1133).
# the refill's x and y (emission: the offsets inside the voxel)
SITE_X = 0
SITE_Y = 1
# random-azimuth source: the beam's azimuth; flux source: its mu;
# emission: the z offset inside the voxel
SITE_SOURCE = 2
SITE_TAU = 3
SITE_COLLIDE = 4
SITE_ANGLE = 5
SITE_AZIMUTH = 6
SITE_ROULETTE = 7
# the scattering component, drawn only on domains of 2-3 components
SITE_COMPONENT = 8
# flux and emission sources: the azimuth
SITE_SOURCE_PHI = 9
# emission source (pallas_kernel.py:905-908): atmosphere or surface, the
# alias bin, its acceptance, and mu
SITE_EM_SPLIT = 10
SITE_EM_BIN = 11
SITE_EM_ACCEPT = 12
SITE_EM_MU = 13
# Radiance direction d draws its Iwabuchi roulette uniforms at sites
# 16 + 2d and 17 + 2d (d < 64, so every site stays below N_SITES).

_GOLDEN = 0x9E37_79B9
_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
_C3 = 0x8564_9F3D
_INV_2_24 = 2.0 ** -24


def fmix32(x):
    """murmur3 32-bit finalizer on int64 tensors (or Python ints) < 2^32."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 13)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def batch_seed(iseed: int, batch: int) -> int:
    """uint32 kernel seed for photon batch ``batch`` of a run seeded with
    ``iseed``: a bijective mix, so distinct (iseed, batch) pairs give
    independent streams and a run of N batches equals N serial batches."""
    s = fmix32((int(iseed) * _GOLDEN) & _M32)
    return fmix32(s ^ ((int(batch) * _C3 + 1) & _M32))


def uniform_at(lanes: torch.Tensor, counter, site, seed: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) for the int64 lane indices ``lanes`` at
    step ``counter`` and draw site ``site``, each an int or an int64 tensor
    of the lanes' shape (a queued local-estimate event carries its own step,
    and the radiance roulette draws one site per direction)."""
    seed = int(seed) & _M32
    if not isinstance(counter, torch.Tensor):
        counter = int(counter)
    if not isinstance(site, torch.Tensor):
        site = int(site)
    # int64 products wrap modulo 2^64, which keeps their low 32 bits
    c = ((counter * N_SITES + site) * _GOLDEN) & _M32
    x = fmix32(lanes ^ c)
    x = fmix32(x ^ (seed ^ ((c * _C3) & _M32)))
    return (x >> 8).to(torch.float32) * _INV_2_24


def make_uniform(lane: torch.Tensor, seed: int):
    """Returns ``u(counter, site, lanes=lane)`` -> float32 uniforms in
    [0, 1) for the int64 lane indices ``lane`` (or ``lanes``); ``counter``
    is the transport step, ``site`` an int or an int64 tensor of sites
    (``uniform_at``)."""

    def u(counter: int, site, lanes: torch.Tensor = lane) -> torch.Tensor:
        return uniform_at(lanes, int(counter), site, seed)

    return u
