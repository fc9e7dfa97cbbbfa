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

# Draw sites of the record kernel's flux path (one stream per purpose).
SITE_X = 0
SITE_Y = 1
SITE_TAU = 3
SITE_COLLIDE = 4
SITE_ANGLE = 5
SITE_AZIMUTH = 6
SITE_ROULETTE = 7

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


def make_uniform(lane: torch.Tensor, seed: int):
    """Returns ``u(counter, site)`` -> float32 uniforms in [0, 1) for the
    int64 lane indices ``lane``; ``counter`` is the transport step."""
    seed = int(seed) & _M32

    def u(counter: int, site: int) -> torch.Tensor:
        c = ((int(counter) * N_SITES + int(site)) * _GOLDEN) & _M32
        x = fmix32(lane ^ c)
        x = fmix32(x ^ (seed ^ ((c * _C3) & _M32)))
        return (x >> 8).to(torch.float32) * _INV_2_24

    return u
