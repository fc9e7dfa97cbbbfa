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

import numpy as np
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


# ---------------------------------------------------------------------------
# The JAX package's threefry streams (mcbrat3d_tpu/core/rng.py), bit for bit
# with jax.random under jax_threefry_partitionable: the XLA wave kernel
# (transport.integrator) draws these, so a batch run at JAX's key takes
# JAX's paths. Keys are pairs of Python ints (derived on the host); the bits
# are drawn in int64 tensors masked to 32 bits, as fmix32 above.

# Purpose tags of the wave kernel's draw sites (one stream each).
TAU = 0
COLLISION = 1
COMPONENT = 2
SCAT_ANGLE = 3
SCAT_AZIMUTH = 4
ROULETTE = 5
SURFACE_MU = 6
SURFACE_PHI = 7
SOURCE = 8
INTENSITY_RR = 9

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD1_1BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: tuple, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under
    ``key`` = (k0, k1): Python ints or int64 tensors < 2^32 (jax's
    ``_threefry2x32_lowering``). Returns the output pair."""
    ks = (key[0] & _M32, key[1] & _M32)
    ks = ks + (ks[0] ^ ks[1] ^ _KS_PARITY,)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: the key hashed with the counter (0, data)."""
    return threefry2x32(key, 0, int(data) & _M32)


def batch_key(seed: int, batch_index: int) -> tuple:
    """JAX's key of photon batch ``batch_index`` of a run seeded with
    ``seed``: fold_in(fold_in(key(0), seed), batch_index)."""
    return fold_in(fold_in((0, 0), seed), batch_index)


def step_key(bkey: tuple, step: int, purpose: int) -> tuple:
    """Key of one wave step and draw site within a batch."""
    return fold_in(fold_in(bkey, step), purpose)


def split(key: tuple) -> tuple:
    """``jax.random.split(key)`` into two keys (the fold-like split: the
    key hashed with the counters (0, 0) and (0, 1))."""
    a0, a1 = threefry2x32(key, 0, 0)
    b0, b1 = threefry2x32(key, 0, 1)
    return (a0, a1), (b0, b1)


def random_bits(key: tuple, n: int, device) -> torch.Tensor:
    """n 32-bit words as int64 in [0, 2^32): element i hashes the counter
    (0, i) and xors the two output words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, torch.zeros_like(i), i)
    return x0 ^ x1


def uniform(key: tuple, n: int, device, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """float32 U[lo, hi): the high 23 bits as the mantissa of [1, 2),
    minus one, scaled (jax.random.uniform in float32)."""
    f = (random_bits(key, n, device) >> 9).to(torch.float32) * 2.0 ** -23
    if lo == 0.0 and hi == 1.0:
        return f
    lo32 = torch.tensor(lo, dtype=torch.float32, device=device)
    span = torch.tensor(hi, dtype=torch.float32, device=device) - lo32
    return torch.maximum(lo32, f * span + lo32)


# Cephes' single-precision log, in the form XLA's CPU code evaluates it:
# the significand in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in three
# Horner parts, ln 2 split in two, and every multiply-add fused.
_LOG_P = tuple(float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRT_HALF = float(np.float32(0.707106781186547524))
_MIN_NORMAL = float(np.float32(1.17549435e-38))


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once: the product is exact in float64, the
    sum rounds there and again to float32, which equals one rounding on
    the logarithm's arguments (checked against XLA on every uniform)."""
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values, bit for bit with XLA's CPU
    ``log`` (which is not correctly rounded: it differs from
    ``torch.log`` in the last bit on ~14% of arguments). Arguments below
    the smallest normal float are raised to it."""
    x = torch.clamp(x, min=_MIN_NORMAL).contiguous()
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0
    m = ((bits & ~0x7F80_0000) | 0x3F00_0000).view(torch.float32)
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    t = _fma(x2, -0.5, t) + y
    return _fma(e, _LOG_Q2, t)


def uniform_open(key: tuple, n: int, device) -> torch.Tensor:
    """U(0, 1]: never exactly 0, safe for -log(u)."""
    return 1.0 - uniform(key, n, device)


def exponential_deviate(key: tuple, n: int, device) -> torch.Tensor:
    """Optical-depth free path: -log(U(0, 1]), with XLA's log."""
    return -xla_log(uniform_open(key, n, device))


def randint(key: tuple, n: int, hi: int, device) -> torch.Tensor:
    """int64 in [0, hi) as ``jax.random.randint(key, (n,), 0, hi, int32)``:
    two words a draw from the split key, combined modulo hi in uint32
    arithmetic."""
    k1, k2 = split(key)
    span = int(hi)
    mult = (1 << 16) % span
    mult = (mult * mult) % span
    higher = random_bits(k1, n, device)
    lower = random_bits(k2, n, device)
    off = (((higher % span) * mult) & _M32) + lower % span
    return (off & _M32) % span
