"""PyTorch port: JAX's threefry streams (``core.rng``) against jax.random.

The XLA wave kernel draws ``uniform(step_key(batch_key(seed, b), step,
purpose), n)``; the port derives the keys on the host as Python ints and
draws the bits in int64 tensors. Keys, raw bits, uniforms (also on
[0, 2 pi)) and ``randint`` (the emission source's voxel bin) equal
jax.random's bit for bit under jax_threefry_partitionable, for several
seeds, batches, steps and purposes and n of 1, 7, 2,048 and 16,387.

``exponential_deviate`` is -log of that uniform with ``rng.xla_log``, the
log XLA's CPU code computes (Cephes' polynomial with fused multiply-adds;
it differs from the correctly rounded log in the last bit on ~14% of
arguments): bit for bit with jax.random's deviate, and ``xla_log`` with
``jnp.log`` on every value the uniform can take and on a spread of
positive floats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu_torch.core import rng

SEEDS = [(0, 0), (10, 3), (12345, 77), (2**31 - 1, 5)]
SIZES = [1, 7, 2048, 16387]


def key_pair(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def bits_u32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_jax_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,batch", SEEDS)
def test_keys(seed, batch):
    jkey = jrng.batch_key(seed, batch)
    assert key_pair(jkey) == rng.batch_key(seed, batch)
    for step, purpose in ((0, rng.TAU), (17, rng.SCAT_ANGLE),
                          (4095, rng.INTENSITY_RR), (19999, rng.SOURCE)):
        assert key_pair(jrng.step_key(jkey, step, purpose)) == \
            rng.step_key(rng.batch_key(seed, batch), step, purpose)
    for data in (0, 1, 7, 2**32 - 1):
        assert key_pair(jax.random.fold_in(jkey, data)) == \
            rng.fold_in(key_pair(jkey), data)
    ja, jb = jax.random.split(jkey)
    assert (key_pair(ja), key_pair(jb)) == rng.split(key_pair(jkey))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed,batch", SEEDS)
def test_draws(seed, batch, n):
    jkey = jrng.step_key(jrng.batch_key(seed, batch), 3 + n % 11,
                         n % 10)
    key = key_pair(jkey)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jkey, (n,), jnp.uint32)),
        rng.random_bits(key, n, "cpu").numpy().astype(np.uint32))
    np.testing.assert_array_equal(
        bits_u32(jrng.uniform(jkey, (n,))),
        bits_u32(rng.uniform(key, n, "cpu").numpy()))
    np.testing.assert_array_equal(
        bits_u32(jrng.uniform(jkey, (n,), 0.0, 2.0 * np.pi)),
        bits_u32(rng.uniform(key, n, "cpu", 0.0, 2.0 * np.pi).numpy()))
    np.testing.assert_array_equal(
        bits_u32(jrng.uniform_open(jkey, (n,))),
        bits_u32(rng.uniform_open(key, n, "cpu").numpy()))
    for hi in (7, 24576, 1 << 20):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jkey, (n,), 0, hi, jnp.int32)),
            rng.randint(key, n, hi, "cpu").numpy())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed,batch", SEEDS)
def test_exponential_deviate(seed, batch, n):
    jkey = jrng.step_key(jrng.batch_key(seed, batch), 5, rng.TAU)
    np.testing.assert_array_equal(
        bits_u32(jrng.exponential_deviate(jkey, (n,))),
        bits_u32(rng.exponential_deviate(key_pair(jkey), n, "cpu").numpy()))


def test_xla_log():
    u = (np.arange(1, 2**23 + 1) * 2.0**-23).astype(np.float32)
    wide = np.exp(np.random.RandomState(0).uniform(-87.0, 88.0, 200_000)
                  ).astype(np.float32)
    for x in (u, wide, np.float32([1.0, 2.0, 0.5, 1e-30, 3e38])):
        np.testing.assert_array_equal(
            bits_u32(jax.jit(jnp.log)(x)),
            bits_u32(rng.xla_log(torch.from_numpy(x)).numpy()))
