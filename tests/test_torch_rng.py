"""PyTorch port: counter RNG and the scattering helpers against JAX.

The port's murmur3 uniforms must be bit-identical to the JAX record
kernel's CPU mixer (so both follow the same photon paths), and its HG
sampling / rotation must match the JAX integrator's on the same numpy
inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.transport import integrator as jint
from mcbrat3d_tpu.transport.pallas_kernel import _make_uniform
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.transport import integrator as tint

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 12345, 0xFFFF_FFFF, 0x9E37_79B9])
def test_uniform_bit_exact_vs_pallas_mixer(seed):
    rs = np.random.default_rng(seed & 0xFFFF)
    lanes = rs.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    lanes[:3] = (0, 1, 0xFFFF_FFFF)
    u_jax = _make_uniform(jnp.asarray(lanes), jnp.uint32(seed))
    u_port = rng.make_uniform(torch.from_numpy(lanes.astype(np.int64)), seed)
    ctrs = [0, 1, 31, 2 ** 24 + 5, 2 ** 31 + 3,
            int(rs.integers(0, 2 ** 32))]
    for ctr in ctrs:
        for site in (0, 1, 3, 4, 5, 6, 7, 143, 255):
            want = np.asarray(u_jax(jnp.uint32(ctr), site))
            got = u_port(ctr, site).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"ctr={ctr} site={site}")


def test_uniform_range_and_batch_seeds():
    u = rng.make_uniform(torch.arange(1 << 16, dtype=torch.int64), 7)(3, 5)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5e-3
    seeds = {rng.batch_seed(i, b) for i in range(8) for b in range(64)}
    assert len(seeds) == 8 * 64
    assert all(0 <= s < 2 ** 32 for s in seeds)


def test_hg_cosine_matches_jax():
    rs = np.random.default_rng(1)
    g = rs.uniform(-0.95, 0.95, 20000).astype(np.float32)
    g[:100] = 0.0
    g[100:200] = 5e-6
    u = rs.random(20000).astype(np.float32)
    want = np.asarray(jint.sample_hg_cos(jnp.asarray(g), jnp.asarray(u)))
    got = tint.sample_hg_cos(torch.from_numpy(g), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_rotation_matches_jax():
    rs = np.random.default_rng(2)
    n = 20000
    v = rs.standard_normal((3, n))
    v /= np.linalg.norm(v, axis=0)
    v[:, :50] = np.array([[0.0], [0.0], [1.0]])   # vertical: the safe branch
    v[:, 50:100] = np.array([[0.0], [0.0], [-1.0]])
    ux, uy, uz = v.astype(np.float32)
    ct = rs.uniform(-1, 1, n).astype(np.float32)
    phi = rs.uniform(0, 2 * np.pi, n).astype(np.float32)
    want = jint.rotate_direction(*(jnp.asarray(a) for a in
                                   (ux, uy, uz, ct, phi)))
    got = tint.rotate_direction(*(torch.from_numpy(a) for a in
                                  (ux, uy, uz, ct, phi)))
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-6)
    norm = torch.sqrt(got[0] ** 2 + got[1] ** 2 + got[2] ** 2)
    np.testing.assert_allclose(norm.numpy(), 1.0, atol=1e-6)
