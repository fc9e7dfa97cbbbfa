"""PyTorch port: analytic radiance oracles (those of
``tests/test_intensity.py``) on the plain path of the in-kernel radiance
(local estimation): a thin isotropic slab, the Henyey-Greenstein forward to
backward ratio, a Lambertian surface under a clear sky, the Iwabuchi
roulette against the full estimator and the contribution cap. The plain
step against the JAX record kernel is in ``test_torch_radiance.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.plane_parallel import make_slab
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)


def slab_radiance(dom, mu0, albedo, icfg, mus, phis, n_lanes, ppl, seed=0):
    t = run_batch(dom, Surface.lambertian(albedo),
                  illumination.directional(mu0, 0.0), rng.batch_seed(seed, 0),
                  KernelConfig(n_lanes=n_lanes, photons_per_lane=ppl,
                               max_steps=2000),
                  intensity_config=icfg,
                  intensity_dirs=le.make_intensity_directions(
                      mus, phis, device="cpu"))
    assert t.n_bad == 0
    return t.normalized(dom.grid).intensity.mean(dim=(0, 1)).numpy(), t


@pytest.fixture(scope="module")
def thin_slab():
    tau = 0.05
    dom = make_slab(tau=tau, ssa=1.0, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    compute_intensity_tables=True, device="cpu")
    rad, t = slab_radiance(dom, 1.0, 0.0,
                           le.IntensityConfig(n_dirs=2,
                                              use_russian_roulette=False),
                           [1.0, 0.5], [0.0, 0.0], 4096, 4)
    return tau, rad, t.n_photons


@pytest.mark.parametrize("i,mu_v", [(0, 1.0), (1, 0.5)])
def test_thin_isotropic_slab_radiance(thin_slab, i, mu_v):
    """First order: I(mu_v) = ssa tau P / (4 pi mu_v), P = 1, normal
    incidence, per unit incident flux on the horizontal."""
    tau, rad, n = thin_slab
    expect = tau / (4 * np.pi * mu_v)
    sigma = expect / np.sqrt(tau * n)
    assert abs(rad[i] - expect) < 4 * sigma + 0.03 * expect


def test_hg_forward_vs_backward_ratio():
    dom = make_slab(tau=0.1, ssa=1.0, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    phase=PhaseFunction.henyey_greenstein(0.7, 64),
                    compute_intensity_tables=True, device="cpu")
    rad, _ = slab_radiance(dom, 0.5, 0.0,
                           le.IntensityConfig(n_dirs=2,
                                              use_russian_roulette=False),
                           [0.5, 0.5], [0.0, 180.0], 4096, 4)
    forward, back = rad

    def hg(c):
        return (1 - 0.7**2) / (1 + 0.7**2 - 2 * 0.7 * c) ** 1.5

    assert forward > 3 * back
    np.testing.assert_allclose(forward / back, hg(0.5) / hg(-1.0), rtol=0.25)


def test_lambertian_surface_radiance():
    """tau ~ 0: every photon reflects once; the domain mean is
    albedo / pi per unit incident flux on the horizontal in every
    direction, up to float32 tally rounding."""
    dom = make_slab(tau=1e-6, ssa=1.0, nx=2, ny=2, nz=2, n_cdf_steps=101,
                    compute_intensity_tables=True, device="cpu")
    rad, _ = slab_radiance(dom, 0.7, 0.4,
                           le.IntensityConfig(n_dirs=2,
                                              use_russian_roulette=False),
                           [1.0, 0.5], [0.0, 45.0], 4096, 2)
    np.testing.assert_allclose(rad, 0.4 / np.pi, rtol=1e-4)


def test_roulette_unbiased_vs_full():
    """The Iwabuchi roulette estimator agrees with the full transmittance
    estimator in expectation (independent seeds)."""
    dom = make_slab(tau=2.0, ssa=0.99, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    phase=PhaseFunction.henyey_greenstein(0.6, 64),
                    compute_intensity_tables=True, device="cpu")

    def mean_rad(rr, seeds):
        vals = [slab_radiance(dom, 0.6, 0.0,
                              le.IntensityConfig(n_dirs=1,
                                                 use_russian_roulette=rr),
                              [0.8], [30.0], 2048, 2, seed=s)[0][0]
                for s in seeds]
        return np.mean(vals), np.std(vals, ddof=1) / np.sqrt(len(vals))

    full, fe = mean_rad(False, range(3))
    rr, re = mean_rad(True, range(3, 6))
    sigma = np.sqrt(fe**2 + re**2) + 1e-6
    assert abs(full - rr) < 4 * sigma + 0.05 * full, (full, rr, sigma)


def test_capping_preserves_total():
    dom = make_slab(tau=1.0, ssa=1.0, nx=4, ny=4, nz=4, n_cdf_steps=501,
                    phase=PhaseFunction.henyey_greenstein(0.85, 64),
                    compute_intensity_tables=True, device="cpu")
    base = le.IntensityConfig(n_dirs=1, use_russian_roulette=False)
    capped = dataclasses.replace(base, limit_contributions=True,
                                 max_contribution=0.005)
    _, t0 = slab_radiance(dom, 0.9, 0.0, base, [0.9], [0.0], 2048, 2)
    _, t1 = slab_radiance(dom, 0.9, 0.0, capped, [0.9], [0.0], 2048, 2)
    i0, i1 = t0.intensity[:, :, 0], t1.intensity[:, :, 0]
    torch.testing.assert_close(i1.sum(), i0.sum(), rtol=1e-3, atol=0.0)
    assert float(i1.max()) <= float(i0.max()) + 1e-6
