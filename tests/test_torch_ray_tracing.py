"""PyTorch port: the DDA marcher and the wave kernel's ray-traced free
paths against analytic values and the maximum cross-section mode.

The five cases of ``tests/test_ray_tracing.py`` on the port's
``transport/dda.trace`` and wave kernel, on the CPU: the optical depth of a
straight ray through the step cloud's thick half (18, rtol 1e-3), of a
45-degree ray wrapping through a slab's periodic x (2 sqrt(2) x the depth
crossed, rtol 1e-4), a stop inside a slab at tau 1.5 (rtol 1e-5, its
height rtol 1e-3); energy conservation of ray-traced transport without
roulette (R + T + A = photons within 1e-4, n_bad 0); and the ray-traced
and maximum cross-section modes' R, T, A within 4 combined sigma + 1%
(the reference offers both modes; reference:
Integrators/monteCarloRadiativeTransfer.f95:555-571). Both modes run on
the wave kernel (JAX's XLA path, which the record kernel's refusal of
ray tracing selects), 1,024 lanes x 2 photons a seed where JAX's test runs
4,096 x 4.
"""

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.plane_parallel import make_slab
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import dda, integrator
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)


def t32(*v):
    return torch.tensor(v, dtype=torch.float32)


def rta(domain, cfg, seeds, mu0=0.5):
    vals = []
    for s in seeds:
        t = run_batch(domain, Surface.lambertian(0.0),
                      illumination.directional(mu0, 0.0),
                      rng.batch_seed(s, 0), cfg, key=rng.batch_key(s, 0))
        n = int(t.n_photons)
        assert int(t.n_bad) == 0
        vals.append([float(t.flux_up.sum()) / n, float(t.flux_down.sum()) / n,
                     float(t.flux_absorbed.sum()) / n])
    v = np.asarray(vals)
    return v.mean(0), v.std(0, ddof=1) / np.sqrt(len(seeds))


def test_straight_ray_optical_depth():
    """Vertical ray through the thick half of the step cloud: tau = 18."""
    dom = make_step_cloud(ssa=1.0, n_cdf_steps=101, device="cpu")
    r = dda.trace(dom, t32(400.0), t32(250.0), t32(0.01), t32(0.0),
                  t32(0.0), t32(1.0), torch.tensor([True]))
    assert bool(r["exit_top"][0])
    np.testing.assert_allclose(float(r["tau"][0]), 18.0, rtol=1e-3)


def test_oblique_ray_with_periodic_wrap():
    """45-degree ray in x-z through mixed columns with x wrapping: the
    path per layer is sqrt(2) dz, so tau = tau_column sqrt(2) over the
    depth crossed."""
    dom = make_slab(tau=2.0, ssa=1.0, nx=4, ny=4, nz=8, n_cdf_steps=101,
                    device="cpu")
    s = float(np.float32(1 / np.sqrt(2)))
    r = dda.trace(dom, t32(0.5), t32(0.5), t32(0.001), t32(s), t32(0.0),
                  t32(s), torch.tensor([True]))
    assert bool(r["exit_top"][0])
    np.testing.assert_allclose(float(r["tau"][0]),
                               2.0 * np.sqrt(2) * (1.0 - 0.001), rtol=1e-4)


def test_tau_stop_inside_domain():
    dom = make_slab(tau=4.0, ssa=1.0, nx=2, ny=2, nz=8, n_cdf_steps=101,
                    device="cpu")
    r = dda.trace(dom, t32(0.5), t32(0.5), t32(0.999), t32(0.0), t32(0.0),
                  t32(-1.0), torch.tensor([True]), tau_stop=t32(1.5))
    assert bool(r["stopped"][0])
    np.testing.assert_allclose(float(r["tau"][0]), 1.5, rtol=1e-5)
    # z where tau = 1.5 from the top: a depth of 1.5 / 4 of the slab
    np.testing.assert_allclose(float(r["z"][0]), 0.999 - 1.5 / 4.0,
                               rtol=1e-3)


def test_ray_traced_conservation():
    cfg = KernelConfig(n_lanes=1 << 10, photons_per_lane=2, max_steps=3000,
                       use_ray_tracing=True, use_russian_roulette=False)
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=501, device="cpu")
    before = integrator.WAVE_BATCHES
    t = run_batch(dom, Surface.lambertian(0.0),
                  illumination.directional(0.5, 0.0), rng.batch_seed(0, 0),
                  cfg, key=rng.batch_key(0, 0))
    assert integrator.WAVE_BATCHES == before + 1
    n = int(t.n_photons)
    total = (float(t.flux_up.sum()) + float(t.flux_down.sum())
             + float(t.flux_absorbed.sum()))
    assert int(t.n_bad) == 0 and n == 2048
    np.testing.assert_allclose(total, n, rtol=1e-4)


def test_ray_tracing_agrees_with_max_cross_section():
    dom = make_step_cloud(ssa=0.99, n_cdf_steps=501, device="cpu")
    cfg_ray = KernelConfig(n_lanes=1 << 10, photons_per_lane=2,
                           max_steps=3000, use_ray_tracing=True)
    cfg_mxs = KernelConfig(n_lanes=1 << 10, photons_per_lane=2,
                           max_steps=6000, use_pallas="off")
    m_ray, e_ray = rta(dom, cfg_ray, seeds=range(3))
    m_mxs, e_mxs = rta(dom, cfg_mxs, seeds=range(3, 6))
    sigma = np.sqrt(e_ray**2 + e_mxs**2) + 1e-4
    assert np.all(np.abs(m_ray - m_mxs) < 4 * sigma + 0.01 * m_mxs), (
        m_ray, m_mxs, sigma)
