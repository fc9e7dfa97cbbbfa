"""PyTorch port: the XLA wave kernel's DDA march, emission source and local
estimator against the JAX package's, path for path.

Both packages' ``run_batch(..., use_pallas="off")`` at the same threefry
key on the CPU, with ``tests/test_torch_wave_kernel.py``'s checks (equal
photons, steps and bad photons; flux tallies within 1% in L1 and 0.2% in
total; at most 0.5% of the lanes parted): the step cloud with
``use_ray_tracing`` and ``record_scattering_orders=3``, per-voxel emission
with ``lw_mode`` and radiance at birth, and radiance at mu 0.1 over an RPV
surface with ``limit_contributions``, the hybrid phase function and
``n_orders_orig_phase``. Radiance images are held as the fluxes are (L1
within 2%, each direction's total within 1%): a parted photon carries its
whole local-estimate history with it, and radiance is heavy-tailed.
"""

import numpy as np
import torch

from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes import step_cloud as jstep
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport import local_estimate as jle
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes import step_cloud as pstep
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le

from test_torch_wave_kernel import compare, configs

torch.set_num_threads(1)

RAD_L1_GAP = 2e-2
RAD_TOTAL_GAP = 1e-2


def small_cloud(pkg_step, **kw):
    """An 8 x 1 x 8 step cloud (optical depths 2 and 6) with ssa 0.95."""
    return pkg_step.make_step_cloud(ssa=0.95, n_columns=8, n_layers=8,
                                    tau_thick=6.0, **kw)


def assert_images(jt, pt):
    a = np.asarray(jt.intensity, np.float64)
    b = pt.intensity.numpy().astype(np.float64)
    assert a.shape == b.shape
    total = a.sum(axis=(0, 1))
    assert np.all(total > 0)
    assert np.all(np.abs(a - b).sum(axis=(0, 1)) <= RAD_L1_GAP * total)
    assert np.all(np.abs(b.sum(axis=(0, 1)) - total) <= RAD_TOTAL_GAP * total)


def test_ray_tracing_scattering_orders():
    """DDA free paths (the march stops at the sampled optical depth) and
    the boundary fluxes by scattering order (3 orders and overflow)."""
    jd = jstep.make_step_cloud(ssa=0.99)
    pd = pstep.make_step_cloud(ssa=0.99, device="cpu")
    kw = dict(n_lanes=512, photons_per_lane=2, use_ray_tracing=True,
              record_scattering_orders=3)
    jt, pt = compare(
        (jd, JSurface.lambertian(0.3), jill.directional(0.7, 0.0)),
        (pd, Surface.lambertian(0.3), illumination.directional(0.7, 0.0)),
        *configs(**kw),
        fields=("flux_up", "flux_down", "flux_absorbed",
                "flux_up_by_order", "flux_down_by_order"))
    assert pt.flux_up_by_order.shape == (32, 1, 4)
    np.testing.assert_allclose(pt.flux_up_by_order.sum(dim=2),
                               pt.flux_up, rtol=1e-5, atol=1e-4)


def test_emission_lw_mode():
    """Per-voxel emission (alias bin, acceptance, position, isotropic or
    Lambertian-up direction) with the lw_mode pre-credits, and radiance
    at birth: 1 / (4 pi |mu|) from the atmosphere, 1 / pi from the
    surface."""
    rs = np.random.RandomState(3)
    shape = (8, 1, 8)
    cdf = np.cumsum(rs.uniform(0.1, 1.0, 64))
    cdf /= cdf[-1]
    mus, phis = [1.0, 0.6], [0.0, 45.0]
    jd = small_cloud(jstep, compute_intensity_tables=True)
    pd = small_cloud(pstep, device="cpu", compute_intensity_tables=True)
    jt, pt = compare(
        (jd, JSurface.lambertian(0.1), jill.emission(cdf, 0.7, shape)),
        (pd, Surface.lambertian(0.1),
         illumination.emission(cdf, 0.7, shape, device="cpu")),
        *configs(n_lanes=512, photons_per_lane=2, lw_mode=True),
        jkw=dict(intensity_config=jle.IntensityConfig(n_dirs=2),
                 intensity_dirs=jle.make_intensity_directions(mus, phis)),
        pkw=dict(intensity_config=le.IntensityConfig(n_dirs=2),
                 intensity_dirs=le.make_intensity_directions(
                     mus, phis, device="cpu")))
    # the pre-credits make some cells' net absorption negative
    assert float(pt.volume_absorption.min()) < 0
    assert_images(jt, pt)


def test_radiance_rpv_capped_hybrid_orig():
    """Radiance at mu 0.1 (below every kernel's floor) and two steeper
    directions over an RPV surface: the BRDF toward each direction, the
    Iwabuchi roulette, contributions capped with the excess spread back,
    the hybrid phase rows and the original rows for the first 2 orders."""
    mus, phis = [0.1, 0.5, 1.0], [0.0, 45.0, 90.0]
    kw = dict(compute_intensity_tables=True, hybrid_width_deg=10.0,
              n_cdf_steps=201)
    jd, pd = small_cloud(jstep, **kw), small_cloud(pstep, device="cpu", **kw)
    ic = dict(n_dirs=3, limit_contributions=True, max_contribution=2.0,
              n_orders_orig_phase=2)
    jt, pt = compare(
        (jd, JSurface.rpv(0.25, 0.8, -0.15), jill.directional(0.5, 30.0)),
        (pd, Surface.rpv(0.25, 0.8, -0.15),
         illumination.directional(0.5, 30.0)),
        *configs(n_lanes=512, photons_per_lane=2),
        jkw=dict(intensity_config=jle.IntensityConfig(**ic),
                 intensity_dirs=jle.make_intensity_directions(mus, phis)),
        pkw=dict(intensity_config=le.IntensityConfig(**ic),
                 intensity_dirs=le.make_intensity_directions(
                     mus, phis, device="cpu")))
    assert_images(jt, pt)
