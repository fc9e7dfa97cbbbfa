"""PyTorch port: the record kernel's plain step against the JAX record
kernel in Pallas interpret mode, plus its own invariants.

On the CPU ``record_launch`` runs the plain PyTorch step; the CUDA kernel is
held against that plain step on the card by chip_smoke.py. Both packages
draw the same counter uniforms from the same folded seed, so photon paths
coincide up to float rounding.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mcbrat3d_tpu.core import rng as jrng
from mcbrat3d_tpu.physics.surface import Surface as JSurface
from mcbrat3d_tpu.scenes.step_cloud import make_step_cloud as jmake
from mcbrat3d_tpu.sources import illumination as jill
from mcbrat3d_tpu.transport.pallas_kernel import PallasConfig, run_batch_pallas
from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.scenes.step_cloud import make_step_cloud
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

torch.set_num_threads(1)

JAX_SMALL = PallasConfig(rows=16, block_rows=8, steps_per_call=32,
                         max_steps=6000, interpret=True)
SMALL = rk.RecordConfig(rows=16, steps_per_call=32, max_steps=6000)
SRC = illumination.directional(0.5, 0.0)

# Domain-mean R/T/A gap allowed between the plain step and the JAX kernel.
# Observed: ~2e-7 (the JAX tally adds bf16 hi/lo splits, ~2^-17 relative
# per add). 1e-3 leaves room for a few of the 4,096 photons to take another
# path after a 1-ulp difference in a transcendental, and is still 1/8 of
# the one-sigma MC noise (~8e-3) at this photon count.
RTA_GAP = 1e-3


def folded_seed(key) -> int:
    """The uint32 seed run_batch_pallas folds from a JAX key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64).reshape(-1)
    return int(((kd[0] * 0x9E37_79B9) & 0xFFFF_FFFF) ^ kd[-1])


def rta(fu, fd, ab, n):
    return np.array([float(np.sum(np.asarray(a))) for a in (fu, fd, ab)]) / n


def assert_pixels_agree(a_pairs, n_a, n_b):
    """Per-pixel z < 5 (the formula of tests/test_pallas.py)."""
    for a, b in a_pairs:
        a = np.asarray(a, np.float64) / n_a
        b = np.asarray(b, np.float64) / n_b
        sigma = np.sqrt(a / n_a + b / n_b + 1e-12)
        z = np.abs(a - b) / np.maximum(sigma, 1e-9)
        assert z.max() < 5.0, z.max()


@pytest.mark.parametrize("macro_factor,analytic,nx",
                         [(0, False, 32), (8, True, 32), (8, True, 36)])
def test_plain_step_matches_jax_interpret_kernel(macro_factor, analytic, nx):
    """nx = 36 with macro_factor 8 puts a partial macro block at the x seam
    (ny = 1 already makes the y block virtual)."""
    kw = dict(ssa=0.99, n_columns=nx, n_cdf_steps=201,
              macro_factor=macro_factor)
    jdom = jmake(**kw)
    tdom = make_step_cloud(**kw, device="cpu")
    if not analytic:  # the tabulated inverse-CDF phase (file-read domains)
        jdom = dataclasses.replace(jdom, all_hg=False)
        tdom = dataclasses.replace(tdom, all_hg=False)
    key = jrng.batch_key(3, 0)
    fu, fd, vol, n, n_bad, _ = run_batch_pallas(
        jdom, JSurface.lambertian(0.2), jill.directional(0.5, 0.0), key,
        JAX_SMALL, photons_per_lane=2)
    tu, td, tv, tn, t_bad, _ = rk.run_batch_record(
        tdom, Surface.lambertian(0.2), SRC, folded_seed(key), SMALL, 2)
    assert tn == int(n) == 16 * 128 * 2
    assert t_bad == int(n_bad) == 0
    tu, td, tv = (t.numpy() for t in (tu, td, tv))
    gap = np.abs(rta(tu, td, tv, tn) - rta(fu, fd, vol, int(n)))
    assert gap.max() < RTA_GAP, gap
    assert_pixels_agree([(tu, fu), (td, fd),
                         (tv.sum(axis=2), np.asarray(vol).sum(axis=2))],
                        tn, int(n))


@pytest.fixture(scope="module")
def step_cloud():
    return make_step_cloud(ssa=0.99, n_cdf_steps=201, device="cpu")


def test_energy_conservation_no_rr(step_cloud):
    """Without roulette every started weight is accounted for: with
    surface albedo rho, R + (1 - rho) T + A == 1 to float32 noise."""
    rho = 0.3
    fu, fd, ab, n, n_bad, _ = rk.run_batch_record(
        step_cloud, Surface.lambertian(rho), SRC, rng.batch_seed(3, 0),
        SMALL, 2, use_russian_roulette=False)
    assert n == 16 * 128 * 2 and n_bad == 0
    balance = float(fu.sum() + (1 - rho) * fd.sum() + ab.sum()) / n
    assert abs(balance - 1.0) < 2e-4


def test_n_photons_clamp_exact(step_cloud):
    _, _, _, n, n_bad, _ = rk.run_batch_record(
        step_cloud, Surface.lambertian(0.0),
        illumination.directional(1.0, 0.0), rng.batch_seed(0, 0), SMALL, 2,
        n_photons=777)
    assert n == 777 and n_bad == 0


def test_deterministic_in_seed(step_cloud):
    sfc = Surface.lambertian(0.0)
    out1 = rk.run_batch_record(step_cloud, sfc, SRC, rng.batch_seed(7, 1),
                               SMALL, 2)
    out2 = rk.run_batch_record(step_cloud, sfc, SRC, rng.batch_seed(7, 1),
                               SMALL, 2)
    out3 = rk.run_batch_record(step_cloud, sfc, SRC, rng.batch_seed(7, 2),
                               SMALL, 2)
    for a, b in zip(out1[:3], out2[:3]):
        assert torch.equal(a, b)
    assert out1[3:] == out2[3:]
    assert not torch.equal(out1[0], out3[0])


def test_column_and_volume_tallies_agree(step_cloud):
    """Same seed, same paths: the per-column absorption layout equals the
    3D tally summed over z, and the fluxes are identical."""
    seed = rng.batch_seed(5, 0)
    sfc = Surface.lambertian(0.1)
    v = rk.run_batch_record(step_cloud, sfc, SRC, seed, SMALL, 2)
    c = rk.run_batch_record(step_cloud, sfc, SRC, seed,
                            dataclasses.replace(SMALL, vol_tally=False), 2)
    assert v[2].shape == (32, 1, 32) and c[2].shape == (32, 1)
    assert torch.equal(v[0], c[0]) and torch.equal(v[1], c[1])
    torch.testing.assert_close(v[2].sum(dim=2), c[2], rtol=1e-5, atol=1e-4)
    assert v[3:] == c[3:]


def test_macro_majorant_at_periodic_seam():
    """nx = 36 with macro_factor 8: the last macro block is partial, so its
    outer face lies past the periodic seam. Clamped faces keep the
    two-level majorant exact: it must agree with the global majorant."""
    sfc = Surface.lambertian(0.0)
    out = {}
    for mf in (0, 8):
        dom = make_step_cloud(ssa=0.99, n_columns=36, n_cdf_steps=201,
                              macro_factor=mf, device="cpu")
        out[mf] = rk.run_batch_record(dom, sfc, SRC, rng.batch_seed(11, mf),
                                      SMALL, 4)
    n0, n8 = out[0][3], out[8][3]
    assert n0 == n8 == 16 * 128 * 4
    assert_pixels_agree([(out[8][i].numpy(), out[0][i].numpy())
                         for i in range(2)]
                        + [(out[8][2].sum(dim=2).numpy(),
                            out[0][2].sum(dim=2).numpy())], n8, n0)
    r0 = rta(*(t.numpy() for t in out[0][:3]), n0)
    r8 = rta(*(t.numpy() for t in out[8][:3]), n8)
    sigma = np.sqrt(r0 * (1 - r0) * 2 / n0)
    assert np.all(np.abs(r8 - r0) < 4.5 * sigma), (r8, r0)


def test_run_batch_flux_only_layout(step_cloud):
    cfg = KernelConfig(n_lanes=2048, photons_per_lane=1, max_steps=6000,
                       need_volume_absorption=False)
    t = run_batch(step_cloud, Surface.lambertian(0.0), SRC,
                  rng.batch_seed(1, 0), cfg)
    assert t.volume_absorption is None
    assert t.flux_absorbed.shape == (32, 1)
    assert t.n_photons == 2048 and t.n_bad == 0
    assert t.n_steps % 128 == 0


def test_dispatch_raises_outside_the_port():
    """Past the record kernel's cells, a domain that is no template, with
    the absorption profile (which the tiled kernel does not tally), is
    outside every ported kernel; the error names the tiled kernel's
    failing predicate when use_pallas='on' (with 'auto' the wave kernel
    runs it)."""
    dense = make_step_cloud(ssa=0.99, n_columns=32, n_layers=1200,
                            n_cdf_steps=101, device="cpu")
    cfg = KernelConfig(n_lanes=1024, photons_per_lane=1,
                       need_volume_absorption=False,
                       need_absorption_profile=True, use_pallas="on")
    with pytest.raises(ValueError, match="K5.*need_absorption_profile"):
        run_batch(dense, Surface.lambertian(0.0), SRC, 0, cfg)
    with pytest.raises(ValueError, match="use_ray_tracing"):
        run_batch(make_step_cloud(n_cdf_steps=101, device="cpu"),
                  Surface.lambertian(0.0), SRC, 0,
                  dataclasses.replace(cfg, use_ray_tracing=True))


def test_wrapper_refuses_other_devices(step_cloud):
    """CPU tensors take the plain step; a CUDA tensor goes to the kernel
    (checked on the card by chip_smoke.py); anything else raises."""
    prm = rk.RecordParams.make(step_cloud, Surface.lambertian(0.0), SRC,
                               True, 1.0, True)
    st = rk.RecordState.initial(
        torch.ones(128, dtype=torch.int32, device="meta"), 1.0)
    with pytest.raises(ValueError, match="meta"):
        rk.record_launch(st, rk.RecordTables.from_domain(step_cloud), prm,
                         0, 0, 1, rk.RecordTally.zeros(prm, "cpu"))
