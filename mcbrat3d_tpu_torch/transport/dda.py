"""Vectorized DDA voxel ray marcher (PyTorch port).

Counterpart of ``mcbrat3d_tpu.transport.dda`` (reference:
src/opticalProperties.f95:1656-1815, accumulateExtinctionAlongPath): a
bundle of rays marches through the gridded extinction, accumulating optical
depth until it leaves through the top or bottom or reaches an optional
target depth ``tau_stop``. The XLA wave kernel uses it for the ray-traced
free path (``use_ray_tracing``) and for the local estimate's
transmittance. Cell indices are part of the marcher's state (a position on
a face is ambiguous); each step clamps the face distances to >= 0 and
snaps every dimension whose face ties the minimum, so a ray rounded one
ulp past a face heals on the next iteration.

The march loop runs on the rays' device; it syncs once an iteration for
its any-running test, as the JAX ``while_loop`` tests its condition.
"""

from __future__ import annotations

import torch

BIG = 3e38


def _inv(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u.abs() < 1e-12, BIG,
                       1.0 / torch.where(u == 0, 1.0, u))


def trace(domain, x, y, z, ux, uy, uz, active, tau_stop=None,
          max_crossings: int = 0) -> dict:
    """March rays until they leave through z or reach ``tau_stop``.

    ``x``, ``y``, ``z`` [N] start strictly inside the domain, ``ux``,
    ``uy``, ``uz`` [N] are unit direction cosines and ``active`` [N] bool
    the lanes to trace. ``max_crossings`` bounds the voxel crossings (0:
    4 (nx + ny + nz) + 64). Returns a dict of tensors: ``tau`` (the
    accumulated depth; ``tau_stop`` where stopped; -1 where the crossing
    budget ran out, the bad-photon flag), the final ``x``, ``y``, ``z``,
    the final horizontal cell ``ix``, ``iy`` and the outcome flags
    ``exit_top``, ``exit_bot`` and ``stopped``."""
    grid = domain.grid
    nx, ny, nz = grid.shape
    xe, ye, ze = grid.x_edges, grid.y_edges, grid.z_edges
    ext_flat = domain.total_ext.reshape(-1)
    if max_crossings <= 0:
        max_crossings = 4 * (nx + ny + nz) + 64

    ix = grid.locate_x(x)
    iy = grid.locate_y(y)
    iz = grid.locate_z(z)
    has_stop = tau_stop is not None
    if not has_stop:
        tau_stop = torch.full_like(x, BIG)

    pos_x = (ux >= 0).long()
    pos_y = (uy >= 0).long()
    pos_z = (uz >= 0).long()
    inc_x, inc_y, inc_z = 2 * pos_x - 1, 2 * pos_y - 1, 2 * pos_z - 1
    inv_ux, inv_uy, inv_uz = _inv(ux), _inv(uy), _inv(uz)
    flat_x, flat_y, flat_z = (ux.abs() < 1e-12, uy.abs() < 1e-12,
                              uz.abs() < 1e-12)

    tau = torch.zeros_like(x)
    running = active.clone()
    exit_top = torch.zeros_like(active)
    exit_bot = torch.zeros_like(active)
    stopped = torch.zeros_like(active)
    n = 0
    while n < max_crossings and bool(running.any()):
        run = running
        fx, fy, fz = xe[ix + pos_x], ye[iy + pos_y], ze[iz + pos_z]
        tx = torch.where(flat_x, BIG, torch.clamp((fx - x) * inv_ux, min=0.0))
        ty = torch.where(flat_y, BIG, torch.clamp((fy - y) * inv_uy, min=0.0))
        tz = torch.where(flat_z, BIG, torch.clamp((fz - z) * inv_uz, min=0.0))
        t = torch.minimum(tx, torch.minimum(ty, tz))
        beta = ext_flat[(ix * ny + iy) * nz + iz]

        # early stop inside this cell once tau_stop is reached
        # (reference: src/opticalProperties.f95:1729-1739)
        d_tau = t * beta
        if has_stop:
            hits = run & (tau + d_tau > tau_stop)
        else:
            hits = torch.zeros_like(run)
        t_part = torch.where(beta > 0, (tau_stop - tau)
                             / torch.clamp(beta, min=1e-30), 0.0)
        t_eff = torch.where(hits, t_part, t)
        tau = torch.where(run, torch.where(hits, tau_stop, tau + d_tau), tau)

        # advance; crossing dimensions snap exactly to their face
        go = run & ~hits
        cross_x, cross_y, cross_z = (go & (tx <= t), go & (ty <= t),
                                     go & (tz <= t))
        nxp = torch.where(cross_x, fx, x + t_eff * ux)
        nyp = torch.where(cross_y, fy, y + t_eff * uy)
        nzp = torch.where(cross_z, fz, z + t_eff * uz)
        nix = ix + torch.where(cross_x, inc_x, 0)
        niy = iy + torch.where(cross_y, inc_y, 0)
        niz = iz + torch.where(cross_z, inc_z, 0)

        # periodic wrap in x and y (reference:
        # src/opticalProperties.f95:1782-1796)
        lo, hi = nix < 0, nix >= nx
        nix = torch.where(lo, nx - 1, torch.where(hi, 0, nix))
        nxp = torch.where(lo, xe[-1], torch.where(hi, xe[0], nxp))
        lo, hi = niy < 0, niy >= ny
        niy = torch.where(lo, ny - 1, torch.where(hi, 0, niy))
        nyp = torch.where(lo, ye[-1], torch.where(hi, ye[0], nyp))

        # leaving through z (reference: src/opticalProperties.f95:1799-1812)
        out_top = run & (niz >= nz)
        out_bot = run & (niz < 0)
        niz = torch.clamp(niz, 0, nz - 1)

        x = torch.where(run, nxp, x)
        y = torch.where(run, nyp, y)
        z = torch.where(run, nzp, z)
        ix = torch.where(run, nix, ix)
        iy = torch.where(run, niy, iy)
        iz = torch.where(run, niz, iz)
        running = go & ~out_top & ~out_bot
        exit_top = exit_top | out_top
        exit_bot = exit_bot | out_bot
        stopped = stopped | hits
        n += 1
    # lanes still running at the crossing cap: tau = -1 (a bad photon)
    tau = torch.where(running, -1.0, tau)
    return dict(tau=tau, x=x, y=y, z=z, ix=ix, iy=iy, exit_top=exit_top,
                exit_bot=exit_bot, stopped=stopped)
