"""Spectral and emission weighting (PyTorch port).

Copy of ``mcbrat3d_tpu.spectral.weights`` (host-side float64 NumPy).
Re-implementation of the reference's
emissionAndBBWeights module (reference:
src/emissionAndBroadBandWeights.f95): the spectral power CDF
for solar (SW) and thermal (LW) sources, the per-voxel emission CDF, and
the multinomial photon distribution over wavelength bins. All setup-time
float64 NumPy with compensated sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mcbrat3d_tpu_torch.core.accumulate import kahan_cumsum
from mcbrat3d_tpu_torch.core.planck import planck_radiance


def lambda_widths(lambdas: np.ndarray) -> np.ndarray:
    """Per-bin spectral width: first/last use the adjacent gap, interior
    bins the half-point span (reference:
    src/emissionAndBroadBandWeights.f95:168-184)."""
    lam = np.asarray(lambdas, np.float64)
    if lam.size == 1:
        return np.ones(1)
    d = np.empty_like(lam)
    d[0] = abs(lam[1] - lam[0])
    d[-1] = abs(lam[-1] - lam[-2])
    if lam.size > 2:
        d[1:-1] = np.abs((lam[2:] - lam[:-2]) / 2.0)
    return d


def solar_weighting(lambdas, source_function, solar_mu, srf=None):
    """Spectral power CDF for a solar source.

    Kahan-summed integral of dLambda * |mu0| * S(lambda) (* SRF); returns
    (cdf [nLambda], total_flux) (reference:
    src/emissionAndBroadBandWeights.f95:149-217).
    """
    lam = np.asarray(lambdas, np.float64)
    s = np.asarray(source_function, np.float64)
    d = lambda_widths(lam)
    terms = d * abs(solar_mu) * s
    if srf is not None:
        terms = terms * np.asarray(srf, np.float64)
    cdf = kahan_cumsum(terms)
    total = float(cdf[-1])
    return cdf / total, total


@dataclasses.dataclass
class EmissionWeights:
    """Per-wavelength thermal emission weighting.

    ``voxel_cdf``: flattened (z-outer, y, x-inner) normalized cumulative
    power, ready for the emission photon source's single-deviate bisection.
    """

    voxel_cdf: np.ndarray  # [nz*ny*nx]
    frac_atms_power: float
    flux: float  # domain-mean monochromatic flux [W m^-2 um^-1]
    total_flux: float  # flux * dLambda [W m^-2] (0 if dLambda not given)


def emission_weighting(grid, temps, absorption_coeff, surface_temp,
                       surface_emissivity, lambda_um,
                       d_lambda=None) -> EmissionWeights:
    """Per-voxel Planck emission CDF + surface/atmosphere power split.

    contribution(cell) = 4 pi B_lambda(T) kappa_abs dz  [W m^-2 um^-1]
    surface power = pi e B_lambda(Tsfc) * area
    (reference: emission_weightingNEW,
    src/emissionAndBroadBandWeights.f95:424-550).

    ``absorption_coeff``: [nx, ny, nz] volume absorption coefficient
    [km^-1] = totalExt - sum_c ssa_c ext_c.
    """
    nx, ny, nz = grid.shape
    temps = np.asarray(temps, np.float64)
    kabs = np.asarray(absorption_coeff, np.float64)
    xe, ye, ze = grid.edges_np()
    dz = np.diff(ze)
    area_m2 = (xe[-1] - xe[0]) * (ye[-1] - ye[0]) * 1000.0**2

    # surface power [W]
    if surface_emissivity <= 0.0 or surface_temp <= 0.0:
        sfc_power = 0.0
    else:
        b_sfc = planck_radiance(lambda_um, surface_temp)
        sfc_power = np.pi * surface_emissivity * b_sfc * area_m2

    # per-voxel emitted power density, accumulated in the reference's
    # (z outer, y, x inner) scan order
    if np.all(temps > 0.0):
        b_atm = planck_radiance(lambda_um, temps)  # [nx,ny,nz]
        contrib = 4.0 * np.pi * b_atm * kabs * dz[None, None, :]
        flat = contrib.transpose(2, 1, 0).reshape(-1)  # (z,y,x) order
        run = kahan_cumsum(flat)
    else:
        run = np.zeros(nx * ny * nz)

    atms_total = float(run[-1]) if run.size else 0.0
    if atms_total > 0.0:
        atms_power = atms_total * area_m2 / (nx * ny)
        voxel_cdf = run / atms_total
        voxel_cdf[-1] = 1.0
    else:
        atms_power = 0.0
        voxel_cdf = np.ones(nx * ny * nz)

    total_power = atms_power + sfc_power
    frac_atms = atms_power / total_power if total_power > 0 else 0.0
    flux = total_power / area_m2
    total_flux = flux * float(d_lambda) if d_lambda is not None else 0.0
    return EmissionWeights(voxel_cdf=voxel_cdf, frac_atms_power=frac_atms,
                           flux=flux, total_flux=total_flux)


def absorption_coefficient(components, grid):
    """kappa_abs = totalExt - sum_c ssa_c ext_c over flattened components
    (reference: src/emissionAndBroadBandWeights.f95:504)."""
    nx, ny, nz = grid.shape
    kabs = np.zeros((nx, ny, nz), np.float64)
    for comp in components:
        e = comp.extinction
        a = comp.single_scattering_albedo
        if comp.is_horizontally_uniform:
            e = np.broadcast_to(e, (nx, ny, e.shape[2]))
            a = np.broadcast_to(a, (nx, ny, a.shape[2]))
        z0 = comp.z_level_base
        kabs[:, :, z0:z0 + e.shape[2]] += e * (1.0 - a)
    return kabs


def _lw_fluxes_from_plan(plan, ssp_tables, d_lambda, surface_temp,
                         ze) -> np.ndarray:
    """lw_setup_fluxes under a SeparableBinPlan: the per-cell kabs sum
    factorizes (sum_cells mass*k*(1-ssa) = amp_sum * mprof[z] * k*(1-ssa)),
    so the whole n_lambda Planck sweep is O(nz * n_lambda) instead of
    O(cells * n_lambda) -- at the 325x325x150 x 64-bin flagship that is
    ~1e9 f64 multiply-accumulates removed from setup."""
    from mcbrat3d_tpu_torch.core.planck import planck_radiance
    from mcbrat3d_tpu_torch.domain.ssp import lambda_um_from_freq

    lambdas = lambda_um_from_freq(ssp_tables[0].freq_hz)
    nl = lambdas.size
    nz = plan.mprof.size
    dz = np.diff(ze)
    sfc_albedo = np.asarray(ssp_tables[0].surface_albedo, np.float64)

    tz = plan.tz
    if tz is None or not np.all(tz > 0.0):
        atm = np.zeros(nl)
    else:
        ext_t = np.asarray(plan.cloud.extinction, np.float64)
        ssa_t = np.asarray(plan.cloud.ssa, np.float64)
        k = (1.0 - plan.f0) * ext_t[plan.il0] + plan.f0 * ext_t[plan.il0 + 1]
        s = (1.0 - plan.f0) * ssa_t[plan.il0] + plan.f0 * ssa_t[plan.il0 + 1]
        nxy = plan.amp.size
        q = np.zeros((nz, nl))
        if plan.gas is not None:
            zgb = plan.gas.z_level_base
            q[zgb:zgb + plan.gas.xsec.shape[0], :] = (
                np.asarray(plan.gas.xsec, np.float64)
                * plan.num_prof[:, None] * 1000.0)
        b = planck_radiance(lambdas[None, :], tz[:, None])  # [nz, nl]
        kabs_sum = (plan.amp_sum * plan.mprof[:, None]
                    * (k * (1.0 - s))[None, :] + nxy * q)
        atm = 4.0 * np.pi * np.einsum("z,zl,zl->l", dz, b, kabs_sum) / nxy

    emissivity = 1.0 - sfc_albedo
    if surface_temp > 0.0:
        sfc = np.pi * emissivity * planck_radiance(lambdas, surface_temp)
    else:
        sfc = np.zeros(nl)
    return (atm + sfc) * np.asarray(d_lambda, np.float64)


def lw_setup_fluxes(common, ssp_tables, d_lambda, surface_temp,
                    lambda_chunk: int = 16, plan=None) -> np.ndarray:
    """Vectorized LW setup pass: per-wavelength total emitted flux [W m^-2].

    Equivalent to looping components_from_ssp(setup=True) +
    absorption_coefficient + emission_weighting over every bin (the
    reference parallelizes exactly this across MPI ranks; reference:
    Drivers/monteCarloDriver.f95:304-450), but computes the
    lambda-independent Reff interpolation factors once and sweeps
    wavelengths in vectorized chunks -- O(n_lambda) python work becomes
    O(n_lambda / chunk).

    Only the per-bin scalar flux is needed for the spectral CDF; voxel CDFs
    are still built per *active* bin by the transport loop.
    """
    from mcbrat3d_tpu_torch.domain.ssp import lambda_um_from_freq

    grid = common.grid
    nx, ny, nz = grid.shape
    nxy = nx * ny
    ze = grid.edges_np()[2]
    if plan is not None and plan.tz is not None:
        return _lw_fluxes_from_plan(plan, ssp_tables, d_lambda,
                                    surface_temp, ze)
    temps = np.asarray(common.temps, np.float64)
    dz = np.diff(ze)

    lambdas = lambda_um_from_freq(ssp_tables[0].freq_hz)
    n_lambda = lambdas.size
    sfc_albedo = np.asarray(ssp_tables[0].surface_albedo, np.float64)
    d_lambda = np.asarray(d_lambda, np.float64)

    if not np.all(temps > 0.0):
        atm_on = False
    else:
        atm_on = True
        b_cache_t = temps.transpose(2, 0, 1).reshape(nz, nxy)  # [nz, nxy]

    # --- lambda-independent per-cell factors per particle component ---
    particle_terms = []  # (zb, nzc, mass*[1-f], mass*f, il) + ea table
    gas_terms = []       # (zb, xsec [nzc, nL], num [nx,ny,nzc])
    particle_idx = 0
    for tbl in ssp_tables:
        for c in tbl.components:
            if c.ext_type == "absXsec":
                if common.num_conc is None:
                    raise ValueError(
                        "gas component needs pressures in the common domain")
                nzc = c.xsec.shape[0]
                zb = c.z_level_base
                num = np.asarray(
                    common.num_conc[:, :, zb:zb + nzc], np.float64)
                gas_terms.append((zb, np.asarray(c.xsec, np.float64), num))
                continue
            if common.mass_conc is None:
                raise ValueError(
                    "particle component needs massConc/Reff in common domain")
            mass = np.asarray(common.mass_conc[particle_idx], np.float64)
            reff = np.asarray(common.reff[particle_idx], np.float64)
            particle_idx += 1
            key = c.key
            active = mass > 0.0
            bad = active & ((reff < key.min()) | (reff >= key.max()))
            if np.any(bad):
                raise ValueError(
                    f"component '{c.name}': effective radius outside table "
                    f"range at {int(bad.sum())} cells")
            il = np.clip(np.searchsorted(key, reff) - 1, 0, key.size - 2)
            f = (reff - key[il]) / (key[il + 1] - key[il])
            mass = np.where(active, mass, 0.0)
            f = np.where(active, f, 0.0)
            particle_terms.append(
                (c.z_level_base, mass, f, il,
                 np.asarray(c.extinction, np.float64),
                 np.asarray(c.ssa, np.float64)))

    fluxes = np.zeros(n_lambda)
    for l0 in range(0, n_lambda, lambda_chunk):
        l1 = min(l0 + lambda_chunk, n_lambda)
        ll = slice(l0, l1)
        nl = l1 - l0
        if atm_on:
            # atm flux per lambda: sum_cells 4 pi B kabs dz / (nx ny),
            # accumulated z-level by z-level to bound memory
            atm = np.zeros(nl)
            for k in range(nz):
                kabs = np.zeros((nx, ny, nl))
                for zb, mass, f, il, ext_t, ssa_t in particle_terms:
                    kz = k - zb
                    if not 0 <= kz < mass.shape[2]:
                        continue
                    ilk = il[:, :, kz]
                    fk = f[:, :, kz, None]
                    # interpolate ext and ssa separately, THEN combine --
                    # matching read_SSPTable's per-field interpolation
                    # (reference: src/opticalProperties.f95:236-265)
                    e = mass[:, :, kz, None] * (
                        (1.0 - fk) * ext_t[ilk][:, :, ll]
                        + fk * ext_t[ilk + 1][:, :, ll])
                    s = ((1.0 - fk) * ssa_t[ilk][:, :, ll]
                         + fk * ssa_t[ilk + 1][:, :, ll])
                    kabs += e * (1.0 - s)
                for zb, xsec, num in gas_terms:
                    kz = k - zb
                    if not 0 <= kz < xsec.shape[0]:
                        continue
                    # absorbing gas: ssa = 0, so kabs == extinction
                    kabs += xsec[kz, ll][None, None, :] * \
                        num[:, :, kz, None] * 1000.0
                b_k = planck_radiance(lambdas[ll][None, :],
                                      b_cache_t[k][:, None])  # [nxy, nl]
                atm += 4.0 * np.pi * dz[k] * np.einsum(
                    "cl,cl->l", b_k, kabs.reshape(nxy, nl))
            atm /= nxy
        else:
            atm = np.zeros(nl)
        emissivity = 1.0 - sfc_albedo[ll]
        if surface_temp > 0.0:
            sfc = np.pi * emissivity * planck_radiance(lambdas[ll],
                                                       surface_temp)
        else:
            sfc = np.zeros(nl)
        fluxes[ll] = (atm + sfc) * d_lambda[ll]
    return fluxes


def frequency_distribution(cdf, total_photons, seed):
    """Photon counts per wavelength bin: multinomial draw against the
    spectral CDF (reference: getFrequencyDistr,
    src/emissionAndBroadBandWeights.f95:552-596). Deterministic in seed."""
    cdf = np.asarray(cdf, np.float64)
    probs = np.diff(np.concatenate(([0.0], cdf)))
    probs = np.maximum(probs, 0.0)
    probs = probs / probs.sum()
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.multinomial(int(total_photons), probs).astype(np.int64)
