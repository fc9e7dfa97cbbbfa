"""Simulation configuration + Fortran-namelist compatibility.

The reference is driven by five namelist groups read from one file given on
the command line (reference: Drivers/monteCarloDriver.f95:103-121,
userInterface_Unix.f95:68-78). We keep the same group/key names so existing
MCBRaT3D namelists drive this framework unchanged, and expose the same knobs
as a dataclass for programmatic use.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List

import numpy as np


@dataclasses.dataclass
class SimulationConfig:
    # --- namelist /radiativeTransfer/ ---
    solar_mu: float = 0.5
    solar_azimuth: float = 0.0  # degrees
    solar_flux: float = 1.0  # mono runs only (reference: OLDmonteCarloDriver)
    surface_temp: float = 300.0  # K
    intensity_mus: List[float] = dataclasses.field(default_factory=list)
    intensity_phis: List[float] = dataclasses.field(default_factory=list)
    angle_fill: bool = False
    theta_fill: List[float] = dataclasses.field(default_factory=lambda: [-1.0] * 3)
    phi_fill: List[float] = dataclasses.field(default_factory=lambda: [-1.0] * 3)
    lw_flag: float = -1.0  # >= 0 -> longwave/thermal run
    num_lambda: int = 1
    calc_rayleigh: bool = True

    # --- namelist /monteCarlo/ ---
    num_photons_per_batch: int = 1 << 20
    num_batches: int = 100
    iseed: int = 10
    n_phase_intervals: int = 10001

    # --- namelist /algorithms/ ---
    use_ray_tracing: bool = False  # TPU default: maximum cross-section
    use_russian_roulette: bool = True
    use_hybrid_phase_funs: bool = False
    hybrid_phase_fun_width: float = 7.0
    num_orders_orig_phase: int = 0
    use_russian_roulette_intensity: bool = True
    zeta_min: float = 0.3
    limit_intensity_contributions: bool = False
    max_intensity_contribution: float = 77.0
    # framework extension (no reference equivalent): megakernel dispatch
    # policy -- "auto" (fast path on TPU when eligible), "on" (require a
    # megakernel; raise naming the failing predicates), "off" (XLA kernel)
    use_pallas: str = "auto"
    # framework extension: two-level Woodcock macro-cell factor (fine
    # cells per majorant block along x/y; 0 = single global majorant).
    # Perf only -- transport is exact under any majorant.
    macro_factor: int = 8

    # --- namelist /output/ ---
    report_volume_absorption: bool = False
    report_absorption_profile: bool = False
    rec_scat_ord: bool = False
    num_rec_scat_ord: int = 0
    auxhist01_flux_file: str = ""
    auxhist01_rad_file: str = ""

    # --- namelist /fileNames/ ---
    solar_source_file: str = ""
    instr_response_file: str = ""
    ssp_file_names: List[str] = dataclasses.field(default_factory=list)
    phys_domain_file: str = ""
    domain_file: str = ""
    output_flux_file: str = ""
    output_rad_file: str = ""
    output_abs_prof_file: str = ""
    output_abs_volume_file: str = ""
    output_netcdf_file: str = ""

    # --- TPU execution knobs (no reference counterpart) ---
    n_lanes: int = 1 << 17
    max_steps: int = 100_000
    checkpoint_file: str = ""
    checkpoint_every_batches: int = 0

    @property
    def is_longwave(self) -> bool:
        return self.lw_flag >= 0.0

    def radiance_directions(self):
        """Resolve the (mu, phi) detector grid, applying angleFill expansion
        (reference: Drivers/monteCarloDriver.f95:242-279)."""
        mus = list(self.intensity_mus)
        phis = list(self.intensity_phis)
        if self.angle_fill:
            t0, t1, dt = self.theta_fill
            p0, p1, dp = self.phi_fill
            if dt >= 0 and dp >= 0 and t1 >= t0 and p1 >= p0:
                n_mu = int((t1 - t0) / dt) + 1
                n_phi = int((p1 - p0) / dp) + 1
                thetas = t0 + dt * np.arange(n_mu)
                ps = p0 + dp * np.arange(n_phi)
                mus = np.repeat(np.cos(np.deg2rad(thetas)), n_phi).tolist()
                phis = np.tile(ps, n_mu).tolist()
        pairs = [(m, p) for m, p in zip(mus, phis) if abs(m) > 0]
        if not pairs:
            return np.zeros(0), np.zeros(0)
        m, p = zip(*pairs)
        return np.asarray(m, np.float64), np.asarray(p, np.float64)

    @property
    def compute_intensity(self) -> bool:
        mus, _ = self.radiance_directions()
        return mus.size > 0


# ---------------------------------------------------------------------------
# Fortran namelist parsing (reference-compatible subset)
# ---------------------------------------------------------------------------

_KEY_MAP = {
    # radiativeTransfer
    "solarmu": "solar_mu",
    "solarazimuth": "solar_azimuth",
    "solarflux": "solar_flux",
    "surfacetemp": "surface_temp",
    "intensitymus": "intensity_mus",
    "intensityphis": "intensity_phis",
    "anglefill": "angle_fill",
    "thetafill": "theta_fill",
    "phifill": "phi_fill",
    "lw_flag": "lw_flag",
    "numlambda": "num_lambda",
    "calcrayl": "calc_rayleigh",
    # monteCarlo
    "numphotonsperbatch": "num_photons_per_batch",
    "numbatches": "num_batches",
    "iseed": "iseed",
    "nphaseintervals": "n_phase_intervals",
    # algorithms
    "useraytracing": "use_ray_tracing",
    "userussianroulette": "use_russian_roulette",
    "usehybridphasefunsforintencalcs": "use_hybrid_phase_funs",
    "hybridphasefunwidth": "hybrid_phase_fun_width",
    "numordersorigphasefunintencalcs": "num_orders_orig_phase",
    "userussianrouletteforintensity": "use_russian_roulette_intensity",
    "zetamin": "zeta_min",
    "limitintensitycontributions": "limit_intensity_contributions",
    "usepallas": "use_pallas",
    "macrofactor": "macro_factor",
    "maxintensitycontribution": "max_intensity_contribution",
    # output
    "reportvolumeabsorption": "report_volume_absorption",
    "reportabsorptionprofile": "report_absorption_profile",
    "recscatord": "rec_scat_ord",
    "numrecscatord": "num_rec_scat_ord",
    "auxhist01_fluxfile": "auxhist01_flux_file",
    "auxhist01_radfile": "auxhist01_rad_file",
    # fileNames
    "solarsourcefile": "solar_source_file",
    "instrresponsefile": "instr_response_file",
    "sspfilename": "ssp_file_names",
    "physdomainfile": "phys_domain_file",
    "domainfilename": "domain_file",
    "outputfluxfile": "output_flux_file",
    "outputradfile": "output_rad_file",
    "outputabsproffile": "output_abs_prof_file",
    "outputabsvolumefile": "output_abs_volume_file",
    "outputnetcdffile": "output_netcdf_file",
    # TPU extensions
    "nlanes": "n_lanes",
    "maxsteps": "max_steps",
    "checkpointfile": "checkpoint_file",
    "checkpointeverybatches": "checkpoint_every_batches",
}


def _parse_value(text: str):
    text = text.strip()
    if not text:
        return None
    low = text.lower()
    if low in (".true.", "t", ".t.", "true"):
        return True
    if low in (".false.", "f", ".f.", "false"):
        return False
    if (text.startswith("'") and text.endswith("'")) or (
            text.startswith('"') and text.endswith('"')):
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text.replace("d", "e").replace("D", "E"))
    except ValueError:
        return text


def _split_values(rhs: str):
    """Split a namelist RHS into items, honoring quotes and n*value repeats."""
    items = []
    for tok in re.findall(r"""'[^']*'|"[^"]*"|[^,\s]+""", rhs):
        m = re.fullmatch(r"(\d+)\*(.+)", tok)
        if m:
            items.extend([_parse_value(m.group(2))] * int(m.group(1)))
        else:
            items.append(_parse_value(tok))
    return items


def parse_namelist(text: str) -> dict:
    """Parse Fortran namelist text into {group: {key: value-or-list}}.

    Supports the subset the reference uses: &group ... /, scalar and
    array assignments (comma/space separated, repeat counts, indexed
    ``name(i)`` assignments), ``!`` comments.
    """
    groups = {}
    # strip comments
    lines = []
    for raw in text.splitlines():
        line = re.sub(r"!.*", "", raw).rstrip()
        if line.strip():
            lines.append(line.strip())
    body = " ".join(lines)

    # Quote-aware group scanner: a '/' inside quotes (file paths!) must not
    # terminate the group.
    def _find_group_end(s: str, start: int) -> int:
        i = start
        quote = None
        while i < len(s):
            c = s[i]
            if quote:
                if c == quote:
                    quote = None
            elif c in "'\"":
                quote = c
            elif c == "/":
                return i
            i += 1
        return len(s)

    spans = []
    for gm in re.finditer(r"&(\w+)", body):
        end = _find_group_end(body, gm.end())
        spans.append((gm.group(1).lower(), body[gm.end():end]))

    for gname, content in spans:
        entries = {}
        # split into key = values... chunks
        parts = re.split(r"(\w+(?:\(\d+\))?)\s*=", content)
        for i in range(1, len(parts) - 1, 2):
            key = parts[i].strip()
            rhs = parts[i + 1].strip().rstrip(",")
            idx = None
            im = re.fullmatch(r"(\w+)\((\d+)\)", key)
            if im:
                key, idx = im.group(1), int(im.group(2))
            vals = _split_values(rhs)
            key = key.lower()
            if idx is not None:
                arr = entries.setdefault(key, {})
                if isinstance(arr, dict):
                    arr[idx] = vals[0] if len(vals) == 1 else vals
            else:
                entries[key] = vals[0] if len(vals) == 1 else vals
        groups[gname] = entries
    return groups


def config_from_namelist(text: str) -> SimulationConfig:
    """Build a SimulationConfig from reference-style namelist text."""
    groups = parse_namelist(text)
    cfg = SimulationConfig()
    for group in groups.values():
        for key, val in group.items():
            field = _KEY_MAP.get(key)
            if field is None:
                continue
            if isinstance(val, dict):  # indexed assignments -> ordered list
                val = [val[k] for k in sorted(val)]
            current = getattr(cfg, field)
            if isinstance(current, list) and not isinstance(val, list):
                val = [val]
            if field in ("intensity_mus", "intensity_phis") and isinstance(val, list):
                val = [v for v in val]
            setattr(cfg, field, val)
    return cfg


def load_config(path: str) -> SimulationConfig:
    with open(path) as f:
        return config_from_namelist(f.read())
