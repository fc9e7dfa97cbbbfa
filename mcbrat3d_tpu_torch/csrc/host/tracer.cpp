// Scalar reference photon tracer (validation oracle).
//
// An independent, deliberately simple implementation of the same transport
// physics as the transport kernels: Woodcock (maximum cross-section) free
// paths, Henyey-Greenstein or isotropic scattering, continuous absorption,
// Lambertian surface, periodic x/y. Plays the role the reference's native
// integrator plays for intercomparison: a second full implementation whose
// statistics the wave kernel must match. Uses its own RNG (xoshiro256++)
// so agreement is purely statistical.
//
// A copy of the JAX package's native/tracer.cpp, built at first use by
// mcbrat3d_tpu_torch/_build.py (load_host):
//   g++ -O3 -march=native -fopenmp -shared -fPIC tracer.cpp

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion
    for (int i = 0; i < 4; ++i) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() {  // (0, 1]
    return ((next() >> 11) + 1) * 0x1.0p-53;
  }
};

}  // namespace

extern "C" {

// Trace n_photons through an [nx, ny, nz] extinction/ssa grid (C order,
// x-major as ext[(ix*ny+iy)*nz+iz]).
// Returns totals in out[0..2] = {sum_up, sum_down, sum_absorbed} and the
// per-column upward flux in flux_up[nx*ny] (may be null).
void trace_photons(int nx, int ny, int nz,
                   double dx, double dy, double dz,
                   const double* ext, const double* ssa,
                   double g, double mu0, double albedo,
                   long n_photons, uint64_t seed,
                   double* out, double* flux_up) {
  const double lx = nx * dx, ly = ny * dy, lz = nz * dz;
  double beta_max = 0.0;
  for (long i = 0; i < (long)nx * ny * nz; ++i)
    beta_max = ext[i] > beta_max ? ext[i] : beta_max;

  double sum_up = 0.0, sum_dn = 0.0, sum_ab = 0.0;

#pragma omp parallel reduction(+ : sum_up, sum_dn, sum_ab)
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0, nth = 1;
#endif
    Rng rng(seed * 1000003ULL + tid);
    double* local_up = nullptr;
    if (flux_up) {
      local_up = new double[(size_t)nx * ny]();
    }

    for (long p = tid; p < n_photons; p += nth) {
      double x = rng.uniform() * lx;
      double y = rng.uniform() * ly;
      double z = lz * (1.0 - 1e-9);
      double st = std::sqrt(1.0 - mu0 * mu0);
      double ux = st, uy = 0.0, uz = -std::fabs(mu0);
      double w = 1.0;

      for (int step = 0; step < 1000000; ++step) {
        const double d = -std::log(rng.uniform()) / beta_max;
        double zn = z + uz * d;
        if (zn >= lz) {  // exit top
          const double t = (lz - z) / uz;
          double xe = std::fmod(x + ux * t, lx); if (xe < 0) xe += lx;
          double ye = std::fmod(y + uy * t, ly); if (ye < 0) ye += ly;
          sum_up += w;
          if (local_up) {
            int ix = (int)(xe / dx); if (ix >= nx) ix = nx - 1;
            int iy = (int)(ye / dy); if (iy >= ny) iy = ny - 1;
            local_up[(size_t)ix * ny + iy] += w;
          }
          break;
        }
        if (zn <= 0.0) {  // surface
          const double t = (0.0 - z) / uz;
          x = std::fmod(x + ux * t, lx); if (x < 0) x += lx;
          y = std::fmod(y + uy * t, ly); if (y < 0) y += ly;
          z = 1e-9 * lz;
          sum_dn += w;
          w *= albedo;
          if (w < 1e-12) break;
          const double smu = std::sqrt(rng.uniform());
          const double sphi = 2.0 * M_PI * rng.uniform();
          const double sst = std::sqrt(1.0 - smu * smu);
          ux = sst * std::cos(sphi);
          uy = sst * std::sin(sphi);
          uz = smu;
          continue;
        }
        x = std::fmod(x + ux * d, lx); if (x < 0) x += lx;
        y = std::fmod(y + uy * d, ly); if (y < 0) y += ly;
        z = zn;
        int ix = (int)(x / dx); if (ix >= nx) ix = nx - 1;
        int iy = (int)(y / dy); if (iy >= ny) iy = ny - 1;
        int iz = (int)(z / dz); if (iz >= nz) iz = nz - 1;
        const size_t cell = ((size_t)ix * ny + iy) * nz + iz;
        if (rng.uniform() * beta_max >= ext[cell]) continue;  // null

        const double a = ssa[cell];
        sum_ab += w * (1.0 - a);
        w *= a;
        if (w < 1e-12) break;

        // HG / isotropic scattering cosine
        double c;
        if (std::fabs(g) < 1e-6) {
          c = 2.0 * rng.uniform() - 1.0;
        } else {
          const double s = (1.0 - g * g) / (1.0 - g + 2.0 * g * rng.uniform());
          c = (1.0 + g * g - s * s) / (2.0 * g);
        }
        const double sphi = 2.0 * M_PI * rng.uniform();
        const double sint = std::sqrt(std::fmax(0.0, 1.0 - c * c));
        const double den2 = 1.0 - uz * uz;
        if (den2 > 1e-12) {
          const double den = std::sqrt(den2);
          const double nux = ux * c + sint * (ux * uz * std::cos(sphi) - uy * std::sin(sphi)) / den;
          const double nuy = uy * c + sint * (uy * uz * std::cos(sphi) + ux * std::sin(sphi)) / den;
          const double nuz = uz * c - sint * std::cos(sphi) * den;
          const double inv = 1.0 / std::sqrt(nux * nux + nuy * nuy + nuz * nuz);
          ux = nux * inv; uy = nuy * inv; uz = nuz * inv;
        } else {
          const double sgn = uz >= 0 ? 1.0 : -1.0;
          ux = sint * std::cos(sphi);
          uy = sgn * sint * std::sin(sphi);
          uz = sgn * c;
        }
      }
    }

    if (local_up) {
#pragma omp critical
      for (size_t i = 0; i < (size_t)nx * ny; ++i) flux_up[i] += local_up[i];
      delete[] local_up;
    }
  }

  out[0] = sum_up;
  out[1] = sum_dn;
  out[2] = sum_ab;
}

}  // extern "C"
