// Native Mie scattering kernel.
//
// Role-equivalent of the reference's F77 Mie solver (reference:
// Tools/mieindsub.f: MIE_ONE/MIECALC/MIECROSS/MIEANGLE) -- the
// compute-heavy inner loop of the offline table-generation pipeline.
// Implemented from the standard Bohren & Huffman formulation with
// Wiscombe's series-length criterion and the logarithmic-derivative
// downward recurrence; computes efficiencies and the unpolarized
// scattering intensity at caller-provided angle cosines for a batch of
// size parameters (OpenMP across sizes).
//
// A copy of the JAX package's native/mie.cpp, built at first use by
// mcbrat3d_tpu_torch/_build.py (load_host):
//   g++ -O3 -march=native -fopenmp -shared -fPIC mie.cpp
//
// C ABI:
//   int mie_batch(int nsize, const double* x, double m_re, double m_im,
//                 int nquad, const double* mu,
//                 double* qext, double* qsca, double* intensity)
//     x:    [nsize] size parameters 2*pi*r/lambda (all > 0)
//     m:    complex refractive index, absorbing part m_im >= 0
//     mu:   [nquad] scattering-angle cosines
//     qext, qsca: [nsize] efficiencies
//     intensity:  [nsize * nquad] (|S1|^2 + |S2|^2)/2
//   returns 0 on success, k>0 = size index k-1 failed.

#include <cmath>
#include <complex>
#include <cstdlib>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using cplx = std::complex<double>;

namespace {

int series_terms(double x) {
  // Wiscombe's criterion
  double n;
  if (x <= 8.0)
    n = x + 4.0 * std::cbrt(x) + 1.0;
  else if (x < 4200.0)
    n = x + 4.05 * std::cbrt(x) + 2.0;
  else
    n = x + 4.0 * std::cbrt(x) + 2.0;
  return static_cast<int>(n) + 2;
}

int mie_one(double x, cplx m, int nquad, const double* mu, double* qext,
            double* qsca, double* intensity) {
  if (!(x > 0.0)) return 1;
  const int nmax = series_terms(x);
  const cplx mx = m * x;

  // Logarithmic derivative D_n(mx) by downward recurrence
  const int nstart = nmax + 15 + static_cast<int>(std::abs(mx) * 0.02);
  std::vector<cplx> d(nstart + 1);
  d[nstart] = cplx(0.0, 0.0);
  for (int n = nstart; n >= 1; --n) {
    const cplx an = cplx(n, 0.0) / mx;
    d[n - 1] = an - 1.0 / (d[n] + an);
  }

  // Riccati-Bessel psi (regular) and chi (irregular), upward
  std::vector<double> psi(nmax + 1), chi(nmax + 1);
  double psim1 = std::cos(x);  // psi_{-1}
  psi[0] = std::sin(x);
  double chim1 = -std::sin(x);  // chi_{-1}
  chi[0] = std::cos(x);
  for (int n = 1; n <= nmax; ++n) {
    const double f = (2.0 * n - 1.0) / x;
    psi[n] = f * psi[n - 1] - psim1;
    chi[n] = f * chi[n - 1] - chim1;
    psim1 = psi[n - 1];
    chim1 = chi[n - 1];
  }

  // Mie coefficients
  std::vector<cplx> a(nmax + 1), b(nmax + 1);
  double qe = 0.0, qs = 0.0;
  for (int n = 1; n <= nmax; ++n) {
    const cplx xi_n(psi[n], -chi[n]);
    const cplx xi_nm1(psi[n - 1], -chi[n - 1]);
    const double nx = n / x;
    const cplx da = d[n] / m + nx;
    const cplx db = d[n] * m + nx;
    a[n] = (da * psi[n] - psi[n - 1]) / (da * xi_n - xi_nm1);
    b[n] = (db * psi[n] - psi[n - 1]) / (db * xi_n - xi_nm1);
    const double w = 2.0 * n + 1.0;
    qe += w * (a[n].real() + b[n].real());
    qs += w * (std::norm(a[n]) + std::norm(b[n]));
  }
  const double inv_x2 = 1.0 / (x * x);
  *qext = 2.0 * inv_x2 * qe;
  *qsca = 2.0 * inv_x2 * qs;

  // Angular intensities via pi_n / tau_n recurrences
  for (int q = 0; q < nquad; ++q) {
    const double u = mu[q];
    double pi_nm1 = 0.0;  // pi_0
    double pi_n = 1.0;    // pi_1
    cplx s1(0.0, 0.0), s2(0.0, 0.0);
    for (int n = 1; n <= nmax; ++n) {
      const double tau_n = n * u * pi_n - (n + 1.0) * pi_nm1;
      const double f = (2.0 * n + 1.0) / (n * (n + 1.0));
      s1 += f * (a[n] * pi_n + b[n] * tau_n);
      s2 += f * (a[n] * tau_n + b[n] * pi_n);
      const double pi_np1 = ((2.0 * n + 1.0) * u * pi_n - (n + 1.0) * pi_nm1) / n;
      pi_nm1 = pi_n;
      pi_n = pi_np1;
    }
    intensity[q] = 0.5 * (std::norm(s1) + std::norm(s2));
  }
  return 0;
}

}  // namespace

extern "C" {

int mie_batch(int nsize, const double* x, double m_re, double m_im,
              int nquad, const double* mu, double* qext, double* qsca,
              double* intensity) {
  const cplx m(m_re, m_im);
  int failed = 0;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < nsize; ++i) {
    int rc = mie_one(x[i], m, nquad, mu, &qext[i], &qsca[i],
                     &intensity[static_cast<long>(i) * nquad]);
    if (rc != 0) {
#pragma omp critical
      failed = i + 1;
    }
  }
  return failed;
}

}  // extern "C"
