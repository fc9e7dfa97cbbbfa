// Native Walker/Vose alias-table builder.
//
// The record and column kernels sample thermal-emission voxels through a
// Walker alias table (see mcbrat3d_tpu_torch/sources/illumination.py,
// which keeps the same construction in Python as its plain version;
// a copy of the JAX package's native/alias.cpp); production LW
// domains rebuild this table per wavelength bin over up to ~16M voxels
// (reference flagship: 325 x 325 x 150, run/I3RC_bench_LW.deck:45), which
// is setup-path hot. Vose's construction is inherently sequential, so it
// lives here as native code.
//
// Built at first use by mcbrat3d_tpu_torch/_build.py (load_host):
//   g++ -O3 -march=native -shared -fPIC alias.cpp
//
// C ABI:
//   int walker_alias(long long n, const double* p,
//                    double* prob, long long* alias)
//     p:     [n] probabilities (need not be normalized; must be >= 0)
//     prob:  [n] out acceptance probabilities
//     alias: [n] out alias indices
//   returns 0 on success, 1 on invalid input (n <= 0 or sum(p) <= 0).

#include <cstdint>
#include <vector>

extern "C" int walker_alias(long long n, const double* p,
                            double* prob, long long* alias) {
    if (n <= 0) return 1;
    double total = 0.0;
    for (long long i = 0; i < n; ++i) total += p[i];
    if (!(total > 0.0)) return 1;
    const double scale = static_cast<double>(n) / total;

    std::vector<double> scaled(n);
    std::vector<long long> small, large;
    small.reserve(n);
    large.reserve(n);
    for (long long i = 0; i < n; ++i) {
        scaled[i] = p[i] * scale;
        alias[i] = i;
        if (scaled[i] < 1.0) small.push_back(i);
        else large.push_back(i);
    }
    while (!small.empty() && !large.empty()) {
        const long long s = small.back(); small.pop_back();
        const long long l = large.back(); large.pop_back();
        prob[s] = scaled[s];
        alias[s] = l;
        scaled[l] = (scaled[l] + scaled[s]) - 1.0;
        if (scaled[l] < 1.0) small.push_back(l);
        else large.push_back(l);
    }
    // numerical leftovers on either stack accept with probability 1
    for (long long i : large) prob[i] = 1.0;
    for (long long i : small) prob[i] = 1.0;
    return 0;
}
