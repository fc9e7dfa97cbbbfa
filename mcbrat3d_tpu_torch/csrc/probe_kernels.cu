// Gather and tally probes for NVIDIA Hopper (sm_90a): micro-benchmarks of
// a data-dependent chain of per-lane table reads or tally bodies.
//
// Replaces the TPU probes P1-P5: tools/probe_gather.py `_run` (P1, one
// gather a call from a 1,024-entry table), tools/probe_gather2.py `main`
// (P2, INNER chained gathers from 1,024 entries), tools/probe_gather3.py
// `main` (P3, chained gathers from a 106,496-entry table, one or two of
// them), tools/probe_tally.py `run` (P4, chained one-hot, tally and
// column-march bodies) and native/pallas_gather_experiment.py `gather`
// (P5, 4 fields of 1,024 records at 65,536 indices). Each TPU variant was a
// different way to build a per-lane gather or a tally out of one-hot MXU
// contractions, bf16 hi/lo splits, row-group selects and same-shape
// dynamic gathers; on Hopper each of them is one indexed load per lane or
// one shared-memory atomic, so the variants reduce to a few functions
// (mcbrat3d_tpu_torch/tools/probes.py names which):
//
// gather_chain: lane l keeps an index i (its start idx0[l], masked with
//   init_mask) and an accumulator a; each of `inner` iterations reads v,
//   adds it to a and moves to i = (idx0[l] + int(v * 997)) & mask, so no
//   read can be hoisted (the TPU probes' _perturb). v is the sum over
//   n_fields tables of tab[f * n_tab + i] (G_FLAT), or tab[(i >> 7) * 128
//   + l % 128] (G_SUB, the sublane pick); G_RECORDS writes the n_fields
//   fields of record i to out[f * n + l] once (P5). The table is read from
//   global memory through the read-only cache, or first copied into shared
//   memory (use_smem; 1,024 or 4,096 floats; P3's 416 KB does not fit).
// tally_chain: T_ONEHOT (v = [i == 0] + [i == 1], the one-hot build
//   reduced to its two compares) and T_COLSCAN (the closed-form column
//   march body: per iteration c two lerped reads of row pair c % 32 of a
//   [64, 128] table, tau += max(v_in - v_out, 0)) are per lane, one thread
//   each; T_DOTONLY (the values i * 0.013 tallied at each lane's fixed start
//   column, read back at the lane's own column, twice) and T_FULL (tallied
//   at i in 1,024 bins, row 0 read back) need every lane's value before any
//   lane reads, so one block runs all lanes with a barrier per iteration.
//   Its bins sum in double precision (shared atomics) and round once: the
//   sum of at most 8,192 such float32 values is exact in a double, so the
//   result does not depend on the atomics' order and equals the plain
//   twin's bit for bit.
//
// What bounds it on this card: the latency of the dependent chain, one
// load (or one shared atomic and two barriers) per iteration; the bytes
// (indices, table, output) are a few KB to 416 KB, read once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTallyThreads = 1024;
constexpr int kMaxLanesPerThread = 8;  // T_DOTONLY / T_FULL: n <= 8,192
constexpr int kBins = 1024;
constexpr int kColscanNx = 32;         // tools/probe_tally.py NX
constexpr float kColscanZpMax = 32.f;  // NZP - 1

enum { G_FLAT, G_SUB, G_RECORDS };
enum { T_ONEHOT, T_DOTONLY, T_FULL, T_COLSCAN };

__device__ __forceinline__ int perturb(int idx0, float v, int mask) {
  return (idx0 + static_cast<int>(v * 997.f)) & mask;
}

__global__ void __launch_bounds__(kThreads)
gather_chain(const float* __restrict__ tab, int n_tab, int n_fields,
             const int* __restrict__ idx0s, float* __restrict__ out, int n,
             int inner, int init_mask, int mask, int mode, int use_smem) {
  extern __shared__ float s_tab[];
  const float* t = tab;
  if (use_smem) {
    for (int k = threadIdx.x; k < n_tab * n_fields; k += blockDim.x) {
      s_tab[k] = tab[k];
    }
    __syncthreads();
    t = s_tab;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int idx0 = idx0s[lane] & init_mask;
  if (mode == G_RECORDS) {
    for (int f = 0; f < n_fields; ++f) {
      out[f * n + lane] = use_smem ? t[idx0 * n_fields + f]
                                   : __ldg(t + idx0 * n_fields + f);
    }
    return;
  }
  const int col = lane & 127;
  int i = idx0;
  float acc = 0.f;
  for (int it = 0; it < inner; ++it) {
    float v;
    if (mode == G_SUB) {
      const int k = (i >> 7) * 128 + col;
      v = use_smem ? t[k] : __ldg(t + k);
    } else {
      v = use_smem ? t[i] : __ldg(t + i);
      for (int f = 1; f < n_fields; ++f) {
        v = v + (use_smem ? t[f * n_tab + i] : __ldg(t + f * n_tab + i));
      }
    }
    acc = acc + v;
    i = perturb(idx0, v, mask);
  }
  out[lane] = acc;
}

// One lane of T_COLSCAN's iteration c (tools/probe_tally.py make_colscan).
__device__ __forceinline__ float colscan_step(const float* __restrict__ tab,
                                              float sig0, int c) {
  const float* r0 = tab + 2 * (c & (kColscanNx - 1)) * 128;
  const float* r1 = r0 + 128;
  const float cf = static_cast<float>(c);
  const float q = ceilf((sig0 - cf) * (1.f / kColscanNx));
  const float j = cf + static_cast<float>(kColscanNx) * q;
  const float s_in = fmaxf(j, sig0);
  const float s_out = j + 1.f;
  const float z_in = fminf(fmaxf(3.f + (s_in - sig0) * 1.7f, 0.f), 30.f);
  const float z_out = fminf(fmaxf(3.f + (s_out - sig0) * 1.7f, 0.f), 30.f);
  const float u_i = fminf(fmaxf(z_in, 0.f), kColscanZpMax);
  const float u_o = fminf(fmaxf(z_out, 0.f), kColscanZpMax);
  const int k_i = static_cast<int>(u_i);
  const int k_o = static_cast<int>(u_o);
  const float f_i = u_i - static_cast<float>(k_i);
  const float f_o = u_o - static_cast<float>(k_o);
  const float v_i = __ldg(r0 + k_i) * (1.f - f_i) + __ldg(r1 + k_i) * f_i;
  const float v_o = __ldg(r0 + k_o) * (1.f - f_o) + __ldg(r1 + k_o) * f_o;
  return fmaxf(v_i - v_o, 0.f);
}

__global__ void __launch_bounds__(kThreads)
tally_lane(const float* __restrict__ tab, const int* __restrict__ idx0s,
           float* __restrict__ out, int n, int inner, int mask, int mode) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int idx0 = idx0s[lane] & mask;
  float acc = 0.f;
  if (mode == T_COLSCAN) {
    const float sig0 = static_cast<float>(idx0) * 0.25f;
    for (int c = 0; c < inner; ++c) acc = acc + colscan_step(tab, sig0, c);
  } else {  // T_ONEHOT
    int i = idx0;
    for (int it = 0; it < inner; ++it) {
      const float v = static_cast<float>(i == 0) + static_cast<float>(i == 1);
      acc = acc + v;
      i = perturb(idx0, v, mask);
    }
  }
  out[lane] = acc;
}

__global__ void __launch_bounds__(kTallyThreads)
tally_block(const int* __restrict__ idx0s, float* __restrict__ out, int n,
            int inner, int mask, int mode) {
  __shared__ double s_bins[kBins];
  int idx0[kMaxLanesPerThread], i[kMaxLanesPerThread];
  float acc[kMaxLanesPerThread];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  for (int p = 0; p < per; ++p) {
    const int lane = static_cast<int>(threadIdx.x + p * blockDim.x);
    idx0[p] = lane < n ? idx0s[lane] & mask : 0;
    i[p] = idx0[p];
    acc[p] = 0.f;
  }
  for (int it = 0; it < inner; ++it) {
    for (int k = threadIdx.x; k < kBins; k += blockDim.x) s_bins[k] = 0.0;
    __syncthreads();
    for (int p = 0; p < per; ++p) {
      if (static_cast<int>(threadIdx.x + p * blockDim.x) >= n) continue;
      const float val = static_cast<float>(i[p]) * 0.013f;
      atomicAdd(&s_bins[mode == T_DOTONLY ? idx0[p] : i[p]],
                static_cast<double>(val));
    }
    __syncthreads();
    for (int p = 0; p < per; ++p) {
      const int col = static_cast<int>(threadIdx.x + p * blockDim.x) & 127;
      float v = static_cast<float>(s_bins[col]);
      if (mode == T_DOTONLY) v = v + v;  // the probe's two equal products
      acc[p] = acc[p] + v;
      i[p] = perturb(idx0[p], v, mask);
    }
    __syncthreads();
  }
  for (int p = 0; p < per; ++p) {
    const int lane = static_cast<int>(threadIdx.x + p * blockDim.x);
    if (lane < n) out[lane] = acc[p];
  }
}

}  // namespace

// The gather chain of every lane (modes above); out holds n floats, or
// n_fields * n for G_RECORDS. Returns cudaGetLastError().
extern "C" int probe_gather_chain(const float* tab, int n_tab, int n_fields,
                                  const int* idx0, float* out, int n,
                                  int inner, int init_mask, int mask,
                                  int mode, int use_smem, void* stream) {
  if (mode < G_FLAT || mode > G_RECORDS || n_fields < 1 || n < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      use_smem ? static_cast<size_t>(n_tab) * n_fields * sizeof(float) : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gather_chain<<<(n + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      tab, n_tab, n_fields, idx0, out, n, inner, init_mask, mask, mode,
      use_smem);
  return static_cast<int>(cudaGetLastError());
}

// The tally chain of every lane (modes above); tab is T_COLSCAN's [64, 128]
// table. Returns cudaGetLastError().
extern "C" int probe_tally_chain(const float* tab, const int* idx0,
                                 float* out, int n, int inner, int mask,
                                 int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == T_ONEHOT || mode == T_COLSCAN) {
    tally_lane<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        tab, idx0, out, n, inner, mask, mode);
  } else if (mode == T_DOTONLY || mode == T_FULL) {
    if (n < 1 || n > kTallyThreads * kMaxLanesPerThread || mask >= kBins) {
      return cudaErrorInvalidValue;
    }
    const int threads = n < kTallyThreads ? n : kTallyThreads;
    tally_block<<<1, threads, 0, s>>>(idx0, out, n, inner, mask, mode);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
