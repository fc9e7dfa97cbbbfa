// Device helpers shared by the port's transport kernels (record_kernel.cu,
// col_kernel.cu): the counter-based uniforms, the periodic wrap, the
// clamped macro-block face distance, analytic Henyey-Greenstein sampling and
// the scattering rotation. Each follows the JAX kernels' float32 arithmetic
// operation for operation; the kernels are built with -fmad=false so no
// multiply-add is contracted away from the plain PyTorch steps.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace mcb {

constexpr float kTiny = 1e-30f;
constexpr float kBig = 3e38f;
constexpr uint32_t kNSites = 256u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// pallas_kernel._make_uniform, murmur mode: uniform in [0, 1) for
// (lane, step counter, draw site, seed).
__device__ __forceinline__ float uniform(uint32_t lane, uint32_t seed,
                                         uint32_t ctr, uint32_t site) {
  const uint32_t c = (ctr * kNSites + site) * 0x9E3779B9u;
  uint32_t x = fmix32(lane ^ c);
  x = fmix32(x ^ seed ^ (c * 0x85649F3Du));
  return static_cast<float>(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// jnp.mod / torch.remainder for float32: fmod (exact) then move the result
// to the divisor's sign.
__device__ __forceinline__ float wrap(float v, float l) {
  float m = fmodf(v, l);
  if (m != 0.f && ((m < 0.f) != (l < 0.f))) m += l;
  return m;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float signf(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// Distance from p to the macro-block face along u, the face clamped to the
// domain edge [0, len] so a partial last block never reaches past the
// periodic seam (pallas_kernel.py:1052-1066, pallas_col.py:527-536).
__device__ __forceinline__ float face_dist(float p, float p0, float u,
                                           float bw, float len) {
  float f = (floorf((p - p0) / bw) + (u >= 0.f ? 1.f : 0.f)) * bw;
  f = fminf(fmaxf(f, 0.f), len);
  const float t = (f + p0) - p;
  return fabsf(u) > 1e-12f ? t / u : kBig;
}

// Analytic Henyey-Greenstein scattering cosine (exact inverse CDF),
// isotropic for |g| < 1e-5.
__device__ __forceinline__ float hg_cos(float g, float u) {
  if (fabsf(g) < 1e-5f) return 2.f * u - 1.f;
  const float s = (1.f - g * g) / ((1.f - g) + (2.f * g) * u);
  const float ct = ((1.f + g * g) - s * s) / (2.f * g);
  return fminf(fmaxf(ct, -1.f), 1.f);
}

// Rotate (ux, uy, uz) by the scattering angle (cos_t) and azimuth phi, with
// the |uz| >= 1e-4 guard and the renormalization of the JAX kernels.
__device__ __forceinline__ void rotate(float& ux, float& uy, float& uz,
                                       float cos_t, float phi) {
  const float sin_t = sqrtf(fmaxf(0.f, 1.f - cos_t * cos_t));
  float sp, cp;
  sincosf(phi, &sp, &cp);
  const float denom = sqrtf(fmaxf(1.f - uz * uz, 0.f));
  float ox, oy, oz;
  if (denom > 1e-6f) {
    const float inv_denom = 1.f / fmaxf(denom, 1e-12f);
    ox = ux * cos_t + (sin_t * ((ux * uz) * cp - uy * sp)) * inv_denom;
    oy = uy * cos_t + (sin_t * ((uy * uz) * cp + ux * sp)) * inv_denom;
    oz = uz * cos_t - (sin_t * cp) * denom;
  } else {
    const float sgn = signf(uz == 0.f ? 1.f : uz);
    ox = sin_t * cp;
    oy = (sgn * sin_t) * sp;
    oz = sgn * cos_t;
  }
  if (fabsf(oz) < 1e-4f) oz = signf(oz == 0.f ? 1.f : oz) * 1e-4f;
  const float inv_norm = rsqrtf((ox * ox + oy * oy) + oz * oz);
  ux = ox * inv_norm;
  uy = oy * inv_norm;
  uz = oz * inv_norm;
}

// A slot of the local-estimate event queue for every thread that calls it:
// one atomicAdd on the fill counter per warp (its converged threads take
// consecutive slots). The fill counts every call, so a queue that is too
// small shows as a fill past its capacity.
__device__ __forceinline__ int queue_slot(int* fill) {
  const unsigned active = __activemask();
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int leader = __ffs(active) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(fill, __popc(active));
  base = __shfl_sync(active, base, leader);
  return base + __popc(active & ((1u << lane) - 1u));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  return v;
}

// Blocks of a persistent launch: as many as fit on every SM at once for
// `threads` threads and `smem` bytes of dynamic shared memory.
template <typename Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                                     int* blocks) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * n_sm;
  return cudaSuccess;
}

// Most dynamic shared memory a block may take (the card's opt-in limit).
constexpr size_t kMaxBlockSmem = 227 * 1024;

// Blocks of `kernel` resident on one SM for `threads` threads and `smem`
// bytes of dynamic shared memory (the kernel opted in past 48 KB first).
template <typename Kernel>
inline cudaError_t smem_blocks(Kernel kernel, int threads, size_t smem,
                               int* blocks) {
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// Where a launch keeps its two read-only tables (the block majorants, then
// the inverse-CDF row; bytes[i] == 0: the table is not read): after the
// `base` bytes of dynamic shared memory the block always takes, in shared
// memory or read from global memory with __ldg. With budget >= 0 each
// table goes to shared memory if the block stays within the budget bytes;
// with budget < 0 the longest run of them, in order, that costs no blocks
// an SM against reading both from global memory (occupancy queries, done
// once for the last kernel and sizes: every launch of a batch asks the
// same). Sets the block's bytes and in_smem[i]; opts in past 48 KB.
template <typename Kernel>
inline cudaError_t table_layout(Kernel kernel, int threads, size_t base,
                                const size_t bytes[2], long budget,
                                size_t* smem, int in_smem[2]) {
  static const void* last_kernel = nullptr;
  static size_t last[4] = {0, 0, 0, 0};
  static int last_n = 0;
  const size_t key[4] = {base, bytes[0], bytes[1],
                         static_cast<size_t>(threads)};
  *smem = base;
  if (budget >= 0) {
    for (int k = 0; k < 2; ++k) {
      in_smem[k] = bytes[k] > 0 &&
                   *smem + bytes[k] <= static_cast<size_t>(budget);
      if (in_smem[k]) *smem += bytes[k];
    }
  } else {
    if (last_kernel != reinterpret_cast<const void*>(kernel) ||
        memcmp(last, key, sizeof(key)) != 0) {
      int floor_blocks = 0, n = 0;
      cudaError_t e = smem_blocks(kernel, threads, base, &floor_blocks);
      size_t s = base;
      for (int k = 0; k < 2 && e == cudaSuccess; ++k) {
        int b = 0;
        if (s + bytes[k] > kMaxBlockSmem) break;
        e = smem_blocks(kernel, threads, s + bytes[k], &b);
        if (e != cudaSuccess || b < floor_blocks) break;
        s += bytes[k];
        n = k + 1;
      }
      if (e != cudaSuccess) return e;
      last_kernel = reinterpret_cast<const void*>(kernel);
      memcpy(last, key, sizeof(key));
      last_n = n;
    }
    for (int k = 0; k < 2; ++k) {
      in_smem[k] = k < last_n && bytes[k] > 0;
      if (in_smem[k]) *smem += bytes[k];
    }
  }
  if (*smem > 47 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

// Entries of an occupancy record (record_kernel.OCCUPANCY_KEYS).
enum { OCC_BLOCKS, OCC_THREADS, OCC_SMEM, OCC_REGS, OCC_LOCAL, OCC_SMS,
       N_OCC };

// The occupancy record of `kernel` launched with `threads` threads and
// `smem` bytes of dynamic shared memory (set past the 48 KB opt-in first)
// on the current card: blocks resident on one SM (the occupancy query),
// threads a block, the dynamic shared memory, registers a thread, local
// (spilled) bytes a thread and SMs.
template <typename Kernel>
inline cudaError_t occupancy_record(Kernel kernel, int threads, size_t smem,
                                    int* out) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) return e;
  out[OCC_BLOCKS] = per_sm;
  out[OCC_THREADS] = threads;
  out[OCC_SMEM] = static_cast<int>(smem);
  out[OCC_REGS] = fa.numRegs;
  out[OCC_LOCAL] = static_cast<int>(fa.localSizeBytes);
  out[OCC_SMS] = n_sm;
  return cudaSuccess;
}

}  // namespace mcb
