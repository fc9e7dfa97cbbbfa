// Record-kernel flux path for NVIDIA Hopper (sm_90a).
//
// Replaces: mcbrat3d_tpu/transport/pallas_kernel.py `_build_kernel`, flux
// path (refill, Woodcock jump against the optional two-level macro
// majorant, record fetch, null-collision test, Russian roulette, HG or
// inverse-CDF scatter + rotation, uniform Lambertian reflection, fused
// flux / absorption tally), as launched by `_make_launch`.
//
// Design. One thread per photon lane; lane = blockIdx.x * 128 + threadIdx.x,
// the TPU kernel's row * 128 + lane, so the counter-based uniforms (the
// murmur3 mixer keyed by (lane, step * 256 + site, seed)) are the same
// numbers the JAX kernel and the plain PyTorch step draw. A thread loads
// its SoA state into registers, runs `k_steps` transport steps and writes
// the state back. The record table ([n_cells, stride] f32) and the
// inverse-CDF angle table are read with per-thread loads through L1/L2
// (the step cloud's 1,024 x 6 floats stay cached). Tallies accumulate in
// shared memory with shared atomics and are flushed once per block per
// launch with global atomics. The TPU workarounds (one-hot MXU gathers and
// tallies, bf16 hi/lo splits, [*, 128] lane blocks) are not carried over.
//
// What bounds it on this card: the latency of the dependent per-step math
// (divisions, log1p, sqrt, sincos) and of the record gathers, with at most
// 65,536 lanes in flight (a quarter of the H100's thread slots), plus
// shared-atomic contention on hot tally entries. It does no matrix work
// and streams no large tiles, so wgmma and TMA do not apply.
//
// Arithmetic follows the JAX kernel operation by operation in float32.
// The periodic wrap uses fmodf plus a divisor-sign correction, which is
// exactly jnp.mod / torch.remainder (sign of the divisor). The library is
// built with -fmad=false so no multiply-add is contracted, matching the
// plain PyTorch step on the same card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;
constexpr float kBig = 3e38f;
constexpr uint32_t kNSites = 256u;

// params[] slots (mcbrat3d_tpu_torch/transport/record_kernel.py PARAM_*).
enum {
  P_BETA_MAX, P_INV_BETA_MAX, P_ALBEDO, P_SMU, P_SUX, P_SUY, P_RR_W,
  P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ, P_INV_DX, P_INV_DY, P_INV_DZ,
  P_ZMAX, P_ZEPS, P_BXW, P_BYW, P_BZW, P_NUDGE, P_TWO_PI, P_HALF_RR,
  P_ZTOP, P_ZBOT, N_PARAMS
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// pallas_kernel._make_uniform, murmur mode: uniform in [0, 1).
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

// Distance from p to the macro-block face along u, the face clamped to
// the domain edge [0, len] (pallas_kernel.py:1052-1066).
__device__ __forceinline__ float face_dist(float p, float p0, float u,
                                           float bw, float len) {
  float f = (floorf((p - p0) / bw) + (u >= 0.f ? 1.f : 0.f)) * bw;
  f = fminf(fmaxf(f, 0.f), len);
  const float t = (f + p0) - p;
  return fabsf(u) > 1e-12f ? t / u : kBig;
}

template <bool MACRO, bool VOL, bool ANALYTIC>
__global__ void __launch_bounds__(kThreads)
record_steps(const float* __restrict__ prm,
             const float* __restrict__ rec,
             const float* __restrict__ inv_a0,
             const float* __restrict__ inv_dd,
             float* __restrict__ xs, float* __restrict__ ys,
             float* __restrict__ zs, float* __restrict__ uxs,
             float* __restrict__ uys, float* __restrict__ uzs,
             float* __restrict__ ws, float* __restrict__ bls,
             int* __restrict__ quotas, int* __restrict__ alives,
             float* __restrict__ acc, int* __restrict__ counts,
             int n_lanes, int nx, int ny, int nz, int stride, int off_ssa,
             int off_f2, int inv_n_steps, int use_rr, int n_acc,
             uint32_t seed, uint32_t step0, int k_steps) {
  extern __shared__ float s_acc[];
  __shared__ int s_counts[2];
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) s_acc[i] = 0.f;
  if (threadIdx.x < 2) s_counts[threadIdx.x] = 0;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n_lanes) {
    const float beta_max = prm[P_BETA_MAX], inv_beta_max = prm[P_INV_BETA_MAX];
    const float albedo = prm[P_ALBEDO], smu = prm[P_SMU];
    const float sux = prm[P_SUX], suy = prm[P_SUY], rr_w = prm[P_RR_W];
    const float x0 = prm[P_X0], lx = prm[P_LX], y0 = prm[P_Y0];
    const float ly = prm[P_LY], z0 = prm[P_Z0], lz = prm[P_LZ];
    const float inv_dx = prm[P_INV_DX], inv_dy = prm[P_INV_DY];
    const float inv_dz = prm[P_INV_DZ], z_max = prm[P_ZMAX];
    const float bx_w = prm[P_BXW], by_w = prm[P_BYW], bz_w = prm[P_BZW];
    const float nudge = prm[P_NUDGE], two_pi = prm[P_TWO_PI];
    const float half_rr = prm[P_HALF_RR], z_top = prm[P_ZTOP];
    const float z_bot = prm[P_ZBOT];
    const int nxy = nx * ny;

    float x = xs[lane], y = ys[lane], z = zs[lane];
    float ux = uxs[lane], uy = uys[lane], uz = uzs[lane];
    float w = ws[lane], bl = bls[lane];
    int quota = quotas[lane];
    bool alive = alives[lane] > 0;
    int started = 0;
    const uint32_t ul = static_cast<uint32_t>(lane);

    for (int k = 0; k < k_steps; ++k) {
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      // ---- refill a dead lane from the directional source ----
      if (!alive && quota > 0) {
        x = x0 + uniform(ul, seed, ctr, 0) * lx;
        y = y0 + uniform(ul, seed, ctr, 1) * ly;
        z = z_top;
        ux = sux;
        uy = suy;
        uz = -smu;
        w = 1.f;
        alive = true;
        quota -= 1;
        started += 1;
        if (MACRO) bl = beta_max;
      }
      if (!alive) continue;

      // ---- Woodcock jump ----
      const float tau = -log1pf(-uniform(ul, seed, ctr, 3));
      float d;
      bool clipped = false;
      if (MACRO) {
        const float t_raw = fminf(face_dist(x, x0, ux, bx_w, lx),
                                  fminf(face_dist(y, y0, uy, by_w, ly),
                                        face_dist(z, z0, uz, bz_w, lz)));
        const bool escape = t_raw <= 0.f;
        if (escape) bl = beta_max;
        const float d_samp = bl > 0.f ? tau / bl : kBig;
        const float t_clip = escape ? kBig : t_raw + nudge;
        clipped = t_clip < d_samp;
        d = fminf(d_samp, t_clip);
      } else {
        d = tau * inv_beta_max;
      }
      const float zn = z + uz * d;
      const bool exit_top = zn >= z_max;
      const bool exit_bot = !exit_top && zn <= z0;
      const bool moved = !exit_top && !exit_bot;
      const bool collide = moved && !clipped;
      const float phi_rot = two_pi * uniform(ul, seed, ctr, 6);

      if (!moved) {
        // ---- boundary exit: tally, then reflect off the surface ----
        const float z_b = exit_top ? z_max : z0;
        const float safe_uz = fabsf(uz) < 1e-12f ? 1.f : uz;
        const float t_b = (z_b - z) / safe_uz;
        const float xe = x0 + wrap((x + ux * t_b) - x0, lx);
        const float ye = y0 + wrap((y + uy * t_b) - y0, ly);
        const int ixe = clampi(static_cast<int>((xe - x0) * inv_dx), nx - 1);
        const int iye = clampi(static_cast<int>((ye - y0) * inv_dy), ny - 1);
        const int col_e = ixe * ny + iye;
        atomicAdd(&s_acc[exit_top ? col_e : nxy + col_e], w);
        if (exit_top) {
          alive = false;
        } else {
          const float w_refl = w * albedo;
          x = xe;
          y = ye;
          z = z_bot;
          if (MACRO) bl = beta_max;
          if (w_refl <= kTiny) {
            alive = false;
          } else {
            const float mu_new =
                sqrtf(fmaxf(uniform(ul, seed, ctr, 5), 1e-12f));
            const float sin_new = sqrtf(fmaxf(0.f, 1.f - mu_new * mu_new));
            float sp, cp;
            sincosf(phi_rot, &sp, &cp);
            ux = sin_new * cp;
            uy = sin_new * sp;
            uz = mu_new;
            w = w_refl;
          }
        }
        continue;
      }

      // ---- move to the collision (or macro-face) point ----
      const float xc = x0 + wrap((x + ux * d) - x0, lx);
      const float yc = y0 + wrap((y + uy * d) - y0, ly);
      const float zc = fminf(fmaxf(zn, z0), z_max);
      const int ix = clampi(static_cast<int>((xc - x0) * inv_dx), nx - 1);
      const int iy = clampi(static_cast<int>((yc - y0) * inv_dy), ny - 1);
      const int iz = clampi(static_cast<int>((zc - z0) * inv_dz), nz - 1);
      const int col_c = ix * ny + iy;
      const int cell = col_c * nz + iz;
      x = xc;
      y = yc;
      z = zc;
      if (!MACRO && !collide) continue;

      // ---- record fetch; null-collision test against the majorant the
      // jump sampled with, then carry the destination block's majorant ----
      const float* r = rec + static_cast<size_t>(cell) * stride;
      const float beta = __ldg(r);
      const float ceiling = MACRO ? bl : beta_max;
      if (MACRO) bl = __ldg(r + 1);
      if (!collide || !(uniform(ul, seed, ctr, 4) * ceiling < beta)) continue;

      // ---- real collision: absorption weight, tally, roulette ----
      const float ssa = __ldg(r + off_ssa);
      const float f2 = __ldg(r + off_f2);
      atomicAdd(&s_acc[2 * nxy + (VOL ? cell : col_c)], w * (1.f - ssa));
      w = w * ssa;
      if (use_rr && w < half_rr) {
        w = uniform(ul, seed, ctr, 7) < w / rr_w ? rr_w : 0.f;
      }
      if (w <= kTiny) {
        alive = false;
        continue;
      }

      // ---- scatter: sample cos(theta), rotate the direction ----
      const float u_ang = uniform(ul, seed, ctr, 5);
      float cos_t;
      if (ANALYTIC) {
        const float g = f2;
        if (fabsf(g) < 1e-5f) {
          cos_t = 2.f * u_ang - 1.f;
        } else {
          const float s = (1.f - g * g) / ((1.f - g) + (2.f * g) * u_ang);
          const float ct = ((1.f + g * g) - s * s) / (2.f * g);
          cos_t = fminf(fmaxf(ct, -1.f), 1.f);
        }
      } else {
        const float t_u = u_ang * static_cast<float>(inv_n_steps - 1);
        int ki = static_cast<int>(t_u);
        ki = ki < 0 ? 0 : (ki > inv_n_steps - 2 ? inv_n_steps - 2 : ki);
        const float frac = t_u - static_cast<float>(ki);
        const int flat = static_cast<int>(f2) * inv_n_steps + ki;
        cos_t = cosf(__ldg(inv_a0 + flat) + frac * __ldg(inv_dd + flat));
      }
      const float sin_t = sqrtf(fmaxf(0.f, 1.f - cos_t * cos_t));
      float sp, cp;
      sincosf(phi_rot, &sp, &cp);
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

    xs[lane] = x;
    ys[lane] = y;
    zs[lane] = z;
    uxs[lane] = ux;
    uys[lane] = uy;
    uzs[lane] = uz;
    ws[lane] = w;
    bls[lane] = bl;
    quotas[lane] = quota;
    alives[lane] = alive ? 1 : 0;
    if (started) atomicAdd(&s_counts[0], started);
    if (alive || quota > 0) atomicAdd(&s_counts[1], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = s_acc[i];
    if (v != 0.f) atomicAdd(&acc[i], v);
  }
  if (threadIdx.x < 2 && s_counts[threadIdx.x]) {
    atomicAdd(&counts[threadIdx.x], s_counts[threadIdx.x]);
  }
}

template <bool MACRO, bool VOL, bool ANALYTIC>
cudaError_t launch(const float* prm, const float* rec, const float* inv_a0,
                   const float* inv_dd, float* x, float* y, float* z,
                   float* ux, float* uy, float* uz, float* w, float* bl,
                   int* quota, int* alive, float* acc, int* counts,
                   int n_lanes, int nx, int ny, int nz, int stride,
                   int off_ssa, int off_f2, int inv_n_steps, int use_rr,
                   int n_acc, uint32_t seed, uint32_t step0, int k_steps,
                   cudaStream_t stream) {
  auto kernel = record_steps<MACRO, VOL, ANALYTIC>;
  const size_t smem = static_cast<size_t>(n_acc) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      prm, rec, inv_a0, inv_dd, x, y, z, ux, uy, uz, w, bl, quota, alive,
      acc, counts, n_lanes, nx, ny, nz, stride, off_ssa, off_f2,
      inv_n_steps, use_rr, n_acc, seed, step0, k_steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int record_kernel_num_params() { return N_PARAMS; }

// Advance every lane by k_steps transport steps. Adds the tally into acc,
// the photons started into counts[0] and the lanes with work left
// (alive or quota > 0) into counts[1]. Returns cudaGetLastError().
extern "C" int record_kernel_launch(
    const float* prm, const float* rec, const float* inv_a0,
    const float* inv_dd, float* x, float* y, float* z, float* ux,
    float* uy, float* uz, float* w, float* bl, int* quota, int* alive,
    float* acc, int* counts, int n_lanes, int nx, int ny, int nz,
    int stride, int off_ssa, int off_f2, int inv_n_steps, int use_rr,
    int n_acc, uint32_t seed, uint32_t step0, int k_steps, int macro,
    int vol, int analytic, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCB_LAUNCH(M, V, A)                                                  \
  return static_cast<int>(launch<M, V, A>(                                   \
      prm, rec, inv_a0, inv_dd, x, y, z, ux, uy, uz, w, bl, quota, alive,    \
      acc, counts, n_lanes, nx, ny, nz, stride, off_ssa, off_f2,             \
      inv_n_steps, use_rr, n_acc, seed, step0, k_steps, s))
  if (macro) {
    if (vol) {
      if (analytic) MCB_LAUNCH(true, true, true);
      MCB_LAUNCH(true, true, false);
    }
    if (analytic) MCB_LAUNCH(true, false, true);
    MCB_LAUNCH(true, false, false);
  }
  if (vol) {
    if (analytic) MCB_LAUNCH(false, true, true);
    MCB_LAUNCH(false, true, false);
  }
  if (analytic) MCB_LAUNCH(false, false, true);
  MCB_LAUNCH(false, false, false);
#undef MCB_LAUNCH
}
