// Column-template kernel for NVIDIA Hopper (sm_90a): flux path.
//
// Replaces: mcbrat3d_tpu/transport/pallas_col.py `_build_kernel_col`, flux
// path (one component with uniform ssa, analytic HG or one tabulated
// inverse-CDF row, directional / random-azimuth / flux sources, uniform
// Lambertian surface), as launched by `run_batch_pallas_col`. The domain is
// a column template, beta = col_scale[col] * (iz < col_height[col]), so two
// per-column values carry a field of millions of cells. Per step a lane
// refills from the source, jumps against its carried xy-block majorant
// below the block's cloud-top plane and advances geometrically above it
// (clipped at the block faces, clamped to the domain edge, and, descending,
// at the plane; a photon on an outward face takes one global-ceiling step),
// gathers its column, tests the null collision, absorbs by the uniform
// ssa, plays roulette, scatters or reflects, and tallies flux up/down and
// absorption per column, the absorption z profile and, optionally, the 3D
// absorption field.
//
// Design. One thread per photon lane; lane = blockIdx.x * blockDim.x +
// threadIdx.x, the TPU kernel's row * 128 + lane, so the counter-based
// uniforms (K3's draw sites) are the numbers the JAX kernel and the plain
// PyTorch step draw. A thread loads its state into registers, runs k_steps
// steps and writes the state back. The column fields (2 x 64 KB at 16,384
// columns) are read with __ldg and stay in L1/L2; the f32 scale replaces
// the TPU kernel's bf16 hi/lo reconstruction. The block table and the
// inverse-CDF row go to shared memory when they fit the per-block budget
// (kept so that two 256-thread blocks share an SM: 65,536 lanes then fit
// the card in one wave), else they are read with __ldg. Flux up/down and
// column absorption (3 * nx * ny floats, 192 KB on the Landsat deck) go to
// global atomics over 16,384 addresses, which rarely collide; the z profile
// (nz <= 128 floats) accumulates in shared memory and is flushed once per
// block per launch; the optional 3D field goes to global atomics.
//
// What bounds it on this card: like the record kernel, the latency of the
// dependent per-step math (divisions, log1p, sqrt, sincos, the table or HG
// sampling) with at most 65,536 lanes in flight, and the global atomics of
// the tallies; its bytes (state, two column fields, small tables) and its
// operations are both far below the card's rates. It does no matrix work,
// so wgmma and TMA do not apply.
//
// Arithmetic follows the JAX kernel operation by operation in float32, and
// the library is built with -fmad=false so no multiply-add is contracted
// away from the plain PyTorch step.

#include <cstdint>
#include <cuda_runtime.h>

#include "mcb_common.cuh"

namespace {

using mcb::clampi;
using mcb::face_dist;
using mcb::kBig;
using mcb::kTiny;
using mcb::uniform;
using mcb::wrap;

constexpr int kThreads = 256;
// Shared memory a block may take for its tables (two blocks per SM).
constexpr size_t kMaxTableSmem = 96 * 1024;

// params[] slots (mcbrat3d_tpu_torch/transport/col_kernel.py C_*).
enum {
  C_BETA_MAX, C_ALBEDO, C_SMU, C_SUX, C_SUY, C_RR_W, C_HALF_RR, C_X0, C_LX,
  C_Y0, C_LY, C_Z0, C_LZ, C_SSA, C_G, C_INV_DX, C_INV_DY, C_INV_DZ, C_DZ,
  C_ZMAX, C_ZTOP, C_ZBOT, C_BXW, C_BYW, C_NUDGE, C_TWO_PI, N_PARAMS
};

// Source kinds (col_kernel.SOURCE_KINDS).
enum { SRC_DIRECTIONAL, SRC_RANDOM_AZIMUTH, SRC_FLUX };

// K3 draw sites (col_kernel.SITE_*).
enum : uint32_t {
  S_X = 0, S_Y = 1, S_SRC = 2, S_TAU = 3, S_COLLIDE = 4, S_ANGLE = 5,
  S_PHI = 6, S_ROULETTE = 7, S_SRC_PHI = 9
};

__device__ __forceinline__ float table(const float* s, const float* g, int i,
                                       bool in_smem) {
  return in_smem ? s[i] : __ldg(g + i);
}

template <bool MACRO, bool ANALYTIC, bool VOL, bool RR, int SRC>
__global__ void __launch_bounds__(kThreads)
col_steps(const float* __restrict__ prm,
          const float* __restrict__ col_scale,
          const float* __restrict__ col_height,
          const float* __restrict__ g_blk,
          const float* __restrict__ g_inv_a0,
          const float* __restrict__ g_inv_dd,
          float* __restrict__ xs, float* __restrict__ ys,
          float* __restrict__ zs, float* __restrict__ uxs,
          float* __restrict__ uys, float* __restrict__ uzs,
          float* __restrict__ ws, float* __restrict__ blss,
          float* __restrict__ blhs, int* __restrict__ quotas,
          int* __restrict__ alives, float* __restrict__ acc,
          int* __restrict__ counts, int n_lanes, int nx, int ny, int nz,
          int mf, int nby, int n_blk, int inv_n, int blk_smem, int inv_smem,
          uint32_t seed, uint32_t step0, int k_steps) {
  extern __shared__ float smem[];
  __shared__ int s_counts[3];
  float* s_prof = smem;                                  // [nz]
  float* s_blk = s_prof + nz;                            // [2 * n_blk]
  float* s_a0 = s_blk + (blk_smem ? 2 * n_blk : 0);      // [inv_n]
  float* s_dd = s_a0 + (inv_smem ? inv_n : 0);           // [inv_n]
  for (int i = threadIdx.x; i < nz; i += blockDim.x) s_prof[i] = 0.f;
  if (MACRO && blk_smem) {
    for (int i = threadIdx.x; i < 2 * n_blk; i += blockDim.x) {
      s_blk[i] = g_blk[i];
    }
  }
  if (!ANALYTIC && inv_smem) {
    for (int i = threadIdx.x; i < inv_n; i += blockDim.x) {
      s_a0[i] = g_inv_a0[i];
      s_dd[i] = g_inv_dd[i];
    }
  }
  for (int i = threadIdx.x; i < 3; i += blockDim.x) s_counts[i] = 0;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n_lanes) {
    const float beta_max = prm[C_BETA_MAX], albedo = prm[C_ALBEDO];
    const float smu = prm[C_SMU], sux = prm[C_SUX], suy = prm[C_SUY];
    const float rr_w = prm[C_RR_W], half_rr = prm[C_HALF_RR];
    const float x0 = prm[C_X0], lx = prm[C_LX], y0 = prm[C_Y0];
    const float ly = prm[C_LY], z0 = prm[C_Z0];
    const float ssa = prm[C_SSA], g = prm[C_G];
    const float inv_dx = prm[C_INV_DX], inv_dy = prm[C_INV_DY];
    const float inv_dz = prm[C_INV_DZ], dz = prm[C_DZ];
    const float z_max = prm[C_ZMAX], z_top = prm[C_ZTOP];
    const float z_bot = prm[C_ZBOT], bx_w = prm[C_BXW], by_w = prm[C_BYW];
    const float nudge = prm[C_NUDGE], two_pi = prm[C_TWO_PI];
    const float nzf = static_cast<float>(nz);
    const int nxy = nx * ny;
    float* acc_vol = acc + 3 * nxy + nz;  // 3D field, [col][level]

    float x = xs[lane], y = ys[lane], z = zs[lane];
    float ux = uxs[lane], uy = uys[lane], uz = uzs[lane];
    float w = ws[lane], bls = blss[lane], blh = blhs[lane];
    int quota = quotas[lane];
    bool alive = alives[lane] > 0;
    int started = 0, steps = 0;
    const uint32_t ul = static_cast<uint32_t>(lane);

    for (int k = 0; k < k_steps; ++k) {
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      // ---- refill a dead lane from the source ----
      if (!alive && quota > 0) {
        x = x0 + uniform(ul, seed, ctr, S_X) * lx;
        y = y0 + uniform(ul, seed, ctr, S_Y) * ly;
        z = z_top;
        if (SRC == SRC_DIRECTIONAL) {
          ux = sux;
          uy = suy;
          uz = -smu;
        } else {
          float s_mu, s_phi;
          if (SRC == SRC_RANDOM_AZIMUTH) {
            s_mu = -smu;
            s_phi = two_pi * uniform(ul, seed, ctr, S_SRC);
          } else {
            s_mu = -sqrtf(fmaxf(uniform(ul, seed, ctr, S_SRC), 1e-12f));
            s_phi = two_pi * uniform(ul, seed, ctr, S_SRC_PHI);
          }
          const float s_sin = sqrtf(fmaxf(0.f, 1.f - s_mu * s_mu));
          ux = s_sin * cosf(s_phi);
          uy = s_sin * sinf(s_phi);
          uz = s_mu;
        }
        w = 1.f;
        alive = true;
        quota -= 1;
        started += 1;
        bls = beta_max;
        blh = nzf;
      }
      if (!alive) continue;
      steps += 1;

      // ---- Woodcock jump against the carried block ceiling ----
      const float tau = -log1pf(-uniform(ul, seed, ctr, S_TAU));
      const float ztop_m = z0 + blh * dz;  // block cloud-top plane
      const bool above = z >= ztop_m;
      float ceiling = above ? 0.f : bls;
      float d_samp = ceiling > 0.f ? tau / ceiling : kBig;
      float d;
      bool clipped = false;
      if (MACRO) {
        const float tx = face_dist(x, x0, ux, bx_w, lx);
        const float ty = face_dist(y, y0, uy, by_w, ly);
        const float tz =
            (above && uz < -1e-12f) ? (ztop_m - z) / uz : kBig;
        const float t_raw = fminf(fminf(tx, ty), tz);
        const bool escape = t_raw <= 0.f;
        if (escape) {
          bls = beta_max;
          blh = nzf;
          ceiling = beta_max;
          d_samp = tau / beta_max;
        }
        const float t_clip = escape ? kBig : t_raw + nudge;
        clipped = t_clip < d_samp;
        d = fminf(d_samp, t_clip);
      } else {
        d = ceiling > 0.f ? d_samp : kBig;
      }
      const float zn = z + uz * d;
      const bool exit_top = zn >= z_max;
      const bool exit_bot = !exit_top && zn <= z0;
      const float u_ang = uniform(ul, seed, ctr, S_ANGLE);
      const float phi_rot = two_pi * uniform(ul, seed, ctr, S_PHI);

      if (exit_top || exit_bot) {
        // ---- boundary exit: tally, then reflect off the surface ----
        const float z_b = exit_top ? z_max : z0;
        const float safe_uz = fabsf(uz) < 1e-12f ? 1.f : uz;
        const float t_b = (z_b - z) / safe_uz;
        const float xe = x0 + wrap((x + ux * t_b) - x0, lx);
        const float ye = y0 + wrap((y + uy * t_b) - y0, ly);
        const int ixe = clampi(static_cast<int>((xe - x0) * inv_dx), nx - 1);
        const int iye = clampi(static_cast<int>((ye - y0) * inv_dy), ny - 1);
        const int col_e = ixe * ny + iye;
        atomicAdd(&acc[exit_top ? col_e : nxy + col_e], w);
        if (exit_top) {
          alive = false;
        } else {
          const float w_refl = w * albedo;
          x = xe;
          y = ye;
          z = z_bot;
          bls = beta_max;  // reflected photons restart with the global
          blh = nzf;       // ceiling
          if (w_refl <= kTiny) {
            alive = false;
          } else {
            const float mu_new = sqrtf(fmaxf(u_ang, 1e-12f));
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

      // ---- move to the collision (or clip) point ----
      const float xc = x0 + wrap((x + ux * d) - x0, lx);
      const float yc = y0 + wrap((y + uy * d) - y0, ly);
      const float zc = fminf(fmaxf(zn, z0), z_max);
      const int ix = clampi(static_cast<int>((xc - x0) * inv_dx), nx - 1);
      const int iy = clampi(static_cast<int>((yc - y0) * inv_dy), ny - 1);
      const int iz = clampi(static_cast<int>((zc - z0) * inv_dz), nz - 1);
      const int col = ix * ny + iy;
      x = xc;
      y = yc;
      z = zc;
      if (MACRO) {  // carry the destination block's majorant
        const int b = (ix / mf) * nby + iy / mf;
        bls = table(s_blk, g_blk, 2 * b, blk_smem);
        blh = table(s_blk, g_blk, 2 * b + 1, blk_smem);
      }
      if (clipped) continue;

      // ---- column gather; null-collision test against the ceiling the
      // jump sampled with ----
      const float beta = static_cast<float>(iz) < __ldg(col_height + col)
                             ? __ldg(col_scale + col)
                             : 0.f;
      if (!(uniform(ul, seed, ctr, S_COLLIDE) * ceiling < beta)) continue;

      // ---- real collision: absorption weight, tallies, roulette ----
      const float absorbed = w * (1.f - ssa);
      w = w * ssa;
      if (absorbed != 0.f) {
        atomicAdd(&acc[2 * nxy + col], absorbed);
        atomicAdd(&s_prof[iz], absorbed);
        if (VOL) atomicAdd(&acc_vol[col * nz + iz], absorbed);
      }
      if (RR && w < half_rr) {
        w = uniform(ul, seed, ctr, S_ROULETTE) < w / rr_w ? rr_w : 0.f;
      }
      if (w <= kTiny) {
        alive = false;
        continue;
      }

      // ---- scatter: sample cos(theta), rotate the direction ----
      float cos_t;
      if (ANALYTIC) {
        cos_t = mcb::hg_cos(g, u_ang);
      } else {
        const float t_u = u_ang * static_cast<float>(inv_n - 1);
        int ki = static_cast<int>(t_u);
        ki = ki < 0 ? 0 : (ki > inv_n - 2 ? inv_n - 2 : ki);
        const float frac = t_u - static_cast<float>(ki);
        cos_t = cosf(table(s_a0, g_inv_a0, ki, inv_smem) +
                     frac * table(s_dd, g_inv_dd, ki, inv_smem));
      }
      mcb::rotate(ux, uy, uz, cos_t, phi_rot);
    }

    xs[lane] = x;
    ys[lane] = y;
    zs[lane] = z;
    uxs[lane] = ux;
    uys[lane] = uy;
    uzs[lane] = uz;
    ws[lane] = w;
    blss[lane] = bls;
    blhs[lane] = blh;
    quotas[lane] = quota;
    alives[lane] = alive ? 1 : 0;
    if (started) atomicAdd(&s_counts[0], started);
    if (alive || quota > 0) atomicAdd(&s_counts[1], 1);
    if (steps) atomicAdd(&s_counts[2], steps);
  }
  __syncthreads();
  float* acc_prof = acc + 3 * nx * ny;
  for (int i = threadIdx.x; i < nz; i += blockDim.x) {
    const float v = s_prof[i];
    if (v != 0.f) atomicAdd(&acc_prof[i], v);
  }
  for (int i = threadIdx.x; i < 3; i += blockDim.x) {
    if (s_counts[i]) atomicAdd(&counts[i], s_counts[i]);
  }
}

struct Args {
  const float *prm, *col_scale, *col_height, *blk, *inv_a0, *inv_dd;
  float *x, *y, *z, *ux, *uy, *uz, *w, *bls, *blh;
  int *quota, *alive;
  float* acc;
  int* counts;
  int n_lanes, nx, ny, nz, mf, nby, n_blk, inv_n;
  uint32_t seed, step0;
  int k_steps;
};

template <bool MACRO, bool ANALYTIC, bool VOL, bool RR, int SRC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = col_steps<MACRO, ANALYTIC, VOL, RR, SRC>;
  // the profile, then the block table and the inverse-CDF row where they
  // fit the budget (else the kernel reads them with __ldg)
  size_t smem = static_cast<size_t>(a.nz) * sizeof(float);
  const size_t blk_bytes = 2 * static_cast<size_t>(a.n_blk) * sizeof(float);
  const size_t inv_bytes = 2 * static_cast<size_t>(a.inv_n) * sizeof(float);
  const int blk_smem = MACRO && smem + blk_bytes <= kMaxTableSmem;
  if (blk_smem) smem += blk_bytes;
  const int inv_smem = !ANALYTIC && smem + inv_bytes <= kMaxTableSmem;
  if (inv_smem) smem += inv_bytes;
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n_lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.prm, a.col_scale, a.col_height, a.blk, a.inv_a0, a.inv_dd, a.x, a.y,
      a.z, a.ux, a.uy, a.uz, a.w, a.bls, a.blh, a.quota, a.alive, a.acc,
      a.counts, a.n_lanes, a.nx, a.ny, a.nz, a.mf, a.nby, a.n_blk, a.inv_n,
      blk_smem, inv_smem, a.seed, a.step0, a.k_steps);
  return cudaGetLastError();
}

template <bool MACRO, bool ANALYTIC, bool VOL, bool RR>
cudaError_t launch_src(const Args& a, int src, cudaStream_t s) {
  switch (src) {
    case SRC_DIRECTIONAL:
      return launch<MACRO, ANALYTIC, VOL, RR, SRC_DIRECTIONAL>(a, s);
    case SRC_RANDOM_AZIMUTH:
      return launch<MACRO, ANALYTIC, VOL, RR, SRC_RANDOM_AZIMUTH>(a, s);
    case SRC_FLUX:
      return launch<MACRO, ANALYTIC, VOL, RR, SRC_FLUX>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool MACRO, bool ANALYTIC, bool VOL>
cudaError_t launch_rr(const Args& a, int rr, int src, cudaStream_t s) {
  return rr ? launch_src<MACRO, ANALYTIC, VOL, true>(a, src, s)
            : launch_src<MACRO, ANALYTIC, VOL, false>(a, src, s);
}

template <bool MACRO, bool ANALYTIC>
cudaError_t launch_vol(const Args& a, int vol, int rr, int src,
                       cudaStream_t s) {
  return vol ? launch_rr<MACRO, ANALYTIC, true>(a, rr, src, s)
             : launch_rr<MACRO, ANALYTIC, false>(a, rr, src, s);
}

template <bool MACRO>
cudaError_t launch_hg(const Args& a, int analytic, int vol, int rr, int src,
                      cudaStream_t s) {
  return analytic ? launch_vol<MACRO, true>(a, vol, rr, src, s)
                  : launch_vol<MACRO, false>(a, vol, rr, src, s);
}

}  // namespace

extern "C" int col_kernel_num_params() { return N_PARAMS; }

// Advance every lane by k_steps transport steps. Adds the tallies into acc
// ([up nxy | down nxy | absorbed nxy | profile nz | 3D field nxy * nz with
// vol]), the photons started into counts[0], the lanes with work left
// (alive or quota > 0) into counts[1] and the lane-steps run with a live
// photon into counts[2]. Returns cudaGetLastError().
extern "C" int col_kernel_launch(
    const float* prm, const float* col_scale, const float* col_height,
    const float* blk, const float* inv_a0, const float* inv_dd, float* x,
    float* y, float* z, float* ux, float* uy, float* uz, float* w,
    float* bls, float* blh, int* quota, int* alive, float* acc, int* counts,
    int n_lanes, int nx, int ny, int nz, int macro_factor, int nby,
    int n_blk, int inv_n, int n_acc, uint32_t seed, uint32_t step0,
    int k_steps, int analytic, int vol, int use_rr, int source_kind,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nxy = static_cast<long long>(nx) * ny;
  const long long want = 3 * nxy + nz + (vol ? nxy * nz : 0);
  if (n_acc != want || nz > 128 || (macro_factor > 0 && n_blk <= 0) ||
      (!analytic && inv_n < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{prm,   col_scale, col_height, blk,   inv_a0, inv_dd, x,
               y,     z,         ux,         uy,    uz,     w,      bls,
               blh,   quota,     alive,      acc,   counts, n_lanes, nx,
               ny,    nz,        macro_factor, nby, n_blk,  inv_n,  seed,
               step0, k_steps};
  const cudaError_t e =
      macro_factor > 0
          ? launch_hg<true>(a, analytic, vol, use_rr, source_kind, s)
          : launch_hg<false>(a, analytic, vol, use_rr, source_kind, s);
  return static_cast<int>(e);
}
