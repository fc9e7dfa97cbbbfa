// Separable-template kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: mcbrat3d_tpu/transport/pallas_sep.py `_build_kernel_sep`, as
// launched by `run_batch_pallas_sep`. The domain is separable,
// beta = amp[col] * p[z] + q[z] (a rank-1 scattering cloud over a
// horizontally uniform pure absorber), so one value per column and two per
// level carry the 325 x 325 x 150 broadband-LW flagship. Per step a lane
// refills from a directional, random-azimuth or flux source or from the
// separable thermal emission (atmosphere/surface split; cloud or gas
// branch; the cloud column by group rejection: a Walker alias over
// 128-column groups weighted by their largest amplitude, a uniform column
// in the group, accepted with amp[col] / gmax[group]; the gas column
// uniform; the level from the branch's z alias), where an atmospheric
// refill is pending for one step and is retried from the same branch when
// rejected (lane state 2); it jumps against a three-region majorant (the
// carried xy-block ceiling inside the cloud slab [zb, zt), the gas maxima
// below and above it), clipped at the xy block faces (clamped to the domain
// edge) inside the slab and at the facing slab plane, a photon on an
// outward face taking one step at the global ceiling; it tests the null
// collision against beta, absorbs by the effective ssa beta_c ssa_c / beta,
// plays roulette, scatters by the cloud's single phase entry (analytic HG
// or one inverse-CDF row) or reflects, and tallies flux up/down and net
// absorption per column, the net absorption z profile and, in LW mode, a
// -1 pre-credit at each atmospheric birth column and level.
//
// Design. One thread per photon slot; lane = blockIdx.x * blockDim.x +
// threadIdx.x keys the counter-based uniforms (K4's draw sites) as the
// TPU kernel's row * 128 + lane does, so the kernel and the plain PyTorch
// step draw the same numbers, and on the JAX package's geometry the
// numbers of the JAX kernel (interpret mode). A thread loads its state
// into registers, runs k_steps steps, starting its quota of photons one
// after another, and writes the state back; a slot with no photon, claim
// or quota left stops. The flux path runs the refill schedule
// (record_kernel.RefillSchedule): as many slots as the card holds resident
// threads for the instantiation (sep_kernel_occupancy: 4 blocks of 256 an
// SM at 64 registers, 135,168 on an H100), no more than the batch's
// photons, launches of 4,096 steps under the host's relaunch loop, where
// the JAX package ran 65,536 lanes and 128-step launches. The TPU
// kernel's bf16 hi/lo splits of amp, p, q and the tallies and its one-hot
// matrix gathers and tallies are not carried over: amp (422 KB on the
// deck) is read as float32 with __ldg and stays in L2; p, q, the z
// aliases and the emission group tables (a few KB) sit in shared memory;
// the block ceilings (1,681 blocks, 6.7 KB on the deck; the JAX package's
// bf16-bumped values, a majorant) and the inverse-CDF row go to shared
// memory where that costs no blocks an SM (mcb::table_layout): the deck's
// 9,001-step row (72 KB) would hold 2 blocks an SM and is read with __ldg
// (11% faster on the deck's configuration than the row in shared memory
// at its 2 blocks an SM; within a few percent at equal slots). Flux up/down and net column
// absorption (3 x 105,625 floats on the deck) go to global atomics; the z
// profile accumulates in shared memory and is flushed once per block per
// launch; the launch counters are int64.
//
// What bounds it on this card: like the record and column kernels, the
// latency of the dependent per-step math (divisions, log1pf, sqrtf,
// sincosf, the table or HG sampling) and of the births (7.4 live
// lane-steps a photon on the LW headline, so a slot spends much of its
// time starting photons), with 32 warps an SM in flight (64 registers a
// thread), and the atomics of the tallies and the pre-credits; its bytes
// (state, the amplitude column, small tables) and its operations are both
// far below the card's rates. It does no matrix work, so wgmma and TMA do
// not apply.
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
using mcb::signf;
using mcb::uniform;
using mcb::wrap;

constexpr int kThreads = 256;
constexpr int kGroup = 128;  // columns per emission group

// params[] slots (mcbrat3d_tpu_torch/transport/sep_kernel.py P_*).
enum {
  P_GMAX, P_CEIL_IN, P_Q_BELOW, P_Q_ABOVE, P_ALBEDO, P_SMU, P_SUX, P_SUY,
  P_RR_W, P_HALF_RR, P_X0, P_LX, P_Y0, P_LY, P_Z0, P_SSA_C, P_G, P_ATMS,
  P_PB, P_INV_DX, P_INV_DY, P_INV_DZ, P_DZ, P_ZMAX, P_ZTOP, P_ZBOT,
  P_ZSLAB_B, P_ZSLAB_T, P_BXW, P_BYW, P_NUDGE, P_TWO_PI, P_CELL_DX,
  P_CELL_DY, P_INV_NY, N_PARAMS
};

// Source kinds (sep_kernel.SOURCE_KINDS).
enum { SRC_DIRECTIONAL, SRC_RANDOM_AZIMUTH, SRC_FLUX, SRC_EMISSION };

// K4 draw sites (sep_kernel.SITE_*).
enum : uint32_t {
  S_X = 0, S_Y = 1, S_SRC = 2, S_TAU = 3, S_COLLIDE = 4, S_ANGLE = 5,
  S_PHI = 6, S_ROULETTE = 7, S_SRC_PHI = 9, S_SPLIT = 10, S_BIN = 11,
  S_ACC = 12, S_MU = 13, S_ZOFF = 14, S_BRANCH = 15, S_ZBIN = 16,
  S_ZACC = 17, S_LO = 18, S_AMP = 19
};

__device__ __forceinline__ float table(const float* s, const float* g, int i,
                                       bool in_smem) {
  return in_smem ? s[i] : __ldg(g + i);
}

template <int SRC, bool ANALYTIC, bool RR, bool LW>
__global__ void __launch_bounds__(kThreads)
sep_steps(const float* __restrict__ prm, const float* __restrict__ amp,
          const float* __restrict__ g_pz, const float* __restrict__ g_qz,
          const float* __restrict__ g_blk, const float* __restrict__ g_zpa,
          const float* __restrict__ g_grp,
          const float* __restrict__ g_inv_a0,
          const float* __restrict__ g_inv_dd, float* __restrict__ xs,
          float* __restrict__ ys, float* __restrict__ zs,
          float* __restrict__ uxs, float* __restrict__ uys,
          float* __restrict__ uzs, float* __restrict__ ws,
          float* __restrict__ blss, int* __restrict__ quotas,
          int* __restrict__ alives, float* __restrict__ acc,
          unsigned long long* __restrict__ counts, int n_lanes, int nx,
          int ny, int nz,
          int mf, int nby, int n_blk, int n_groups, int inv_n, int blk_smem,
          int inv_smem, uint32_t seed, uint32_t step0, int k_steps) {
  constexpr bool EMISSION = SRC == SRC_EMISSION;
  extern __shared__ float smem[];
  __shared__ int s_counts[3];
  float* s_prof = smem;                                   // [nz]
  float* s_pz = s_prof + nz;                              // [nz]
  float* s_qz = s_pz + nz;                                // [nz]
  float* s_zpa = s_qz + nz;                               // [4 nz]
  float* s_grp = s_zpa + (EMISSION ? 4 * nz : 0);         // [3 n_groups]
  float* s_blk = s_grp + (EMISSION ? 3 * n_groups : 0);   // [n_blk]
  float* s_a0 = s_blk + (blk_smem ? n_blk : 0);           // [inv_n]
  float* s_dd = s_a0 + (inv_smem ? inv_n : 0);            // [inv_n]
  for (int i = threadIdx.x; i < nz; i += blockDim.x) {
    s_prof[i] = 0.f;
    s_pz[i] = g_pz[i];
    s_qz[i] = g_qz[i];
  }
  if (EMISSION) {
    for (int i = threadIdx.x; i < 4 * nz; i += blockDim.x) s_zpa[i] = g_zpa[i];
    for (int i = threadIdx.x; i < 3 * n_groups; i += blockDim.x) {
      s_grp[i] = g_grp[i];
    }
  }
  if (blk_smem) {
    for (int i = threadIdx.x; i < n_blk; i += blockDim.x) s_blk[i] = g_blk[i];
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
    const float gmax = prm[P_GMAX], ceil_in = prm[P_CEIL_IN];
    const float q_below = prm[P_Q_BELOW], q_above = prm[P_Q_ABOVE];
    const float albedo = prm[P_ALBEDO], smu = prm[P_SMU];
    const float sux = prm[P_SUX], suy = prm[P_SUY];
    const float rr_w = prm[P_RR_W], half_rr = prm[P_HALF_RR];
    const float x0 = prm[P_X0], lx = prm[P_LX], y0 = prm[P_Y0];
    const float ly = prm[P_LY], z0 = prm[P_Z0];
    const float ssa_c = prm[P_SSA_C], g = prm[P_G];
    const float atms = prm[P_ATMS], pb = prm[P_PB];
    const float inv_dx = prm[P_INV_DX], inv_dy = prm[P_INV_DY];
    const float inv_dz = prm[P_INV_DZ], dz = prm[P_DZ];
    const float z_max = prm[P_ZMAX], z_top = prm[P_ZTOP];
    const float z_bot = prm[P_ZBOT];
    const float zs_b = prm[P_ZSLAB_B], zs_t = prm[P_ZSLAB_T];
    const float bx_w = prm[P_BXW], by_w = prm[P_BYW];
    const float nudge = prm[P_NUDGE], two_pi = prm[P_TWO_PI];
    const float cell_dx = prm[P_CELL_DX], cell_dy = prm[P_CELL_DY];
    const float inv_ny = prm[P_INV_NY];
    const int nxy = nx * ny;

    float x = xs[lane], y = ys[lane], z = zs[lane];
    float ux = uxs[lane], uy = uys[lane], uz = uzs[lane];
    float w = ws[lane], bls = blss[lane];
    int quota = quotas[lane];
    int st = alives[lane];  // 0 dead, 1 alive, 2 claimed proposal
    int started = 0, steps = 0;
    const uint32_t ul = static_cast<uint32_t>(lane);

    for (int k = 0; k < k_steps; ++k) {
      // a lane with no photon, no claim and no quota has no work left
      if (st == 0 && quota <= 0) break;
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      // ---- refill a dead lane (or retry a claimed proposal) ----
      if (st == 2 || (st == 0 && quota > 0)) {
        const bool committed = st == 2;
        float s_mu;
        bool pending = false;
        int col_b = 0, iz_b = 0;
        bool cloud_br = false;
        float accept_gmax = 0.f;
        if (EMISSION) {
          const float u0 = uniform(ul, seed, ctr, S_X);
          const float u1 = uniform(ul, seed, ctr, S_Y);
          const float u_bin = uniform(ul, seed, ctr, S_BIN);
          const float u_mu = uniform(ul, seed, ctr, S_MU);
          // committed lanes retry the same (atmospheric, cloud) branch
          const bool from_atm =
              uniform(ul, seed, ctr, S_SPLIT) < atms || committed;
          cloud_br = uniform(ul, seed, ctr, S_BRANCH) < pb || committed;
          if (from_atm) {
            if (cloud_br) {  // a group by alias, a uniform column in it
              int jg = static_cast<int>(u_bin * static_cast<float>(n_groups));
              jg = jg > n_groups - 1 ? n_groups - 1 : jg;
              const int g_i =
                  uniform(ul, seed, ctr, S_ACC) < s_grp[jg]
                      ? jg
                      : static_cast<int>(s_grp[n_groups + jg] + 0.5f);
              accept_gmax = s_grp[2 * n_groups + g_i];
              int lo = static_cast<int>(uniform(ul, seed, ctr, S_LO) * 128.f);
              lo = lo > kGroup - 1 ? kGroup - 1 : lo;
              col_b = g_i * kGroup + lo;
            } else {  // the gas column is uniform, from the same draw
              col_b = static_cast<int>(u_bin * static_cast<float>(nxy));
              col_b = col_b > nxy - 1 ? nxy - 1 : col_b;
            }
            int zbin = static_cast<int>(uniform(ul, seed, ctr, S_ZBIN) *
                                        static_cast<float>(nz));
            zbin = zbin > nz - 1 ? nz - 1 : zbin;
            const float* zp = s_zpa + (cloud_br ? 0 : 2 * nz);
            iz_b = uniform(ul, seed, ctr, S_ZACC) < zp[zbin]
                       ? zbin
                       : static_cast<int>(zp[nz + zbin] + 0.5f);
            const float colf = static_cast<float>(col_b);
            const float ixf = floorf((colf + 0.5f) * inv_ny);
            const float iyf = colf - ixf * static_cast<float>(ny);
            x = x0 + (ixf + u0) * cell_dx;
            y = y0 + (iyf + u1) * cell_dy;
            z = fminf(fmaxf(z0 + (static_cast<float>(iz_b) +
                                  uniform(ul, seed, ctr, S_ZOFF)) * dz,
                            z_bot),
                      z_top);
            float mu_a = 1.f - 2.f * u_mu;
            if (fabsf(mu_a) < 1e-4f) mu_a = signf(mu_a + kTiny) * 1e-4f;
            s_mu = mu_a;
            pending = true;
          } else {  // surface: uniform (x, y), Lambertian upward
            x = x0 + u0 * lx;
            y = y0 + u1 * ly;
            z = z_bot;
            s_mu = sqrtf(fmaxf(u_mu, 1e-12f));
          }
        } else {
          x = x0 + uniform(ul, seed, ctr, S_X) * lx;
          y = y0 + uniform(ul, seed, ctr, S_Y) * ly;
          z = z_top;
          s_mu = SRC == SRC_FLUX
                     ? -sqrtf(fmaxf(uniform(ul, seed, ctr, S_SRC), 1e-12f))
                     : -smu;
        }
        if (SRC == SRC_DIRECTIONAL) {
          ux = sux;
          uy = suy;
        } else {
          const float s_phi =
              two_pi * uniform(ul, seed, ctr,
                               SRC == SRC_RANDOM_AZIMUTH ? S_SRC : S_SRC_PHI);
          const float s_sin = sqrtf(fmaxf(0.f, 1.f - s_mu * s_mu));
          ux = s_sin * cosf(s_phi);
          uy = s_sin * sinf(s_phi);
        }
        uz = s_mu;
        w = 1.f;
        bls = ceil_in;  // fresh photons carry the global in-slab ceiling
        if (!committed) quota -= 1;  // claimed at the first proposal
        if (!pending) {
          st = 1;
          started += 1;
        } else {
          // ---- the pending proposal: accept (gas branch always, cloud
          // branch with amp / gmax) or keep the claim for a retry; the lane
          // does not move this step ----
          const bool accept =
              !cloud_br ||
              uniform(ul, seed, ctr, S_AMP) * accept_gmax < __ldg(amp + col_b);
          if (accept) {
            st = 1;
            started += 1;
            if (LW) {  // -1 at the birth column and level
              atomicAdd(&acc[2 * nxy + col_b], -1.f);
              atomicAdd(&s_prof[iz_b], -1.f);
            }
          } else {
            st = 2;
          }
          continue;
        }
      }
      if (st != 1) continue;
      steps += 1;

      // ---- Woodcock jump with the three-region ceiling ----
      const float tau = -log1pf(-uniform(ul, seed, ctr, S_TAU));
      const bool in_slab = z >= zs_b && z < zs_t;
      const bool below = z < zs_b;
      float ceiling = in_slab ? bls : (below ? q_below : q_above);
      float d_samp = ceiling > 0.f ? tau / ceiling : kBig;
      // clip planes: the facing slab plane always, the xy block faces
      // (clamped to the domain edge) inside the slab only
      const float tx = in_slab ? face_dist(x, x0, ux, bx_w, lx) : kBig;
      const float ty = in_slab ? face_dist(y, y0, uy, by_w, ly) : kBig;
      const float z_plane =
          in_slab ? (uz >= 0.f ? zs_t : zs_b) : (below ? zs_b : zs_t);
      const float toward = in_slab ? fabsf(uz) : (below ? uz : -uz);
      const float tz =
          toward > 1e-12f ? (z_plane - z) / (uz == 0.f ? 1.f : uz) : kBig;
      const float t_raw = fminf(fminf(tx, ty), tz);
      // a photon exactly on an outward face takes one global-ceiling step
      const bool escape = t_raw <= 0.f;
      if (escape) {
        bls = ceil_in;
        ceiling = gmax;
        d_samp = tau / gmax;
      }
      const float t_clip = escape ? kBig : t_raw + nudge;
      const bool clipped = t_clip < d_samp;
      const float d = fminf(d_samp, t_clip);
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
          st = 0;
        } else {
          const float w_refl = w * albedo;
          x = xe;
          y = ye;
          z = z_bot;
          bls = ceil_in;  // reflected photons restart with the global ceiling
          if (w_refl <= kTiny) {
            st = 0;
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
      // carry the destination block's in-slab ceiling
      bls = table(s_blk, g_blk, (ix / mf) * nby + iy / mf, blk_smem);
      if (clipped) continue;

      // ---- null-collision test against the ceiling the jump sampled ----
      const float beta_c = __ldg(amp + col) * s_pz[iz];
      const float beta = beta_c + s_qz[iz];
      if (!(uniform(ul, seed, ctr, S_COLLIDE) * ceiling < beta)) continue;

      // ---- real collision: non-analog absorption by the effective ssa
      // (the gas only absorbs), tallies, roulette ----
      const float ssa_eff = beta > 0.f ? beta_c * ssa_c / beta : 0.f;
      const float absorbed = w * (1.f - ssa_eff);
      w = w * ssa_eff;
      if (absorbed != 0.f) {
        atomicAdd(&acc[2 * nxy + col], absorbed);
        atomicAdd(&s_prof[iz], absorbed);
      }
      if (RR && w < half_rr) {
        w = uniform(ul, seed, ctr, S_ROULETTE) < w / rr_w ? rr_w : 0.f;
      }
      if (w <= kTiny) {
        st = 0;
        continue;
      }

      // ---- scatter: the cloud's single phase entry, then rotate ----
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
    quotas[lane] = quota;
    alives[lane] = st;
    if (started) atomicAdd(&s_counts[0], started);
    if (st > 0 || quota > 0) atomicAdd(&s_counts[1], 1);
    if (steps) atomicAdd(&s_counts[2], steps);
  }
  __syncthreads();
  float* acc_prof = acc + 3 * nx * ny;
  for (int i = threadIdx.x; i < nz; i += blockDim.x) {
    const float v = s_prof[i];
    if (v != 0.f) atomicAdd(&acc_prof[i], v);
  }
  for (int i = threadIdx.x; i < 3; i += blockDim.x) {
    if (s_counts[i]) {
      atomicAdd(&counts[i], static_cast<unsigned long long>(s_counts[i]));
    }
  }
}

struct Args {
  const float *prm, *amp, *pz, *qz, *blk, *zpa, *grp, *inv_a0, *inv_dd;
  float *x, *y, *z, *ux, *uy, *uz, *w, *bls;
  int *quota, *alive;
  float* acc;
  unsigned long long* counts;
  int n_lanes, nx, ny, nz, mf, nby, n_blk, n_groups, inv_n;
  uint32_t seed, step0;
  int k_steps;
  int* occ = nullptr;  // set: fill this occupancy record, do not launch
};

template <int SRC, bool ANALYTIC, bool RR, bool LW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = sep_steps<SRC, ANALYTIC, RR, LW>;
  // the profile, p, q and (emission) the z aliases and group tables, then
  // the block ceilings and the inverse-CDF row where mcb::table_layout puts
  // them (else the kernel reads them with __ldg)
  const bool emission = SRC == SRC_EMISSION;
  const size_t base = sizeof(float) *
                      (3 * static_cast<size_t>(a.nz) +
                       (emission ? 4 * static_cast<size_t>(a.nz) +
                                       3 * static_cast<size_t>(a.n_groups)
                                 : 0));
  const size_t bytes[2] = {
      static_cast<size_t>(a.n_blk) * sizeof(float),
      ANALYTIC ? 0 : 2 * static_cast<size_t>(a.inv_n) * sizeof(float)};
  size_t smem = 0;
  int in_smem[2] = {0, 0};
  const cudaError_t e = mcb::table_layout(kernel, kThreads, base, bytes,
                                          -1, &smem, in_smem);
  if (e != cudaSuccess) return e;
  const int blk_smem = in_smem[0], inv_smem = in_smem[1];
  if (a.occ != nullptr) {
    return mcb::occupancy_record(kernel, kThreads, smem, a.occ);
  }
  const int blocks = (a.n_lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.prm, a.amp, a.pz, a.qz, a.blk, a.zpa, a.grp, a.inv_a0, a.inv_dd, a.x,
      a.y, a.z, a.ux, a.uy, a.uz, a.w, a.bls, a.quota, a.alive, a.acc,
      a.counts, a.n_lanes, a.nx, a.ny, a.nz, a.mf, a.nby, a.n_blk,
      a.n_groups, a.inv_n, blk_smem, inv_smem, a.seed, a.step0, a.k_steps);
  return cudaGetLastError();
}

template <int SRC, bool ANALYTIC>
cudaError_t launch_rr_lw(const Args& a, int rr, int lw, cudaStream_t s) {
  if (SRC != SRC_EMISSION || !lw) {
    return rr ? launch<SRC, ANALYTIC, true, false>(a, s)
              : launch<SRC, ANALYTIC, false, false>(a, s);
  }
  return rr ? launch<SRC, ANALYTIC, true, true>(a, s)
            : launch<SRC, ANALYTIC, false, true>(a, s);
}

template <int SRC>
cudaError_t launch_hg(const Args& a, int analytic, int rr, int lw,
                      cudaStream_t s) {
  return analytic ? launch_rr_lw<SRC, true>(a, rr, lw, s)
                  : launch_rr_lw<SRC, false>(a, rr, lw, s);
}

cudaError_t dispatch(const Args& a, int source_kind, int analytic, int rr,
                     int lw, cudaStream_t s) {
  switch (source_kind) {
    case SRC_DIRECTIONAL:
      return launch_hg<SRC_DIRECTIONAL>(a, analytic, rr, lw, s);
    case SRC_RANDOM_AZIMUTH:
      return launch_hg<SRC_RANDOM_AZIMUTH>(a, analytic, rr, lw, s);
    case SRC_FLUX:
      return launch_hg<SRC_FLUX>(a, analytic, rr, lw, s);
    case SRC_EMISSION:
      return launch_hg<SRC_EMISSION>(a, analytic, rr, lw, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sep_kernel_num_params() { return N_PARAMS; }

// Advance every lane by k_steps transport steps. Adds the tallies into acc
// ([up nxy | down nxy | net absorbed nxy | net profile nz]), the photons
// started into counts[0], the lanes with work left (state > 0 or quota > 0)
// into counts[1] and the lane-steps run with a live photon into counts[2]
// (int64: a launch of 2^18 lanes x 8,192 steps reaches 2^31 lane-steps); a
// lane with no photon, claim or quota stops stepping. The block ceilings
// and the inverse-CDF row go to shared memory where that costs no blocks
// an SM. Returns cudaGetLastError().
extern "C" int sep_kernel_launch(
    const float* prm, const float* amp, const float* pz, const float* qz,
    const float* blk, const float* zpa, const float* grp,
    const float* inv_a0, const float* inv_dd, float* x, float* y, float* z,
    float* ux, float* uy, float* uz, float* w, float* bls, int* quota,
    int* alive, float* acc, unsigned long long* counts, int n_lanes, int nx,
    int ny, int nz,
    int macro_factor, int nby, int n_blk, int n_groups, int zb, int zt,
    int inv_n, int n_acc, uint32_t seed, uint32_t step0, int k_steps,
    int analytic, int use_rr, int lw, int source_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nxy = static_cast<long long>(nx) * ny;
  if (n_acc != 3 * nxy + nz || nz > 256 || nxy > 128 * 128 * 8 ||
      macro_factor <= 0 || n_blk <= 0 || n_groups * kGroup < nxy ||
      zb < 0 || zt > nz || zb >= zt || (!analytic && inv_n < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{prm,    amp,   pz,     qz,   blk,   zpa,     grp,
               inv_a0, inv_dd, x,     y,    z,     ux,      uy,
               uz,     w,     bls,    quota, alive, acc,    counts,
               n_lanes, nx,   ny,     nz,   macro_factor, nby, n_blk,
               n_groups, inv_n, seed, step0, k_steps};
  return static_cast<int>(dispatch(a, source_kind, analytic, use_rr, lw, s));
}

// The occupancy record (mcb::OCC_*) of the instantiation and shared-memory
// layout that sep_kernel_launch would take for these arguments, on the
// current card. Returns 0 or the CUDA error.
extern "C" int sep_kernel_occupancy(int nz, int n_groups, int n_blk,
                                    int inv_n, int analytic, int use_rr,
                                    int lw, int source_kind, int* out) {
  if (nz < 1 || nz > 256 || n_blk <= 0 || (!analytic && inv_n < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.nz = nz;
  a.n_groups = n_groups;
  a.n_blk = n_blk;
  a.inv_n = inv_n;
  a.occ = out;
  return static_cast<int>(
      dispatch(a, source_kind, analytic, use_rr, lw, nullptr));
}
