// Record kernel for NVIDIA Hopper (sm_90a): flux path and in-kernel
// radiance by local estimation.
//
// Replaces: mcbrat3d_tpu/transport/pallas_kernel.py `_build_kernel`, flux
// path (refill from the directional, random-azimuth, flux or spotlight
// source, or the BBEmission refill through a per-voxel Walker alias table
// with the lw_mode pre-credits, :897-987 and :2189-2213; Woodcock jump
// against the optional two-level macro majorant,
// record fetch with the component choice of 2-3 component domains,
// null-collision test, Russian roulette, HG or inverse-CDF scatter +
// rotation, uniform Lambertian reflection, fused flux / absorption tally),
// as launched by `_make_launch`; and its local
// estimation section (`_build_kernel` :1515-2115, configured by
// `run_batch_pallas_tallies` :3278-3325): at every real scatter and every
// surface reflection, for each radiance direction, the phase value (HG or
// a forward table uniform in sin(theta/2)), one cell DDA march to the
// domain top with the periodic x/y wrap, the exact or Iwabuchi roulette
// estimator, optional contribution capping, and the tally at the exit
// column.
//
// Design. One thread per photon lane; lane = blockIdx.x * 128 + threadIdx.x,
// the TPU kernel's row * 128 + lane, so the counter-based uniforms (the
// murmur3 mixer keyed by (lane, step * 256 + site, seed)) are the same
// numbers the JAX kernel and the plain PyTorch step draw. A thread loads
// its SoA state into registers, runs `k_steps` transport steps and writes
// the state back. The record table ([n_cells, stride] f32) and the
// inverse-CDF angle table are read with per-thread loads through L1/L2
// (the step cloud's 1,024 x 6 floats stay cached). A domain of 2-3
// components has 8-float records [beta, majorant, ssa_eff, cs_0, cs_1,
// f2_0, f2_1, f2_2] (domain.multi_component_records), 32-byte rows read as
// two float4 loads; one uniform against the cumulative scattering
// fractions picks the component whose f2 (HG g or table row) scatters.
// The source kind, the component count and lw are launch arguments,
// uniform across a launch, so their branches never diverge.
//
// Emission (src = SRC_EMISSION). A refilled lane draws the atmosphere or
// the surface (one uniform against fracAtmsPower), a bin of the Walker
// alias pair over every voxel and its acceptance: two per-thread __ldg
// loads of em_prob[bin] and em_alias[bin] from global memory (196 KB at
// 24,576 cells; the shared budget stays with the tallies), where the TPU
// kernel gathered a transposed table and split it in bf16 hi/lo rows.
// The cell is decomposed with integer divides (the JAX kernel's floored
// float divides give the same cell on every cell of the envelope). With
// lw, an atmospheric birth adds -1 to the volume tally at its cell: one
// shared atomic, the lane's second tally in that step (the TPU kernel's
// one-hot sublane contraction). With lw and radiance, a newly emitted
// lane only contributes its emission local estimate (weight 1, isotropic
// 1/(4 pi mu_d) or Lambertian 1/pi) in its birth step and moves from the
// next step on; on the flux path it moves in its birth step. Tallies accumulate in
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
// Radiance (template flag LE). A thread that scatters or reflects loops
// over the directions and marches each one cell by cell to the top in a
// loop that ends when the ray leaves the top (the TPU kernel's column
// formulations and static per-direction bounds were Mosaic cost-model
// choices; a per-thread early exit does their job). The march is still
// bounded (k_dda, local_estimate.march_bound), and a march that reaches
// the bound is counted (counts[4], folded into n_bad) so a stall is never
// silent. Its cost is divergence: lanes without an event idle while
// others march, and marches differ in length. The image tally
// [section][direction][column]
// lives in shared memory when it fits (flushed once per launch like the
// flux tally); past the shared-memory budget the launcher sends it to
// global atomics. The direction cap of 64 per launch comes from the
// uniforms: they are keyed by step * 256 + site, and direction d draws
// its roulette numbers at sites 16 + 2d and 17 + 2d, so 64 directions keep
// every site below 144 and clear of the next step's draws.
//
// Arithmetic follows the JAX kernel operation by operation in float32.
// The periodic wrap uses fmodf plus a divisor-sign correction, which is
// exactly jnp.mod / torch.remainder (sign of the divisor). The library is
// built with -fmad=false so no multiply-add is contracted, matching the
// plain PyTorch step on the same card.

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

constexpr int kThreads = 128;
constexpr int kMaxDirs = 64;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.31830988618379067154f;
constexpr float kFourPi = 12.56637061435917295384f;
// Shared memory a block may take for its tallies (the H100 offers 227 KB).
constexpr size_t kMaxSmem = 200 * 1024;
// counts[]: photons started, lanes with work left, lane-steps run with a
// live photon, real collisions, radiance marches cut by the iteration bound,
// local-estimate events (the march iterations go to a 64-bit counter).
constexpr int kCounts = 6;

// params[] slots (mcbrat3d_tpu_torch/transport/record_kernel.py P_*).
enum {
  P_BETA_MAX, P_INV_BETA_MAX, P_ALBEDO, P_SMU, P_SUX, P_SUY, P_RR_W,
  P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ, P_INV_DX, P_INV_DY, P_INV_DZ,
  P_ZMAX, P_ZEPS, P_BXW, P_BYW, P_BZW, P_NUDGE, P_TWO_PI, P_HALF_RR,
  P_ZTOP, P_ZBOT, P_DXC, P_DYC, P_DZC, P_MNUDGE, P_ZETA, P_MAXC,
  P_SPOT_X, P_SPOT_Y, P_ATMS, N_PARAMS
};

// Source kinds (record_kernel.py SOURCE_KINDS).
enum {
  SRC_DIRECTIONAL, SRC_RANDOM_AZIMUTH, SRC_FLUX, SRC_SPOTLIGHT, SRC_EMISSION
};

// Uniform draw sites (core/rng.py SITE_*).
enum {
  S_X = 0, S_Y = 1, S_SOURCE = 2, S_TAU = 3, S_COLLIDE = 4, S_ANGLE = 5,
  S_PHI = 6, S_ROULETTE = 7, S_COMPONENT = 8, S_SOURCE_PHI = 9,
  S_EM_SPLIT = 10, S_EM_BIN = 11, S_EM_ACCEPT = 12, S_EM_MU = 13
};

// Local-estimate phase source (record_kernel.py PHASE_*).
enum { PHASE_HG, PHASE_TABLE_ROW0, PHASE_TABLE };

// Kind of a local-estimate event (record_kernel.py EV_*): a scatter, a
// surface reflection or surface emission, an atmospheric emission.
enum { EV_SCATTER, EV_LAMBERT, EV_ISOTROPIC };

// Radiance switches of one launch.
struct LeArgs {
  int n_dirs;   // 0 = flux only
  int phase;    // PHASE_*
  int n_s;      // forward-table points per row
  int rr;       // Iwabuchi roulette estimator
  int cap;      // limitIntensityContributions
  int k_dda;    // march iteration bound
  int n_img;    // image entries: [n_sec][n_dirs][nxy]
  int n_exc;    // capped-excess entries: [n_sec][n_dirs] (0 without cap)
  int img_smem; // image tallied in shared memory (else global atomics)
};

// Local estimate of one event toward every direction (pallas_kernel.py
// :1515-2084, cell march) from (sx, sy, sz). kind EV_LAMBERT: a surface
// reflection or emission, phase value 1/pi; EV_ISOTROPIC: an atmospheric
// emission, 1/(4 pi mu_d); EV_SCATTER: a scatter with incoming direction
// (uxi, uyi, uzi) and phase field f2 (HG g, or the table row) of the
// chosen component. Adds w_ev * npf * exp(-tau) (or its roulette form)
// into img at the exit column; with the cap, into the section of the
// event's slot (0 the surface or an emission, 1 + c component c). Counts
// the event into events and each direction's march iterations into march.
__device__ __forceinline__ void local_estimate(
    const float* __restrict__ prm, const float* __restrict__ rec, int stride,
    const float* s_dirs, const float* __restrict__ fwd_v0,
    const float* __restrict__ fwd_dd, float* img, float* s_exc, int* s_bad,
    const LeArgs& le, int nx, int ny, int nz, uint32_t lane, uint32_t seed,
    uint32_t ctr, int kind, int slot, float sx, float sy, float sz,
    float w_ev, float uxi, float uyi, float uzi, float f2, int& events,
    unsigned long long& march) {
  const float x0 = prm[P_X0], lx = prm[P_LX], y0 = prm[P_Y0];
  const float ly = prm[P_LY], z0 = prm[P_Z0], z_max = prm[P_ZMAX];
  const float inv_dx = prm[P_INV_DX], inv_dy = prm[P_INV_DY];
  const float inv_dz = prm[P_INV_DZ], dxc = prm[P_DXC], dyc = prm[P_DYC];
  const float dzc = prm[P_DZC], mnudge = prm[P_MNUDGE];
  const float zeta = prm[P_ZETA], cap = prm[P_MAXC];
  const int nxy = nx * ny;
  events += 1;
  for (int d = 0; d < le.n_dirs; ++d) {
    const float ddx = s_dirs[d], ddy = s_dirs[kMaxDirs + d];
    const float ddz = s_dirs[2 * kMaxDirs + d];  // > 0 by eligibility
    float npf;
    if (kind == EV_LAMBERT) {
      npf = kInvPi;
    } else if (kind == EV_ISOTROPIC) {
      npf = 1.f / (kFourPi * ddz);
    } else {
      const float cosb = (uxi * ddx + uyi * ddy) + uzi * ddz;
      float pv;
      if (le.phase == PHASE_HG) {
        const float g = f2;
        const float q = fmaxf((1.f + g * g) - (2.f * g) * cosb, 1e-12f);
        pv = (1.f - g * g) / (q * sqrtf(q));
      } else {
        // table uniform in s = sin(theta/2): the index needs a sqrt only
        const float s_v = sqrtf(fmaxf((1.f - cosb) * 0.5f, 0.f));
        const float tpos = s_v * static_cast<float>(le.n_s - 1);
        int k = static_cast<int>(tpos);
        k = k < 0 ? 0 : (k > le.n_s - 2 ? le.n_s - 2 : k);
        const float frac = tpos - static_cast<float>(k);
        const int flat =
            (le.phase == PHASE_TABLE ? static_cast<int>(f2) * le.n_s : 0) + k;
        pv = __ldg(fwd_v0 + flat) + frac * __ldg(fwd_dd + flat);
      }
      npf = pv / (kFourPi * ddz);
    }
    // Iwabuchi roulette: the stopping depth is known before the march
    float u_i1 = 0.f, tau_free = 0.f, npf_pi = 0.f, tau_max = 0.f;
    float tau_stop = kBig;
    bool small = false;
    if (le.rr) {
      u_i1 = uniform(lane, seed, ctr, 16u + 2u * d);
      tau_free = -log1pf(-uniform(lane, seed, ctr, 17u + 2u * d));
      npf_pi = kPi * npf;
      small = npf_pi <= zeta;
      tau_max = -logf(zeta / fmaxf(npf_pi, kTiny));
      tau_stop = small ? tau_free : tau_max + tau_free;
    }
    const float sdx = fabsf(ddx) > 1e-12f ? ddx : 1e-12f;
    const float sdy = fabsf(ddy) > 1e-12f ? ddy : 1e-12f;
    // index-space nudge along the march: a face landing names the cell
    // being entered for either direction sign
    const float ndx = signf(ddx) * 1e-4f, ndy = signf(ddy) * 1e-4f;
    float px = sx, py = sy, pz = sz, tau = 0.f;
    int ex_col = 0;
    bool act = true;
    int it = 0;
    for (; act && it < le.k_dda; ++it) {
      const float pxw = x0 + wrap(px - x0, lx);
      const float pyw = y0 + wrap(py - y0, ly);
      const int ixm = clampi(static_cast<int>((pxw - x0) * inv_dx + ndx),
                             nx - 1);
      const int iym = clampi(static_cast<int>((pyw - y0) * inv_dy + ndy),
                             ny - 1);
      const int izm = clampi(static_cast<int>((pz - z0) * inv_dz), nz - 1);
      const float beta_m =
          __ldg(rec + static_cast<size_t>((ixm * ny + iym) * nz + izm) *
                          stride);
      const float fx =
          static_cast<float>(ddx >= 0.f ? ixm + 1 : ixm) * dxc + x0;
      const float fy =
          static_cast<float>(ddy >= 0.f ? iym + 1 : iym) * dyc + y0;
      const float fz = static_cast<float>(izm + 1) * dzc + z0;
      const float tx = fabsf(ddx) > 1e-12f ? (fx - pxw) / sdx : kBig;
      const float ty = fabsf(ddy) > 1e-12f ? (fy - pyw) / sdy : kBig;
      const float tz = (fz - pz) / ddz;
      const float ds = fmaxf(fminf(tx, fminf(ty, tz)), 0.f) + mnudge;
      tau = tau + beta_m * ds;
      const float pz2 = pz + ddz * ds;
      if (pz2 >= z_max) {
        const float tb = (z_max - pz) / ddz;
        const float exx = x0 + wrap((pxw + ddx * tb) - x0, lx);
        const float exy = y0 + wrap((pyw + ddy * tb) - y0, ly);
        ex_col = clampi(static_cast<int>((exx - x0) * inv_dx), nx - 1) * ny +
                 clampi(static_cast<int>((exy - y0) * inv_dy), ny - 1);
        act = false;
      } else if (le.rr && !(tau < tau_stop)) {
        act = false;
      }
      px = pxw + ddx * ds;
      py = pyw + ddy * ds;
      pz = pz2;
    }
    march += static_cast<unsigned long long>(it);
    if (act) {  // cut by the iteration bound: contributes nothing, counted
      atomicAdd(s_bad, 1);
      continue;
    }
    float contrib;
    if (le.rr) {
      const float w_rrc = (w_ev * zeta) * kInvPi;
      if (small) {
        contrib = (tau < tau_free && u_i1 * zeta <= npf_pi) ? w_rrc : 0.f;
      } else if (tau < tau_max) {
        contrib = (w_ev * npf) * expf(-tau);
      } else {
        contrib = (tau - tau_max < tau_free) ? w_rrc : 0.f;
      }
    } else {
      contrib = (w_ev * npf) * expf(-tau);
    }
    int sec = 0;
    if (le.cap) {
      const float over = fmaxf(contrib - cap, 0.f);
      contrib = fminf(contrib, cap);
      if (over > 0.f) atomicAdd(&s_exc[slot * le.n_dirs + d], over);
      sec = slot;
    }
    if (contrib != 0.f) {
      atomicAdd(&img[(sec * le.n_dirs + d) * nxy + ex_col], contrib);
    }
  }
}

template <bool MACRO, bool VOL, bool ANALYTIC, bool LE>
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
             const float* __restrict__ dirs,
             const float* __restrict__ fwd_v0,
             const float* __restrict__ fwd_dd, float* __restrict__ g_img,
             float* __restrict__ g_exc, const float* __restrict__ em_prob,
             const float* __restrict__ em_alias,
             unsigned long long* __restrict__ g_march, LeArgs le,
             int n_lanes, int nx, int ny, int nz, int stride, int off_ssa,
             int off_f2, int inv_n_steps, int use_rr, int n_acc,
             uint32_t seed, uint32_t step0, int k_steps, int src,
             int ncomp, int lw) {
  extern __shared__ float s_acc[];
  __shared__ int s_counts[kCounts];
  __shared__ float s_dirs[LE ? 3 * kMaxDirs : 1];
  // radiance tallies follow the flux tally in shared memory
  float* s_exc = s_acc + n_acc;
  float* img = g_img;
  if (LE && le.img_smem) img = s_exc + le.n_exc;  // else global atomics
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) s_acc[i] = 0.f;
  if constexpr (LE) {
    for (int i = threadIdx.x; i < le.n_exc; i += blockDim.x) s_exc[i] = 0.f;
    if (le.img_smem) {
      for (int i = threadIdx.x; i < le.n_img; i += blockDim.x) img[i] = 0.f;
    }
    for (int i = threadIdx.x; i < 3 * le.n_dirs; i += blockDim.x) {
      s_dirs[(i / le.n_dirs) * kMaxDirs + i % le.n_dirs] = dirs[i];
    }
  }
  for (int i = threadIdx.x; i < kCounts; i += blockDim.x) s_counts[i] = 0;
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
    const float spot_x = prm[P_SPOT_X], spot_y = prm[P_SPOT_Y];
    const float atms = prm[P_ATMS], dxc = prm[P_DXC], dyc = prm[P_DYC];
    const float dzc = prm[P_DZC];
    const int nxy = nx * ny;
    const int n_cells = nxy * nz;

    float x = xs[lane], y = ys[lane], z = zs[lane];
    float ux = uxs[lane], uy = uys[lane], uz = uzs[lane];
    float w = ws[lane], bl = bls[lane];
    int quota = quotas[lane];
    bool alive = alives[lane] > 0;
    int started = 0, steps = 0, reals = 0, events = 0;
    unsigned long long march = 0;
    const uint32_t ul = static_cast<uint32_t>(lane);

    for (int k = 0; k < k_steps; ++k) {
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      // ---- refill a dead lane from the source (pallas_kernel.py
      // :897-1027) ----
      bool born = false, born_atm = false;
      if (!alive && quota > 0) {
        born = true;
        float em_mu = 0.f;  // emission: mu of the birth
        if (src == SRC_EMISSION) {
          // atmosphere or surface, then a Walker alias draw of the voxel
          const float u0 = uniform(ul, seed, ctr, S_X);
          const float u1 = uniform(ul, seed, ctr, S_Y);
          born_atm = uniform(ul, seed, ctr, S_EM_SPLIT) < atms;
          int jbin = static_cast<int>(uniform(ul, seed, ctr, S_EM_BIN) *
                                      static_cast<float>(n_cells));
          jbin = jbin < n_cells - 1 ? jbin : n_cells - 1;
          const int v =
              uniform(ul, seed, ctr, S_EM_ACCEPT) < __ldg(em_prob + jbin)
                  ? jbin
                  : static_cast<int>(__ldg(em_alias + jbin) + 0.5f);
          const float u_mu = uniform(ul, seed, ctr, S_EM_MU);
          if (born_atm) {  // uniform in the voxel, isotropic
            const int col = v / nz;
            const int ix = col / ny;
            x = x0 + (static_cast<float>(ix) + u0) * dxc;
            y = y0 + (static_cast<float>(col - ix * ny) + u1) * dyc;
            z = fminf(fmaxf(z0 + (static_cast<float>(v - col * nz) +
                                  uniform(ul, seed, ctr, S_SOURCE)) *
                                     dzc,
                            z_bot),
                      z_top);
            em_mu = 1.f - 2.f * u_mu;
            if (fabsf(em_mu) < 1e-4f) em_mu = signf(em_mu + kTiny) * 1e-4f;
            if constexpr (VOL) {  // LW pre-credit at the birth cell
              if (lw) atomicAdd(&s_acc[2 * nxy + v], -1.f);
            }
          } else {  // uniform on the surface, Lambertian upward
            x = x0 + u0 * lx;
            y = y0 + u1 * ly;
            z = z_bot;
            em_mu = sqrtf(fmaxf(u_mu, 1e-12f));
          }
        } else if (src == SRC_SPOTLIGHT) {  // one entry point
          x = x0 + spot_x * lx;
          y = y0 + spot_y * ly;
          z = z_top;
        } else {
          x = x0 + uniform(ul, seed, ctr, S_X) * lx;
          y = y0 + uniform(ul, seed, ctr, S_Y) * ly;
          z = z_top;
        }
        if (src == SRC_DIRECTIONAL || src == SRC_SPOTLIGHT) {
          ux = sux;
          uy = suy;
          uz = -smu;
        } else {
          float s_mu = em_mu, s_phi;
          if (src == SRC_RANDOM_AZIMUTH) {
            s_mu = -smu;
            s_phi = two_pi * uniform(ul, seed, ctr, S_SOURCE);
          } else {  // flux (mu = -sqrt(u)) and emission: the azimuth
            if (src == SRC_FLUX) {
              s_mu = -sqrtf(fmaxf(uniform(ul, seed, ctr, S_SOURCE), 1e-12f));
            }
            s_phi = two_pi * uniform(ul, seed, ctr, S_SOURCE_PHI);
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
        if (MACRO) bl = beta_max;
      }
      if (!alive) continue;
      steps += 1;
      if constexpr (LE) {
        // LW radiance: a newly emitted lane contributes its emission local
        // estimate (weight 1) and moves from the next step on
        // (pallas_kernel.py:986, :1086-1091, :1529-1534, :1682-1688)
        if (lw && born) {
          local_estimate(prm, rec, stride, s_dirs, fwd_v0, fwd_dd, img, s_exc,
                         &s_counts[4], le, nx, ny, nz, ul, seed, ctr,
                         born_atm ? EV_ISOTROPIC : EV_LAMBERT, 0, x, y, z,
                         1.f, 0.f, 0.f, 0.f, 0.f, events, march);
          continue;
        }
      }

      // ---- Woodcock jump ----
      const float tau = -log1pf(-uniform(ul, seed, ctr, S_TAU));
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
      const float phi_rot = two_pi * uniform(ul, seed, ctr, S_PHI);

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
            if constexpr (LE) {
              local_estimate(prm, rec, stride, s_dirs, fwd_v0, fwd_dd, img,
                             s_exc, &s_counts[4], le, nx, ny, nz, ul, seed,
                             ctr, EV_LAMBERT, 0, xe, ye, z_bot, w_refl, 0.f,
                             0.f, 0.f, 0.f, events, march);
            }
            const float mu_new =
                sqrtf(fmaxf(uniform(ul, seed, ctr, S_ANGLE), 1e-12f));
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
      float beta, maj = 0.f, ssa = 0.f, cs0 = 0.f;
      if (ncomp > 1) {  // [beta, majorant, ssa_eff, cs_0 | ...]
        const float4 a = __ldg(reinterpret_cast<const float4*>(r));
        beta = a.x;
        maj = a.y;
        ssa = a.z;
        cs0 = a.w;
      } else {
        beta = __ldg(r);
        if (MACRO) maj = __ldg(r + 1);
      }
      const float ceiling = MACRO ? bl : beta_max;
      if (MACRO) bl = maj;
      if (!collide ||
          !(uniform(ul, seed, ctr, S_COLLIDE) * ceiling < beta)) {
        continue;
      }

      // ---- real collision: the scattering component (pallas_kernel.py
      // :1296-1309), absorption weight, tally, roulette ----
      ++reals;
      float f2;
      int slot = 1;  // local-estimate slot of the component (cap)
      if (ncomp > 1) {  // [... | cs_1, f2_0, f2_1, f2_2]
        const float4 b = __ldg(reinterpret_cast<const float4*>(r) + 1);
        const float u_cmp = uniform(ul, seed, ctr, S_COMPONENT);
        const bool past0 = u_cmp >= cs0;
        const bool past1 = ncomp == 3 && u_cmp >= b.x;
        f2 = past1 ? b.w : (past0 ? b.z : b.y);
        slot += static_cast<int>(past0) + static_cast<int>(past1);
      } else {
        ssa = __ldg(r + off_ssa);
        f2 = __ldg(r + off_f2);
      }
      atomicAdd(&s_acc[2 * nxy + (VOL ? cell : col_c)], w * (1.f - ssa));
      w = w * ssa;
      if constexpr (LE) {  // post-absorption, pre-roulette weight, incoming dir
        local_estimate(prm, rec, stride, s_dirs, fwd_v0, fwd_dd, img, s_exc,
                       &s_counts[4], le, nx, ny, nz, ul, seed, ctr,
                       EV_SCATTER, slot, x, y, z, w, ux, uy, uz, f2, events,
                       march);
      }
      if (use_rr && w < half_rr) {
        w = uniform(ul, seed, ctr, S_ROULETTE) < w / rr_w ? rr_w : 0.f;
      }
      if (w <= kTiny) {
        alive = false;
        continue;
      }

      // ---- scatter: sample cos(theta), rotate the direction ----
      const float u_ang = uniform(ul, seed, ctr, S_ANGLE);
      float cos_t;
      if (ANALYTIC) {
        cos_t = mcb::hg_cos(f2, u_ang);
      } else {
        const float t_u = u_ang * static_cast<float>(inv_n_steps - 1);
        int ki = static_cast<int>(t_u);
        ki = ki < 0 ? 0 : (ki > inv_n_steps - 2 ? inv_n_steps - 2 : ki);
        const float frac = t_u - static_cast<float>(ki);
        const int flat = static_cast<int>(f2) * inv_n_steps + ki;
        cos_t = cosf(__ldg(inv_a0 + flat) + frac * __ldg(inv_dd + flat));
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
    bls[lane] = bl;
    quotas[lane] = quota;
    alives[lane] = alive ? 1 : 0;
    if (started) atomicAdd(&s_counts[0], started);
    if (alive || quota > 0) atomicAdd(&s_counts[1], 1);
    if (steps) atomicAdd(&s_counts[2], steps);
    if (reals) atomicAdd(&s_counts[3], reals);
    if (events) atomicAdd(&s_counts[5], events);
    if (march) atomicAdd(g_march, march);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = s_acc[i];
    if (v != 0.f) atomicAdd(&acc[i], v);
  }
  if constexpr (LE) {
    for (int i = threadIdx.x; i < le.n_exc; i += blockDim.x) {
      const float v = s_exc[i];
      if (v != 0.f) atomicAdd(&g_exc[i], v);
    }
    if (le.img_smem) {
      for (int i = threadIdx.x; i < le.n_img; i += blockDim.x) {
        const float v = img[i];
        if (v != 0.f) atomicAdd(&g_img[i], v);
      }
    }
  }
  for (int i = threadIdx.x; i < kCounts; i += blockDim.x) {
    if (s_counts[i]) atomicAdd(&counts[i], s_counts[i]);
  }
}

template <bool MACRO, bool VOL, bool ANALYTIC, bool LE>
cudaError_t launch(const float* prm, const float* rec, const float* inv_a0,
                   const float* inv_dd, float* x, float* y, float* z,
                   float* ux, float* uy, float* uz, float* w, float* bl,
                   int* quota, int* alive, float* acc, int* counts,
                   const float* dirs, const float* fwd_v0,
                   const float* fwd_dd, float* img, float* exc,
                   const float* em_prob, const float* em_alias,
                   unsigned long long* march, LeArgs le, int n_lanes, int nx, int ny, int nz, int stride,
                   int off_ssa, int off_f2, int inv_n_steps, int use_rr,
                   int n_acc, uint32_t seed, uint32_t step0, int k_steps,
                   int src, int ncomp, int lw, cudaStream_t stream) {
  auto kernel = record_steps<MACRO, VOL, ANALYTIC, LE>;
  size_t smem = static_cast<size_t>(n_acc) * sizeof(float);
  if (LE) {
    smem += static_cast<size_t>(le.n_exc) * sizeof(float);
    const size_t img_bytes = static_cast<size_t>(le.n_img) * sizeof(float);
    le.img_smem = smem + img_bytes <= kMaxSmem;
    if (le.img_smem) smem += img_bytes;
  }
  // past 48 KB of static + dynamic shared memory a launch needs the
  // opt-in; the static part (counts, directions) is under 1 KB
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      prm, rec, inv_a0, inv_dd, x, y, z, ux, uy, uz, w, bl, quota, alive,
      acc, counts, dirs, fwd_v0, fwd_dd, img, exc, em_prob, em_alias, march,
      le, n_lanes, nx, ny, nz, stride, off_ssa, off_f2, inv_n_steps, use_rr,
      n_acc, seed, step0, k_steps, src, ncomp, lw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int record_kernel_num_params() { return N_PARAMS; }

// Advance every lane by k_steps transport steps, refilling from source kind
// src (SRC_*; emission draws from the alias pair em_prob/em_alias over the
// nx*ny*nz cells, and with lw, which needs vol, pre-credits its
// atmospheric births) on a domain of ncomp components (records of `stride`
// floats; 8, 16-byte aligned, when ncomp > 1). Adds the tally into acc,
// the photons started into counts[0], the lanes with work left (alive or
// quota > 0) into counts[1], the lane-steps run with a live photon into
// counts[2], the real collisions into counts[3] and, with radiance
// (n_dirs > 0), the image into img, the capped excess into exc, the
// marches cut by the iteration bound into counts[4], the local-estimate
// events into counts[5] and the march iterations into march[0]. Returns
// cudaGetLastError().
extern "C" int record_kernel_launch(
    const float* prm, const float* rec, const float* inv_a0,
    const float* inv_dd, float* x, float* y, float* z, float* ux,
    float* uy, float* uz, float* w, float* bl, int* quota, int* alive,
    float* acc, int* counts, const float* dirs, const float* fwd_v0,
    const float* fwd_dd, float* img, float* exc, const float* em_prob,
    const float* em_alias, unsigned long long* march, int n_lanes, int nx, int ny, int nz, int stride,
    int off_ssa, int off_f2, int inv_n_steps, int use_rr, int n_acc,
    uint32_t seed, uint32_t step0, int k_steps, int macro, int vol,
    int analytic, int src, int ncomp, int lw, int n_dirs, int le_phase,
    int fwd_n_s, int le_rr, int le_cap, int k_dda, int n_img, int n_exc,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dirs < 0 || n_dirs > kMaxDirs) return cudaErrorInvalidValue;
  if (src < SRC_DIRECTIONAL || src > SRC_EMISSION) {
    return cudaErrorInvalidValue;
  }
  if (lw && (src != SRC_EMISSION || !vol)) return cudaErrorInvalidValue;
  if (ncomp < 1 || ncomp > 3 || (ncomp > 1 && stride != 8)) {
    return cudaErrorInvalidValue;
  }
  const LeArgs le{n_dirs, le_phase, fwd_n_s, le_rr, le_cap,
                  k_dda,  n_img,    n_exc,   0};
#define MCB_CALL(M, V, A, L)                                                 \
  static_cast<int>(launch<M, V, A, L>(                                       \
      prm, rec, inv_a0, inv_dd, x, y, z, ux, uy, uz, w, bl, quota, alive,    \
      acc, counts, dirs, fwd_v0, fwd_dd, img, exc, em_prob, em_alias, march, \
      le, n_lanes, nx, ny, nz, stride, off_ssa, off_f2, inv_n_steps, use_rr, \
      n_acc, seed, step0, k_steps, src, ncomp, lw, s))
#define MCB_LAUNCH(M, V, A) \
  return n_dirs > 0 ? MCB_CALL(M, V, A, true) : MCB_CALL(M, V, A, false)
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
#undef MCB_CALL
}
