// Column-template kernel for NVIDIA Hopper (sm_90a): flux path, gas template,
// column emission, per-pixel albedo and local estimate.
//
// Replaces: mcbrat3d_tpu/transport/pallas_col.py `_build_kernel_col` (one
// component with uniform ssa, or the gas template; analytic HG or one
// tabulated inverse-CDF row; directional / random-azimuth / flux sources
// and the column BBEmission with its LW pre-credits; uniform or per-pixel
// Lambertian surface; the in-kernel local estimate, here a queue of events
// and a walk kernel, col_walk), as launched by `run_batch_pallas_col`. The domain is a column template,
// beta = col_scale[col] * (iz < col_height[col]) [+ qz[iz]], so two
// per-column values carry a field of millions of cells. Per step a lane
// refills from the source, jumps against its carried xy-block majorant
// below the block's cloud-top plane and advances geometrically above it
// (with the gas template it samples against the gas maximum qg there and
// against bls + qg below; clipped at the block faces, clamped to the domain
// edge, and, descending, at the plane; a photon on an outward face takes
// one global-ceiling step), gathers its column (+ the gas at its level),
// tests the null collision, absorbs by the ssa (with gas the effective
// beta_cloud * ssa / beta), plays roulette, scatters or reflects, and
// tallies flux up/down and absorption per column, the absorption z profile
// and, optionally, the 3D absorption field.
//
// Column BBEmission (pallas_col.py:407-466). A share atms_fraction of the
// births start in the atmosphere: a Walker alias draw over the columns (a
// uniform bin, its probability and, when the acceptance uniform reaches it,
// the alias target and that target's height: three __ldg at most) and the
// level count #{k : fcum[k] <= u * fcum[h - 1]} of the cumulative Planck
// table truncated at the column's height, found by an upper-bound search
// over fcum in shared memory (nondecreasing, at most 128 entries, so the
// search gives the JAX kernel's count exactly); the photon starts uniform
// in that cell with an isotropic mu of magnitude at least 1e-4. The rest
// start on the surface with mu = sqrt(u). With lw each atmospheric birth
// adds -1 to its column's absorption, to its level in a pre-credit profile
// row of its own (JAX's accz row 1) and, with the 3D tally, to its cell.
// Per-pixel Lambertian (pallas_col.py:714-727): an albedo per column, read
// with __ldg at the column where the photon reaches the surface (a null
// pointer means the scalar albedo). Source kind, lw and the albedo are
// launch arguments, not template flags.
//
// Local estimate (LE, pallas_col.py:745-970), in two kernels. The
// transport kernel's LE instantiation queues every real collision and every
// surface reflection (a step makes one of these at most): one record of the
// event point, its weight, the incoming direction, whether it reflects, and
// the lane and step counter that key its draws, written into
// struct-of-arrays buffers at a slot taken with one atomicAdd per warp.
// col_walk then computes every (event, direction) pair of the launch, one
// thread each, over the whole card: the phase value (the forward row in
// s = sin(theta/2) or analytic HG over 4 pi mu; 1/pi for a reflection), the
// Iwabuchi roulette draws at sites 32 + 2d and 33 + 2d of the event's lane
// and step, then a column walk from the event: per crossed column (wrapped
// periodically) it adds CT(z_in) - CT(z_out), CT(z) = max(0, A - B z), from
// one 8-byte load of the interleaved (A, B) table, until the ray leaves the
// top or passes the global maximum cloud top (above which every CT is 0);
// the gas term is closed form. The contribution goes to the column where
// the ray leaves the top, by a global atomicAdd into the image
// [n_dirs][nx * ny] (1 MB at 16 directions: too large for shared memory).
// The TPU kernel sums the same segments by fast-axis slab (a slab scan with
// one-hot gathers); the walk crosses them in order of distance, so the two
// differ in rounding order only. A walk is bounded by k_walk iterations
// (the faces of the most slanted direction from the bottom to the top); one
// that would exceed it is cut and counted, never left to run. The estimate
// is a pure tally and its draws are keyed by the event's own (lane, step),
// so a later kernel on other threads computes the same numbers.
//
// Design. One thread per photon slot; lane = blockIdx.x * blockDim.x +
// threadIdx.x keys the counter-based uniforms (K3's draw sites) as the
// TPU kernel's row * 128 + lane does, so the kernel and the plain PyTorch
// step draw the same numbers, and on the JAX package's geometry the
// numbers of the JAX kernel. A thread loads its state into registers,
// runs k_steps steps, starting its quota of photons one after another, and
// writes the state back; a slot with no photon and no quota left stops.
// The flux path runs the refill schedule (record_kernel.RefillSchedule):
// as many slots as the card holds resident threads for the instantiation
// (col_kernel_occupancy: 4 blocks of 256 an SM at 64 registers, 135,168 on
// an H100), no more than the batch's photons, launches of 4,096 steps
// under the host's relaunch loop, where the JAX package ran 65,536 lanes
// and 128-step launches (a quarter of the card's threads and a host
// read-back every 128 steps). The column fields, interleaved as one
// (height, scale) float2 a column (128 KB at 16,384 columns), are read
// with one 8-byte __ldg and stay in L1/L2 (as two arrays the scale's load
// waited for the height's compare: a second dependent load on every step
// of a lone warp); the f32 scale replaces the TPU kernel's bf16 hi/lo
// reconstruction. The block table and the
// inverse-CDF row go to shared memory where that costs no blocks an SM
// (mcb::table_layout; the Landsat deck's 10,001-step row, 80 KB, would
// hold 2 blocks an SM and is read with __ldg: 6-14% faster on that deck's
// configuration than the row in shared memory). Flux up/down and
// column absorption (3 * nx * ny floats, 192 KB on the Landsat deck) go to
// global atomics over 16,384 addresses, which rarely collide; the z
// profile (nz <= 128 floats) accumulates in shared memory and is flushed
// once per block per launch; the optional 3D field goes to global
// atomics; the launch counters are int64 (2^18 slots x 8,192 steps reach
// 2^31 lane-steps). A radiance launch has 4,096 lanes and 128 steps (the
// JAX package's lane geometry, so its lanes carry JAX's photons; its event
// queue holds lanes x steps records) and runs 32-thread blocks to spread
// them over the SMs, its tables within kMaxTableSmem; its walk kernel is
// persistent, as many 256-thread blocks as fit the card, striding over the
// pairs direction-major (pair p is direction p / E of event p % E), so a
// warp takes 32 events of one direction: the direction is a shared-memory
// broadcast, the slopes are equal and the event reads coalesce. The
// directions go to shared memory; the (A, B) table and the forward row are
// read with __ldg (staging either in shared memory measured slower on this
// card: it takes the L1 the table's reads hit).
//
// What bounds it on this card: like the record kernel, the latency of the
// dependent per-step math (divisions, log1p, sqrt, sincos, the table or HG
// sampling), with 32 warps an SM in flight (registers hold it there: 64 a
// thread, with a few bytes spilled), and the global atomics of the
// tallies; at the end of a batch the longest slots' serial chains of
// steps; the walk, the dependent (A, B) load and IEEE divide of each
// iteration, on every thread slot of the card. Bytes and operations are
// both far below the card's rates. It does no matrix work, so tensor
// cores, wgmma and TMA have nothing to do here.
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
// Threads per block of a radiance launch (4,096 lanes over 128 SMs).
constexpr int kLeThreads = 32;
// Threads per block of the walk kernel.
constexpr int kWalkThreads = 256;
// Shared memory a radiance block may take for its tables.
constexpr size_t kMaxTableSmem = 96 * 1024;
// Directions per launch (local_estimate.MAX_KERNEL_DIRS).
constexpr int kMaxDirs = 64;
// Launch counters (col_kernel.N_COUNTS): started, lanes with work left,
// lane-steps with a live photon, local-estimate events, walks cut,
// atmospheric emission births.
constexpr int kCounts = 6;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kFourPi = 12.5663706143591729539f;
// Index-space nudge of the walk's first column and the exit pixel
// (pallas_col.py:771).
constexpr float kNde = 1e-4f;

// params[] slots (mcbrat3d_tpu_torch/transport/col_kernel.py C_*).
enum {
  C_BETA_MAX, C_ALBEDO, C_SMU, C_SUX, C_SUY, C_RR_W, C_HALF_RR, C_X0, C_LX,
  C_Y0, C_LY, C_Z0, C_LZ, C_SSA, C_G, C_INV_DX, C_INV_DY, C_INV_DZ, C_DZ,
  C_ZMAX, C_ZTOP, C_ZBOT, C_BXW, C_BYW, C_NUDGE, C_TWO_PI, C_QG, C_DXC,
  C_DYC, C_ZCL, C_ZETA, C_ATMS, N_PARAMS
};

// Source kinds (col_kernel.SOURCE_KINDS).
enum { SRC_DIRECTIONAL, SRC_RANDOM_AZIMUTH, SRC_FLUX, SRC_EMISSION };

// K3 draw sites (col_kernel.SITE_*).
enum : uint32_t {
  S_X = 0, S_Y = 1, S_SRC = 2, S_TAU = 3, S_COLLIDE = 4, S_ANGLE = 5,
  S_PHI = 6, S_ROULETTE = 7, S_SRC_PHI = 9, S_EM_SPLIT = 10, S_EM_BIN = 11,
  S_EM_ACCEPT = 12, S_EM_MU = 13, S_EM_ZOFF = 14, S_EM_PHI = 15,
  S_EM_LEVEL = 16, S_LE = 32
};

// The column emission's tables and the per-pixel albedo.
struct EmArgs {
  const float* prob;    // [nx * ny] alias acceptance probability
  const float* alias;   // [nx * ny] alias target column
  const float* halias;  // [nx * ny] the alias target's height (cells)
  const float* fcum;    // [nz] cumulative Planck table
  const float* albedo;  // [nx * ny] albedo per column, or null
  int lw;               // pre-credit the atmospheric births
};

__device__ __forceinline__ float table(const float* s, const float* g, int i,
                                       bool in_smem) {
  return in_smem ? s[i] : __ldg(g + i);
}

// Geometry and radiance inputs of the local estimate.
struct LeArgs {
  const float2* col_ab; // [nx * ny] CT intercept A = scale * (z0 + h dz)
                        // and slope B = scale
  const float* fwd_v0;  // forward row, uniform in s = sin(theta/2)
  const float* fwd_dd;  // its forward differences
  const float* qz;      // [nz] gas extinction
  const float* qcb;     // [nz] gas optical depth from level k's bottom up
  float* img;           // [n_dirs][nx * ny]
  int n_dirs, rr, fwd, n_s, k_walk, has_gas;
};

__device__ __forceinline__ int imod(int j, int n) {
  const int m = j % n;
  return m < 0 ? m + n : m;
}

// The local-estimate event queue: struct of arrays of cap records each.
// Floats: the event point, its weight and the incoming direction; ints: the
// lane and step counter that key the event's draws, and whether it is a
// reflection (col_kernel.QUEUE_FLOATS, QUEUE_INTS).
enum { QF_X, QF_Y, QF_Z, QF_W, QF_UX, QF_UY, QF_UZ, N_QF };
enum { QI_LANE, QI_CTR, QI_REFL, N_QI };
struct Queue {
  float* f;  // [N_QF][cap]
  int* i;    // [N_QI][cap]
  int* ctl;  // [events queued by this launch, the most any launch queued]
  int cap;
};

__device__ __forceinline__ void queue_event(const Queue& q, uint32_t lane,
                                            uint32_t ctr, bool refl,
                                            float sx, float sy, float sz,
                                            float w, float ux, float uy,
                                            float uz) {
  const int s = mcb::queue_slot(q.ctl);
  if (s >= q.cap) return;  // counted in the fill; the host raises
  const size_t c = static_cast<size_t>(q.cap);
  q.f[QF_X * c + s] = sx;
  q.f[QF_Y * c + s] = sy;
  q.f[QF_Z * c + s] = sz;
  q.f[QF_W * c + s] = w;
  q.f[QF_UX * c + s] = ux;
  q.f[QF_UY * c + s] = uy;
  q.f[QF_UZ * c + s] = uz;
  q.i[QI_LANE * c + s] = static_cast<int>(lane);
  q.i[QI_CTR * c + s] = static_cast<int>(ctr);
  q.i[QI_REFL * c + s] = refl ? 1 : 0;
}

// The local estimate of one event toward direction d of s_dirs
// (pallas_col.py:760-958): a reflection (refl, Lambertian 1/pi) or a real
// collision with incoming direction (ux, uy, uz), at (sx, sy, sz) with
// weight w_ev, drawing at the event's lane ul and step ctr. Adds the walk
// iterations to walk and a cut walk to cut. The forward row and the
// (A, B) table are read with __ldg.
__device__ __forceinline__ void le_pair(
    const LeArgs& le, const float* s_dirs,
    const float* prm, int d, uint32_t ul, uint32_t seed, uint32_t ctr,
    bool refl, float sx, float sy, float sz, float w_ev, float ux, float uy,
    float uz, int nx, int ny, int nz, unsigned long long& walk, int& cut) {
  const float x0 = prm[C_X0], y0 = prm[C_Y0], z0 = prm[C_Z0];
  const float z_max = prm[C_ZMAX], inv_dx = prm[C_INV_DX];
  const float inv_dy = prm[C_INV_DY], inv_dz = prm[C_INV_DZ];
  const float dz = prm[C_DZ], dxc = prm[C_DXC], dyc = prm[C_DYC];
  const float zcl = prm[C_ZCL], zeta = prm[C_ZETA], g = prm[C_G];
  const int nxy = nx * ny;
  const float ddx = s_dirs[d], ddy = s_dirs[kMaxDirs + d];
  const float ddz = s_dirs[2 * kMaxDirs + d];
  const bool fast_x = s_dirs[3 * kMaxDirs + d] != 0.f;
  // ---- phase value ----
  float npf;
  if (refl) {
    npf = kInvPi;
  } else {
    const float cosb = (ux * ddx + uy * ddy) + uz * ddz;
    float pv;
    if (le.fwd) {
      const float s_v = sqrtf(fmaxf((1.f - cosb) * 0.5f, 0.f));
      const float tpos = s_v * static_cast<float>(le.n_s - 1);
      int k = static_cast<int>(tpos);
      k = k < 0 ? 0 : (k > le.n_s - 2 ? le.n_s - 2 : k);
      const float frac = tpos - static_cast<float>(k);
      pv = __ldg(le.fwd_v0 + k) + frac * __ldg(le.fwd_dd + k);
    } else {
      const float q = fmaxf((1.f + g * g) - (2.f * g) * cosb, 1e-12f);
      pv = (1.f - g * g) / (q * sqrtf(q));
    }
    npf = pv / (kFourPi * ddz);
  }
  // ---- Iwabuchi roulette thresholds ----
  float u_i1 = 0.f, tau_free = 0.f, npf_pi = 0.f, tau_max = 0.f;
  bool small = false;
  if (le.rr) {
    const uint32_t site = S_LE + 2u * static_cast<uint32_t>(d);
    u_i1 = uniform(ul, seed, ctr, site);
    tau_free = -log1pf(-uniform(ul, seed, ctr, site + 1u));
    npf_pi = kPi * npf;
    small = npf_pi <= zeta;
    tau_max = -logf(zeta / fmaxf(npf_pi, kTiny));
  }
  // ---- column walk to the top (or past the highest cloud top) ----
  const float t_top = (z_max - sz) / ddz;
  const float t_stop = fminf(fmaxf((zcl - sz) / ddz, 0.f), t_top);
  // the first column (pallas_col.py:837-876): on the fast axis the cell
  // the ray enters at a face, on the slow axis the cell after a nudge of
  // 1e-4 cells along the direction (a zero component counts as positive)
  const float fx = (sx - x0) * inv_dx, fy = (sy - y0) * inv_dy;
  const int up_x = ddx >= 0.f ? 1 : 0, up_y = ddy >= 0.f ? 1 : 0;
  const float jxf = fast_x ? (up_x ? floorf(fx) : ceilf(fx) - 1.f)
                           : floorf(fx + (up_x ? kNde : -kNde));
  const float jyf = fast_x ? floorf(fy + (up_y ? kNde : -kNde))
                           : (up_y ? floorf(fy) : ceilf(fy) - 1.f);
  int jx = static_cast<int>(jxf), jy = static_cast<int>(jyf);
  const bool live_x = fabsf(ddx) > 1e-12f, live_y = fabsf(ddy) > 1e-12f;
  float tx = live_x ? ((static_cast<float>(jx + up_x) * dxc + x0) - sx) / ddx
                    : kBig;
  float ty = live_y ? ((static_cast<float>(jy + up_y) * dyc + y0) - sy) / ddy
                    : kBig;
  float t = 0.f, tau_cl = 0.f;
  bool done = false;
  int it = 0;
  // the column, wrapped periodically as the unwrapped jx, jy step
  int cx = imod(jx, nx), cy = imod(jy, ny);
  while (it < le.k_walk) {
    const float tn = fminf(fminf(tx, ty), t_stop);
    const int c = cx * ny + cy;
    const float2 a_b = __ldg(le.col_ab + c);
    tau_cl = tau_cl + (fmaxf(a_b.x - a_b.y * (sz + ddz * t), 0.f) -
                       fmaxf(a_b.x - a_b.y * (sz + ddz * tn), 0.f));
    ++it;
    if (tn >= t_stop) {
      done = true;
      break;
    }
    if (tx <= ty) {
      jx += 2 * up_x - 1;
      cx = up_x ? (cx + 1 == nx ? 0 : cx + 1) : (cx == 0 ? nx - 1 : cx - 1);
      tx = ((static_cast<float>(jx + up_x) * dxc + x0) - sx) / ddx;
    } else {
      jy += 2 * up_y - 1;
      cy = up_y ? (cy + 1 == ny ? 0 : cy + 1) : (cy == 0 ? ny - 1 : cy - 1);
      ty = ((static_cast<float>(jy + up_y) * dyc + y0) - sy) / ddy;
    }
    t = tn;
  }
  walk += static_cast<unsigned long long>(it);
  if (!done) {
    ++cut;
    return;
  }
  float tau_f = tau_cl / ddz;
  if (le.has_gas) {  // closed form from the cumulative profile
    const int kz = clampi(static_cast<int>((sz - z0) * inv_dz), nz - 1);
    const float z_bot = z0 + static_cast<float>(kz) * dz;
    tau_f = tau_f + (__ldg(le.qcb + kz) - __ldg(le.qz + kz) * (sz - z_bot)) /
                        ddz;
  }
  // ---- contribution and the TOA exit pixel ----
  float contrib;
  if (le.rr) {
    const float w_rrc = (w_ev * zeta) * kInvPi;
    const float c_a =
        (tau_f < tau_free && u_i1 * zeta <= npf_pi) ? w_rrc : 0.f;
    const float c_b = tau_f < tau_max ? (w_ev * npf) * expf(-tau_f)
                      : (tau_f - tau_max < tau_free ? w_rrc : 0.f);
    contrib = small ? c_a : c_b;
  } else {
    contrib = (w_ev * npf) * expf(-tau_f);
  }
  if (contrib != 0.f) {
    const float exf_x = wrap(((sx + ddx * t_top) - x0) * inv_dx +
                                 signf(ddx) * kNde,
                             static_cast<float>(nx));
    const float exf_y = wrap(((sy + ddy * t_top) - y0) * inv_dy +
                                 signf(ddy) * kNde,
                             static_cast<float>(ny));
    const int ex_col = clampi(static_cast<int>(exf_x), nx - 1) * ny +
                       clampi(static_cast<int>(exf_y), ny - 1);
    atomicAdd(&le.img[d * nxy + ex_col], contrib);
  }
}

template <bool MACRO, bool ANALYTIC, bool VOL, bool RR, bool LE>
__global__ void __launch_bounds__(kThreads)
col_steps(const float* __restrict__ prm,
          const float2* __restrict__ col_hs,
          const float* __restrict__ g_blk,
          const float* __restrict__ g_inv_a0,
          const float* __restrict__ g_inv_dd,
          float* __restrict__ xs, float* __restrict__ ys,
          float* __restrict__ zs, float* __restrict__ uxs,
          float* __restrict__ uys, float* __restrict__ uzs,
          float* __restrict__ ws, float* __restrict__ blss,
          float* __restrict__ blhs, int* __restrict__ quotas,
          int* __restrict__ alives, float* __restrict__ acc,
          unsigned long long* __restrict__ counts, Queue q, LeArgs le,
          EmArgs em,
          int n_lanes, int nx, int ny, int nz, int mf, int nby, int n_blk,
          int inv_n, int blk_smem, int inv_smem, uint32_t seed,
          uint32_t step0, int k_steps, int src) {
  extern __shared__ float smem[];
  __shared__ int s_counts[kCounts];
  const bool emission = src == SRC_EMISSION;
  const int n_prof = em.lw ? 2 * nz : nz;
  float* s_prof = smem;                       // [nz] (+ [nz] pre-credits)
  float* s_pre = s_prof + nz;                 // with lw
  float* s_fcum = s_prof + n_prof;            // [nz] with emission
  float* s_blk = s_fcum + (emission ? nz : 0);            // [2 * n_blk]
  float* s_a0 = s_blk + (blk_smem ? 2 * n_blk : 0);      // [inv_n]
  float* s_dd = s_a0 + (inv_smem ? inv_n : 0);           // [inv_n]
  for (int i = threadIdx.x; i < n_prof; i += blockDim.x) s_prof[i] = 0.f;
  if (emission) {
    for (int i = threadIdx.x; i < nz; i += blockDim.x) s_fcum[i] = em.fcum[i];
  }
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
  for (int i = threadIdx.x; i < kCounts; i += blockDim.x) s_counts[i] = 0;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n_lanes) {
    const float beta_max = prm[C_BETA_MAX], albedo = prm[C_ALBEDO];
    const float smu = prm[C_SMU], sux = prm[C_SUX], suy = prm[C_SUY];
    const float rr_w = prm[C_RR_W], half_rr = prm[C_HALF_RR];
    const float x0 = prm[C_X0], lx = prm[C_LX], y0 = prm[C_Y0];
    const float ly = prm[C_LY], z0 = prm[C_Z0];
    const float ssa = prm[C_SSA], g = prm[C_G], qg = prm[C_QG];
    const float inv_dx = prm[C_INV_DX], inv_dy = prm[C_INV_DY];
    const float inv_dz = prm[C_INV_DZ], dz = prm[C_DZ];
    const float z_max = prm[C_ZMAX], z_top = prm[C_ZTOP];
    const float z_bot = prm[C_ZBOT], bx_w = prm[C_BXW], by_w = prm[C_BYW];
    const float nudge = prm[C_NUDGE], two_pi = prm[C_TWO_PI];
    const float dxc = prm[C_DXC], dyc = prm[C_DYC], atms = prm[C_ATMS];
    const float nzf = static_cast<float>(nz);
    const int nxy = nx * ny;
    const bool has_gas = le.has_gas != 0;
    float* acc_vol = acc + 3 * nxy + nz;  // 3D field, [col][level]

    float x = xs[lane], y = ys[lane], z = zs[lane];
    float ux = uxs[lane], uy = uys[lane], uz = uzs[lane];
    float w = ws[lane], bls = blss[lane], blh = blhs[lane];
    int quota = quotas[lane];
    bool alive = alives[lane] > 0;
    int started = 0, steps = 0, events = 0, atm_births = 0;
    const uint32_t ul = static_cast<uint32_t>(lane);

    for (int k = 0; k < k_steps; ++k) {
      // a lane with no photon and no quota has no work left this launch
      if (!alive && quota <= 0) break;
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      // ---- refill a dead lane from the source ----
      if (!alive) {
        const float u0 = uniform(ul, seed, ctr, S_X);
        const float u1 = uniform(ul, seed, ctr, S_Y);
        if (emission) {
          const float u_mu = uniform(ul, seed, ctr, S_EM_MU);
          float s_mu;
          if (uniform(ul, seed, ctr, S_EM_SPLIT) < atms) {
            // the column: a Walker alias draw over the nx * ny columns
            int jbin = static_cast<int>(uniform(ul, seed, ctr, S_EM_BIN) *
                                        static_cast<float>(nxy));
            jbin = jbin > nxy - 1 ? nxy - 1 : jbin;
            int col_b = jbin;
            float h_b;
            if (uniform(ul, seed, ctr, S_EM_ACCEPT) >= __ldg(em.prob + jbin)) {
              col_b = static_cast<int>(__ldg(em.alias + jbin) + 0.5f);
              h_b = __ldg(em.halias + jbin);
            } else {
              h_b = __ldg(col_hs + jbin).x;
            }
            // the level: the count of fcum entries <= u * fcum[h - 1]
            const float target = uniform(ul, seed, ctr, S_EM_LEVEL) *
                                 s_fcum[clampi(static_cast<int>(h_b) - 1,
                                               nz - 1)];
            int lo = 0, hi = nz;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (s_fcum[mid] <= target) {
                lo = mid + 1;
              } else {
                hi = mid;
              }
            }
            x = x0 + (static_cast<float>(col_b / ny) + u0) * dxc;
            y = y0 + (static_cast<float>(col_b % ny) + u1) * dyc;
            z = fminf(fmaxf(z0 + (static_cast<float>(lo) +
                                  uniform(ul, seed, ctr, S_EM_ZOFF)) * dz,
                            z_bot),
                      z_top);
            s_mu = 1.f - 2.f * u_mu;
            if (fabsf(s_mu) < 1e-4f) s_mu = signf(s_mu + kTiny) * 1e-4f;
            atm_births += 1;
            if (em.lw) {  // -1 at the birth's column, level and cell (a
                          // count of nz is the top level, where z is
                          // clamped)
              const int lvl = lo < nz ? lo : nz - 1;
              atomicAdd(&acc[2 * nxy + col_b], -1.f);
              atomicAdd(&s_pre[lvl], -1.f);
              if (VOL) atomicAdd(&acc_vol[col_b * nz + lvl], -1.f);
            }
          } else {
            x = x0 + u0 * lx;
            y = y0 + u1 * ly;
            z = z_bot;
            s_mu = sqrtf(fmaxf(u_mu, 1e-12f));
          }
          const float s_phi = two_pi * uniform(ul, seed, ctr, S_EM_PHI);
          const float s_sin = sqrtf(fmaxf(0.f, 1.f - s_mu * s_mu));
          ux = s_sin * cosf(s_phi);
          uy = s_sin * sinf(s_phi);
          uz = s_mu;
        } else {
          x = x0 + u0 * lx;
          y = y0 + u1 * ly;
          z = z_top;
          if (src == SRC_DIRECTIONAL) {
            ux = sux;
            uy = suy;
            uz = -smu;
          } else {
            float s_mu, s_phi;
            if (src == SRC_RANDOM_AZIMUTH) {
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
      // with gas everywhere the region above the plane samples against
      // the gas maximum instead of advancing geometrically
      float ceiling = has_gas ? (above ? qg : bls + qg) : (above ? 0.f : bls);
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
          const float w_refl =
              w * (em.albedo != nullptr ? __ldg(em.albedo + col_e) : albedo);
          x = xe;
          y = ye;
          z = z_bot;
          bls = beta_max;  // reflected photons restart with the global
          blh = nzf;       // ceiling
          if (w_refl <= kTiny) {
            alive = false;
          } else {
            if constexpr (LE) {  // queue the reflection's local estimate
              events += 1;
              queue_event(q, ul, ctr, true, xe, ye, z_bot, w_refl, ux, uy,
                          uz);
            }
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

      // ---- column gather (+ the gas at the level); null-collision test
      // against the ceiling the jump sampled with ----
      // one 8-byte load of the column's (height, scale): the scale does
      // not wait for the height's compare
      const float2 hs = __ldg(col_hs + col);
      const float beta_c = static_cast<float>(iz) < hs.x ? hs.y : 0.f;
      const float beta = has_gas ? beta_c + __ldg(le.qz + iz) : beta_c;
      if (!(uniform(ul, seed, ctr, S_COLLIDE) * ceiling < beta)) continue;

      // ---- real collision: absorption weight, tallies, roulette ----
      // (the gas absorbs only: the cell scatters beta_c * ssa of beta)
      const float ssa_eff =
          has_gas ? (beta > 0.f ? (beta_c * ssa) / beta : 0.f) : ssa;
      const float absorbed = w * (1.f - ssa_eff);
      w = w * ssa_eff;
      if (absorbed != 0.f) {
        atomicAdd(&acc[2 * nxy + col], absorbed);
        atomicAdd(&s_prof[iz], absorbed);
        if (VOL) atomicAdd(&acc_vol[col * nz + iz], absorbed);
      }
      if constexpr (LE) {  // post-absorption, pre-roulette weight
        events += 1;
        queue_event(q, ul, ctr, false, xc, yc, zc, w, ux, uy, uz);
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
    if (events) atomicAdd(&s_counts[3], events);
    if (atm_births) atomicAdd(&s_counts[5], atm_births);
  }
  __syncthreads();
  // the profile, then with lw its pre-credit row after the 3D field
  float* acc_prof = acc + 3 * nx * ny;
  float* acc_pre = acc_prof + nz + (VOL ? nx * ny * nz : 0);
  for (int i = threadIdx.x; i < n_prof; i += blockDim.x) {
    const float v = s_prof[i];
    if (v != 0.f) atomicAdd(i < nz ? &acc_prof[i] : &acc_pre[i - nz], v);
  }
  for (int i = threadIdx.x; i < kCounts; i += blockDim.x) {
    if (s_counts[i]) {
      atomicAdd(&counts[i], static_cast<unsigned long long>(s_counts[i]));
    }
  }
}

// The local estimate of every (event, direction) pair of the queue, one
// thread each, striding direction-major over the pairs (pair p: direction
// p / E of event p % E, E the events queued). A block with no pair returns
// before it stages the directions. Adds the walk iterations into walk[0]
// and the cut walks into counts[4], one atomic per block each, and records
// the largest fill in ctl[1].
__global__ void __launch_bounds__(kWalkThreads)
col_walk(const float* __restrict__ prm, Queue q,
         const float* __restrict__ dirs, LeArgs le,
         unsigned long long* __restrict__ counts,
         unsigned long long* __restrict__ g_walk, int nx, int ny, int nz,
         uint32_t seed) {
  __shared__ float s_dirs[4 * kMaxDirs];
  __shared__ unsigned long long s_walk;
  __shared__ int s_cut;
  const int fill = q.ctl[0];
  const unsigned n_ev = static_cast<unsigned>(fill < q.cap ? fill : q.cap);
  const unsigned n_pairs = n_ev * static_cast<unsigned>(le.n_dirs);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicMax(&q.ctl[1], fill);
  const unsigned first = blockIdx.x * blockDim.x;
  if (first >= n_pairs) return;
  for (int i = threadIdx.x; i < 4 * le.n_dirs; i += blockDim.x) {
    s_dirs[(i / le.n_dirs) * kMaxDirs + i % le.n_dirs] = dirs[i];
  }
  if (threadIdx.x == 0) {
    s_walk = 0;
    s_cut = 0;
  }
  __syncthreads();
  unsigned long long walk = 0;
  int cut = 0;
  const size_t c = static_cast<size_t>(q.cap);
  for (unsigned p = first + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    const unsigned d = p / n_ev, e = p - d * n_ev;
    le_pair(le, s_dirs, prm, static_cast<int>(d),
            static_cast<uint32_t>(q.i[QI_LANE * c + e]), seed,
            static_cast<uint32_t>(q.i[QI_CTR * c + e]),
            q.i[QI_REFL * c + e] != 0, q.f[QF_X * c + e], q.f[QF_Y * c + e],
            q.f[QF_Z * c + e], q.f[QF_W * c + e], q.f[QF_UX * c + e],
            q.f[QF_UY * c + e], q.f[QF_UZ * c + e], nx, ny, nz, walk, cut);
  }
  walk = mcb::warp_sum(walk);
  cut = mcb::warp_sum(cut);
  if ((threadIdx.x & 31u) == 0) {
    if (walk) atomicAdd(&s_walk, walk);
    if (cut) atomicAdd(&s_cut, cut);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_walk) atomicAdd(g_walk, s_walk);
    if (s_cut) {
      atomicAdd(&counts[4], static_cast<unsigned long long>(s_cut));
    }
  }
}

struct Args {
  const float* prm;
  const float2* col_hs;
  const float *blk, *inv_a0, *inv_dd;
  float *x, *y, *z, *ux, *uy, *uz, *w, *bls, *blh;
  int *quota, *alive;
  float* acc;
  unsigned long long* counts;
  Queue q;
  LeArgs le;
  EmArgs em;
  int n_lanes, nx, ny, nz, mf, nby, n_blk, inv_n;
  uint32_t seed, step0;
  int k_steps, src;
  int* occ = nullptr;  // set: fill this occupancy record, do not launch
};

template <bool MACRO, bool ANALYTIC, bool VOL, bool RR, bool LE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = col_steps<MACRO, ANALYTIC, VOL, RR, LE>;
  const int threads = LE ? kLeThreads : kThreads;
  // the profile (and with lw its pre-credit row), with emission the
  // cumulative Planck table, then the block table and the inverse-CDF row
  // where mcb::table_layout puts them (else the kernel reads them with
  // __ldg); a radiance launch (a few blocks an SM) keeps them within
  // kMaxTableSmem
  const size_t base = static_cast<size_t>(a.nz) * sizeof(float) *
                      ((a.em.lw ? 2 : 1) + (a.src == SRC_EMISSION ? 1 : 0));
  const size_t bytes[2] = {
      MACRO ? 2 * static_cast<size_t>(a.n_blk) * sizeof(float) : 0,
      ANALYTIC ? 0 : 2 * static_cast<size_t>(a.inv_n) * sizeof(float)};
  const long budget = LE ? static_cast<long>(kMaxTableSmem) : -1;
  size_t smem = 0;
  int in_smem[2] = {0, 0};
  const cudaError_t e =
      mcb::table_layout(kernel, threads, base, bytes, budget, &smem, in_smem);
  if (e != cudaSuccess) return e;
  const int blk_smem = in_smem[0], inv_smem = in_smem[1];
  if (a.occ != nullptr) {
    return mcb::occupancy_record(kernel, threads, smem, a.occ);
  }
  const int blocks = (a.n_lanes + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      a.prm, a.col_hs, a.blk, a.inv_a0, a.inv_dd, a.x, a.y,
      a.z, a.ux, a.uy, a.uz, a.w, a.bls, a.blh, a.quota, a.alive, a.acc,
      a.counts, a.q, a.le, a.em, a.n_lanes, a.nx, a.ny, a.nz, a.mf,
      a.nby, a.n_blk, a.inv_n, blk_smem, inv_smem, a.seed, a.step0,
      a.k_steps, a.src);
  return cudaGetLastError();
}

template <bool MACRO, bool ANALYTIC, bool VOL, bool RR>
cudaError_t launch_le(const Args& a, cudaStream_t s) {
  return a.le.n_dirs > 0 ? launch<MACRO, ANALYTIC, VOL, RR, true>(a, s)
                         : launch<MACRO, ANALYTIC, VOL, RR, false>(a, s);
}

template <bool MACRO, bool ANALYTIC, bool VOL>
cudaError_t launch_rr(const Args& a, int rr, cudaStream_t s) {
  return rr ? launch_le<MACRO, ANALYTIC, VOL, true>(a, s)
            : launch_le<MACRO, ANALYTIC, VOL, false>(a, s);
}

template <bool MACRO, bool ANALYTIC>
cudaError_t launch_vol(const Args& a, int vol, int rr, cudaStream_t s) {
  return vol ? launch_rr<MACRO, ANALYTIC, true>(a, rr, s)
             : launch_rr<MACRO, ANALYTIC, false>(a, rr, s);
}

template <bool MACRO>
cudaError_t launch_hg(const Args& a, int analytic, int vol, int rr,
                      cudaStream_t s) {
  return analytic ? launch_vol<MACRO, true>(a, vol, rr, s)
                  : launch_vol<MACRO, false>(a, vol, rr, s);
}

}  // namespace

extern "C" int col_kernel_num_params() { return N_PARAMS; }

// Advance every lane by k_steps transport steps, reading the column template
// from col_hs ([nx * ny] (height, scale) float2). Adds the tallies into acc
// ([up nxy | down nxy | absorbed nxy | profile nz | 3D field nxy * nz with
// vol | the profile's pre-credits nz with lw]), the photons started into
// counts[0], the lanes with work left (alive or quota > 0) into counts[1],
// the lane-steps run with a live photon into counts[2], the local-estimate
// events into counts[3] and the atmospheric emission births into counts[5].
// With n_dirs > 0 every event is queued into the struct-of-arrays queue
// (qf [N_QF][cap], qi [N_QI][cap]) after its fill qctl[0] is set to 0;
// col_walk_launch then computes the estimates. Source kind (SRC_*), gas,
// the emission's pre-credits (lw, emission only) and the per-pixel albedo
// (has_px: one albedo per column in albedo[]) are launch arguments. The
// counters are int64 (a launch of 2^18 lanes x 8,192 steps reaches 2^31
// lane-steps); a lane with no photon and no quota stops stepping. The
// block table and the inverse-CDF row go to shared memory where that
// costs no blocks an SM (a radiance launch: within kMaxTableSmem).
// Returns cudaGetLastError().
extern "C" int col_kernel_launch(
    const float* prm, const float* col_hs, const float* blk,
    const float* inv_a0, const float* inv_dd, float* x, float* y, float* z,
    float* ux, float* uy, float* uz, float* w, float* bls, float* blh,
    int* quota, int* alive, float* acc, unsigned long long* counts,
    const float* qz, float* qf, int* qi, int* qctl, const float* em_prob,
    const float* em_alias, const float* em_halias, const float* em_fcum,
    const float* albedo, int n_lanes, int nx, int ny, int nz,
    int macro_factor, int nby, int n_blk, int inv_n, int n_acc,
    uint32_t seed, uint32_t step0, int k_steps, int analytic, int vol,
    int use_rr, int source_kind, int has_gas, int n_dirs, int cap, int lw,
    int has_px, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nxy = static_cast<long long>(nx) * ny;
  const long long want = 3 * nxy + nz + (vol ? nxy * nz : 0) + (lw ? nz : 0);
  if (n_acc != want || nz > 128 || (macro_factor > 0 && n_blk <= 0) ||
      (!analytic && inv_n < 2) || source_kind < SRC_DIRECTIONAL ||
      source_kind > SRC_EMISSION || (lw && source_kind != SRC_EMISSION) ||
      n_dirs < 0 || n_dirs > kMaxDirs || (n_dirs > 0 && cap <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_dirs > 0) {
    const cudaError_t e = cudaMemsetAsync(qctl, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  LeArgs le{};
  le.qz = qz;
  le.n_dirs = n_dirs;
  le.has_gas = has_gas;
  const EmArgs em{em_prob, em_alias, em_halias, em_fcum,
                  has_px ? albedo : nullptr, lw};
  const Args a{prm,   reinterpret_cast<const float2*>(col_hs), blk,
               inv_a0, inv_dd,   x,     y,     z,     ux,    uy,    uz,
               w,     bls,       blh,   quota, alive, acc,   counts,
               Queue{qf, qi, qctl, cap},        le,    em,    n_lanes,
               nx,    ny,        nz,    macro_factor, nby,  n_blk,
               inv_n, seed,      step0, k_steps,      source_kind};
  const cudaError_t e =
      macro_factor > 0 ? launch_hg<true>(a, analytic, vol, use_rr, s)
                       : launch_hg<false>(a, analytic, vol, use_rr, s);
  return static_cast<int>(e);
}

// The occupancy record (mcb::OCC_*) of the transport kernel's instantiation
// and shared-memory layout that col_kernel_launch would take for these
// arguments, on the current card. Returns 0 or the CUDA error.
extern "C" int col_kernel_occupancy(int nz, int macro_factor, int n_blk,
                                    int inv_n, int analytic, int vol,
                                    int use_rr, int source_kind, int n_dirs,
                                    int lw, int* out) {
  if (nz < 1 || nz > 128 || (macro_factor > 0 && n_blk <= 0) ||
      (!analytic && inv_n < 2) || source_kind < SRC_DIRECTIONAL ||
      source_kind > SRC_EMISSION || n_dirs < 0 || n_dirs > kMaxDirs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeArgs le{};
  le.n_dirs = n_dirs;
  Args a{};
  a.le = le;
  a.em.lw = lw;
  a.nz = nz;
  a.n_blk = n_blk;
  a.inv_n = inv_n;
  a.src = source_kind;
  a.occ = out;
  const cudaError_t e =
      macro_factor > 0 ? launch_hg<true>(a, analytic, vol, use_rr, nullptr)
                       : launch_hg<false>(a, analytic, vol, use_rr, nullptr);
  return static_cast<int>(e);
}

// The local estimates of the events col_kernel_launch queued (qf, qi, qctl
// of capacity cap): every (event, direction) pair toward the n_dirs
// directions of dirs ([4][n_dirs]: cosines in march order, then 1 where x
// is the fast axis), adding the image into img ([n_dirs][nxy]), the walks
// cut by k_walk into counts[4] and the walk iterations into walk[0],
// reading the (A, B) table col_ab ([nxy] float2). Roulette of the estimate
// (le_rr), the forward row (le_fwd, n_s points) and the gas term are launch
// arguments. Returns cudaGetLastError().
extern "C" int col_walk_launch(
    const float* prm, float* qf, int* qi, int* qctl, int cap,
    const float* dirs, const float* col_ab, const float* fwd_v0,
    const float* fwd_dd, const float* qz, const float* qcb, float* img,
    unsigned long long* counts, unsigned long long* walk, int nx, int ny,
    int nz,
    uint32_t seed, int n_dirs, int le_rr, int le_fwd, int n_s, int k_walk,
    int has_gas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dirs < 1 || n_dirs > kMaxDirs || cap <= 0 || k_walk <= 0 ||
      (le_fwd && n_s < 2) || nz > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LeArgs le{reinterpret_cast<const float2*>(col_ab), fwd_v0, fwd_dd,
                  qz, qcb, img, n_dirs, le_rr, le_fwd, n_s, k_walk, has_gas};
  const Queue q{qf, qi, qctl, cap};
  int blocks = 0;
  const cudaError_t e =
      mcb::persistent_blocks(col_walk, kWalkThreads, 0, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  col_walk<<<blocks, kWalkThreads, 0, s>>>(prm, q, dirs, le, counts, walk,
                                           nx, ny, nz, seed);
  return static_cast<int>(cudaGetLastError());
}
