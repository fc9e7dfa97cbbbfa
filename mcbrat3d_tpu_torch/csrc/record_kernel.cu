// Record kernel for NVIDIA Hopper (sm_90a): flux path and radiance by local
// estimation (the transport queues its events, record_walk estimates them).
//
// Replaces: mcbrat3d_tpu/transport/pallas_kernel.py `_build_kernel`, flux
// path (refill from the directional, random-azimuth, flux or spotlight
// source, or the BBEmission refill through a per-voxel Walker alias table
// with the lw_mode pre-credits, :897-987 and :2189-2213; Woodcock jump
// against the optional two-level macro majorant,
// record fetch with the component choice of 2-3 component domains,
// null-collision test, Russian roulette, HG or inverse-CDF scatter +
// rotation, reflection off a uniform Lambertian or RPV surface or a
// per-pixel Lambertian albedo grid, :1436-1498, fused flux / absorption
// tally), as launched by `_make_launch`; and its local
// estimation section (`_build_kernel` :1515-2115, configured by
// `run_batch_pallas_tallies` :3278-3325): at every real scatter and every
// surface reflection, for each radiance direction, the phase value (HG or
// a forward table uniform in sin(theta/2)), one cell DDA march to the
// domain top with the periodic x/y wrap, the exact or Iwabuchi roulette
// estimator, optional contribution capping, and the tally at the exit
// column.
//
// Design. One thread per photon slot; lane = blockIdx.x * 128 + threadIdx.x
// keys the counter-based uniforms (the murmur3 mixer keyed by (lane,
// step * 256 + site, seed)) as the TPU kernel's row * 128 + lane does, so
// the kernel and the plain PyTorch step draw the same numbers, and on the
// JAX package's geometry the numbers of the JAX kernel. A thread loads its
// SoA state into registers, runs `k_steps` transport steps, starting its
// quota of photons one after another, and writes the state back; a slot
// with no photon and no quota left stops. The flux path runs the refill
// schedule (record_kernel.RefillSchedule): as many slots as the card holds
// resident threads for the instantiation (record_kernel_occupancy), no
// more than the batch's photons, launches of 4,096 steps under the host's
// relaunch loop, where the JAX package ran 65,536 lanes (a quarter of the
// card's threads) and 128-step launches with a host read-back after each;
// the launch counters are int64 (2^18 slots x 8,192 steps reach 2^31
// lane-steps). A radiance launch keeps the JAX package's geometry (at most
// 4,096 lanes, 128 steps: its event queue holds lanes x steps records).
// The record table ([n_cells, stride] f32) and the
// inverse-CDF angle table are read with per-thread loads through L1/L2
// (the step cloud's 1,024 x 6 floats stay cached). A domain of 2-3
// components has 8-float records [beta, majorant, ssa_eff, cs_0, cs_1,
// f2_0, f2_1, f2_2] (domain.multi_component_records), 32-byte rows read as
// two float4 loads; one uniform against the cumulative scattering
// fractions picks the component whose f2 (HG g or table row) scatters.
// The source kind, the component count, lw and the surface kind are launch
// arguments, uniform across a launch, so their branches never diverge.
//
// Surfaces (surf, SURF_*). A uniform Lambertian surface multiplies the
// weight by the albedo. A per-pixel Lambertian grid that tiles whole
// columns is an albedo per domain column (at most 4,096 floats), read per
// thread with __ldg at the column where the photon reaches the surface:
// where the TPU kernel packed it in [rows, 128] lanes and picked a row
// with a chain of selects. A uniform Rahman-Pinty-Verstraete surface
// multiplies the weight by the BRDF at the incoming direction and the
// sampled outgoing one, in the TPU kernel's trig-free form (cos(dphi)
// from the direction components, tan(acos(mu)) = sqrt(1 - mu^2) / mu):
// five sqrtf, five IEEE divides, a logf and an expf more per reflection.
//
// Emission (src = SRC_EMISSION). A refilled lane draws the atmosphere or
// the surface (one uniform against fracAtmsPower), a bin of the Walker
// alias pair over every voxel and its acceptance: two per-thread __ldg
// loads of em_prob[bin] and em_alias[bin] from global memory (196 KB at
// 24,576 cells; the shared budget stays with the tallies), where the TPU
// kernel gathered a transposed table and split it in bf16 hi/lo rows.
// The cell is decomposed with integer divides (the JAX kernel's floored
// float divides give the same cell on every cell of the envelope). With
// lw, an atmospheric birth adds -1 to the volume tally at its cell (the
// lane's second tally in that step; the TPU kernel's one-hot sublane
// contraction). With lw and radiance, a newly emitted lane only
// contributes its emission local estimate (weight 1, isotropic 1/(4 pi
// mu_d) or Lambertian 1/pi) in its birth step and moves from the next step
// on; on the flux path it moves in its birth step.
//
// Tallies accumulate in shared memory with shared atomics and are flushed
// once per block per launch with global atomics: the whole tally [up nxy |
// down nxy | absorbed nxy, or nx ny nz with the 3D tally (VOL)], unless a
// block's copy of a 3D tally would cost blocks an SM (the launcher asks
// the occupancy query). Then (vol_global) only the 2 nx ny flux columns
// stay in shared memory and the absorbed part (up to 147 KB inside the
// 36,864-cell envelope) is added straight into the global tally with
// float32 atomics, which the compiler emits as reductions into L2, where
// it stays: a 104-147 KB copy holds one or two 128-thread blocks an SM and
// has each block zero and flush every cell. A small 3D tally stays in
// shared memory: on a few thousand cells the global atomics of 65,536
// lanes contend (three times slower on the 1,024-cell step cloud). The TPU
// workarounds (one-hot MXU gathers and tallies, bf16 hi/lo splits, [*,
// 128] lane blocks) are not carried over.
//
// What bounds it on this card: the latency of the dependent per-step math
// (divisions, log1p, sqrt, sincos) and of the record gathers, with the
// card's resident warps in flight (registers hold them there), plus atomic
// contention on hot tally entries; at the end of a batch the slowest
// slots' serial chains of steps. It does no matrix work and streams no
// large tiles, so wgmma and TMA do not apply.
//
// Radiance (template flag LE), in two kernels. The transport kernel's LE
// instantiation queues every event instead of estimating it: a scatter, a
// surface reflection or, with lw, a birth held for its emission estimate (a
// step makes one of these at most). A record holds what the estimate reads:
// the event point and weight, the incoming direction and the phase field f2
// (HG g or the table row) of a scatter, its kind (EV_*), its capped-excess
// slot, and the lane and step counter that key its draws; it goes into
// struct-of-arrays buffers at a slot taken with one atomicAdd per warp.
// record_walk then computes every (event, direction) pair of the launch, one
// thread each, over the whole card: the phase value, the Iwabuchi roulette
// draws at sites 16 + 2d and 17 + 2d of the event's lane and step, and a
// cell march to the top in a loop that ends when the ray leaves the top (the
// TPU kernel's column formulations and static per-direction bounds were
// Mosaic cost-model choices; a per-thread early exit does their job). The
// march reads the extinction alone, from a contiguous beta[n_cells] (4 of
// the record's 24-32 bytes), read with __ldg (the step cloud's 4 KB staged
// in shared memory measured 1-3% faster a walk on this card: not worth a
// second code path). The march is still bounded (k_dda,
// local_estimate.march_bound), and a march that reaches the bound is counted
// (counts[4], folded into n_bad) so a stall is never silent. The walk is
// persistent, as many 256-thread blocks as fit the card, striding over the
// pairs direction-major (pair p is direction p / E of event p % E), so a
// warp takes 32 events of one direction: the direction is a shared-memory
// broadcast and the event reads coalesce. The image tally
// [section][direction][column] and the capped excess live in shared memory
// when they fit kWalkSmem (flushed once per walk block); past it the image
// goes to global atomics. The direction cap of 64 per launch comes from the
// uniforms: they are keyed by step * 256 + site, and direction d draws its
// roulette numbers at sites 16 + 2d and 17 + 2d, so 64 directions keep
// every site below 144 and clear of the next step's draws. The estimate is
// a pure tally keyed by the event's own (lane, step), so the later kernel
// on other threads computes the numbers the transport's thread would have;
// tensor cores, wgmma and TMA have no matrix work to do in either kernel.
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
// Threads per block of the walk kernel.
constexpr int kWalkThreads = 256;
// Shared memory a walk block may take for its image and capped excess (48
// KB: four 256-thread blocks an SM); a larger image goes to global atomics.
constexpr size_t kWalkSmem = 48 * 1024;
// Most dynamic shared memory a block may take (the card's opt-in limit).
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxDirs = 64;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.31830988618379067154f;
constexpr float kFourPi = 12.56637061435917295384f;
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
  P_SPOT_X, P_SPOT_Y, P_ATMS, P_RPV_K, P_RPV_TH, N_PARAMS
};

// Surface kinds (record_kernel.py SURF_*).
enum { SURF_LAMBERT, SURF_RPV, SURF_PX };

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

// The local-estimate event queue: struct of arrays of cap records each.
// Floats: the event point, its weight, the incoming direction and the
// phase field f2; ints: the lane and step counter that key the event's
// draws, its kind (EV_*) and its capped-excess slot
// (record_kernel.QUEUE_FLOATS, QUEUE_INTS).
enum { QF_X, QF_Y, QF_Z, QF_W, QF_UX, QF_UY, QF_UZ, QF_F2, N_QF };
enum { QI_LANE, QI_CTR, QI_KIND, QI_SLOT, N_QI };
struct Queue {
  float* f;  // [N_QF][cap]
  int* i;    // [N_QI][cap]
  int* ctl;  // [events queued by this launch, the most any launch queued]
  int cap;
};

__device__ __forceinline__ void queue_event(const Queue& q, uint32_t lane,
                                            uint32_t ctr, int kind, int slot,
                                            float sx, float sy, float sz,
                                            float w, float ux, float uy,
                                            float uz, float f2) {
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
  q.f[QF_F2 * c + s] = f2;
  q.i[QI_LANE * c + s] = static_cast<int>(lane);
  q.i[QI_CTR * c + s] = static_cast<int>(ctr);
  q.i[QI_KIND * c + s] = kind;
  q.i[QI_SLOT * c + s] = slot;
}

// Local estimate of one event toward direction d of s_dirs
// (pallas_kernel.py :1515-2084, cell march) from (sx, sy, sz), drawing at
// the event's lane and step ctr. kind EV_LAMBERT: a surface reflection or
// emission, phase value 1/pi; EV_ISOTROPIC: an atmospheric emission,
// 1/(4 pi mu_d); EV_SCATTER: a scatter with incoming direction (uxi, uyi,
// uzi) and phase field f2 (HG g, or the table row) of the chosen component.
// Adds w_ev * npf * exp(-tau) (or its roulette form) into img at the exit
// column; with the cap, into the section of the event's slot (0 the
// surface or an emission, 1 + c component c) and the excess into s_exc.
// Adds the march iterations to march and a cut march to cut. The
// extinction beta is read with __ldg.
__device__ __forceinline__ void le_pair(
    const float* __restrict__ prm, const float* __restrict__ beta,
    const float* s_dirs,
    const float* __restrict__ fwd_v0, const float* __restrict__ fwd_dd,
    float* img, float* s_exc, const LeArgs& le, int nx, int ny, int nz,
    int d, uint32_t lane, uint32_t seed, uint32_t ctr, int kind, int slot,
    float sx, float sy, float sz, float w_ev, float uxi, float uyi,
    float uzi, float f2, unsigned long long& march, int& cut) {
  const float x0 = prm[P_X0], lx = prm[P_LX], y0 = prm[P_Y0];
  const float ly = prm[P_LY], z0 = prm[P_Z0], z_max = prm[P_ZMAX];
  const float inv_dx = prm[P_INV_DX], inv_dy = prm[P_INV_DY];
  const float inv_dz = prm[P_INV_DZ], dxc = prm[P_DXC], dyc = prm[P_DYC];
  const float dzc = prm[P_DZC], mnudge = prm[P_MNUDGE];
  const float zeta = prm[P_ZETA], cap = prm[P_MAXC];
  const int nxy = nx * ny;
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
    const int cell = (ixm * ny + iym) * nz + izm;
    const float beta_m = __ldg(beta + cell);
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
    ++cut;
    return;
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

// The uniform RPV BRDF for a photon reaching the surface along (ux, uy,
// uz) and leaving with cosine mu_new (sine sin_new) at the azimuth whose
// cosine and sine are cp, sp (pallas_kernel.py:1440-1477, operation for
// operation; record_kernel.rpv_weight is the plain twin).
__device__ __forceinline__ float rpv_weight(float rho0, float k, float th,
                                            float ux, float uy, float uz,
                                            float mu_new, float sin_new,
                                            float cp, float sp) {
  const float mu_i = fabsf(uz);
  const float si = sqrtf(fmaxf(0.f, 1.f - uz * uz));
  const float mu_r = fminf(fmaxf(mu_new, 1e-6f), 1.f);
  const float cos_dphi = si < 1e-6f ? 1.f : (cp * ux + sp * uy) / si;
  const float cos_g = mu_i * mu_r + (si * sin_new) * cos_dphi;
  const float minn_x = fmaxf((mu_i * mu_r) * (mu_i + mu_r), 1e-12f);
  const float minnaert = expf((k - 1.f) * logf(minn_x));
  const float hg_d = fmaxf((1.f + th * th) + (2.f * th) * cos_g, 1e-12f);
  const float hg_l = (1.f - th * th) / (hg_d * sqrtf(hg_d));
  const float mu_ic = fminf(fmaxf(mu_i, 1e-6f), 1.f);
  const float t_i = sqrtf(fmaxf(0.f, 1.f - mu_ic * mu_ic)) / mu_ic;
  const float t_r = sqrtf(fmaxf(0.f, 1.f - mu_r * mu_r)) / mu_r;
  const float cap_g = sqrtf(
      fmaxf((t_i * t_i + t_r * t_r) - ((2.f * t_i) * t_r) * cos_dphi, 0.f));
  return ((rho0 * minnaert) * hg_l) * (1.f + (1.f - rho0) / (1.f + cap_g));
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
             float* __restrict__ acc,
             unsigned long long* __restrict__ counts, Queue q,
             const float* __restrict__ em_prob,
             const float* __restrict__ em_alias,
             const float* __restrict__ alb, int n_lanes, int nx, int ny,
             int nz, int stride, int off_ssa, int off_f2, int inv_n_steps,
             int use_rr, int n_acc, uint32_t seed, uint32_t step0,
             int k_steps, int src, int ncomp, int lw, int surf,
             int vol_global) {
  // the shared tallies: the whole tally, or with vol_global the flux
  // columns only (the absorbed cells go straight to acc; each add names
  // its memory, so shared adds stay shared atomics)
  extern __shared__ float s_acc[];
  __shared__ int s_counts[kCounts];
  const int n_smem = VOL && vol_global ? 2 * nx * ny : n_acc;
  for (int i = threadIdx.x; i < n_smem; i += blockDim.x) s_acc[i] = 0.f;
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
    const float rpv_k = prm[P_RPV_K], rpv_th = prm[P_RPV_TH];
    const int nxy = nx * ny;
    const int n_cells = nxy * nz;

    float x = xs[lane], y = ys[lane], z = zs[lane];
    float ux = uxs[lane], uy = uys[lane], uz = uzs[lane];
    float w = ws[lane], bl = bls[lane];
    int quota = quotas[lane];
    bool alive = alives[lane] > 0;
    int started = 0, steps = 0, reals = 0, events = 0;
    const uint32_t ul = static_cast<uint32_t>(lane);

    for (int k = 0; k < k_steps; ++k) {
      // a lane with no photon and no quota has no work left this launch
      if (!alive && quota <= 0) break;
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      // ---- refill a dead lane from the source (pallas_kernel.py
      // :897-1027) ----
      bool born = false, born_atm = false;
      if (!alive) {
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
              if (lw && vol_global) {
                atomicAdd(&acc[2 * nxy + v], -1.f);
              } else if (lw) {
                atomicAdd(&s_acc[2 * nxy + v], -1.f);
              }
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
      steps += 1;
      if constexpr (LE) {
        // LW radiance: a newly emitted lane queues its emission local
        // estimate (weight 1) and moves from the next step on
        // (pallas_kernel.py:986, :1086-1091, :1529-1534, :1682-1688)
        if (lw && born) {
          events += 1;
          queue_event(q, ul, ctr, born_atm ? EV_ISOTROPIC : EV_LAMBERT, 0, x,
                      y, z, 1.f, 0.f, 0.f, 0.f, 0.f);
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
          // the outgoing direction, cosine-sampled; ux, uy, uz still hold
          // the incoming one
          const float mu_new =
              sqrtf(fmaxf(uniform(ul, seed, ctr, S_ANGLE), 1e-12f));
          const float sin_new = sqrtf(fmaxf(0.f, 1.f - mu_new * mu_new));
          float sp, cp;
          sincosf(phi_rot, &sp, &cp);
          float refl;
          if (surf == SURF_RPV) {
            refl = rpv_weight(albedo, rpv_k, rpv_th, ux, uy, uz, mu_new,
                              sin_new, cp, sp);
          } else if (surf == SURF_PX) {  // the landing column's albedo
            refl = __ldg(alb + col_e);
          } else {
            refl = albedo;
          }
          const float w_refl = w * refl;
          x = xe;
          y = ye;
          z = z_bot;
          if (MACRO) bl = beta_max;
          if (w_refl <= kTiny) {
            alive = false;
          } else {
            if constexpr (LE) {
              events += 1;
              queue_event(q, ul, ctr, EV_LAMBERT, 0, xe, ye, z_bot, w_refl,
                          0.f, 0.f, 0.f, 0.f);
            }
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
      if (VOL && vol_global) {
        atomicAdd(&acc[2 * nxy + cell], w * (1.f - ssa));
      } else {
        atomicAdd(&s_acc[2 * nxy + (VOL ? cell : col_c)], w * (1.f - ssa));
      }
      w = w * ssa;
      if constexpr (LE) {  // post-absorption, pre-roulette weight, incoming dir
        events += 1;
        queue_event(q, ul, ctr, EV_SCATTER, slot, x, y, z, w, ux, uy, uz, f2);
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
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_smem; i += blockDim.x) {
    const float v = s_acc[i];
    if (v != 0.f) atomicAdd(&acc[i], v);
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
// before it stages anything. Shared memory: the capped excess [n_exc], then
// the image [n_img] (le.img_smem), each flushed once per block. Adds the
// march iterations into march[0] and the cut marches into counts[4], one
// atomic per block each, and records the largest fill in ctl[1].
__global__ void __launch_bounds__(kWalkThreads)
record_walk(const float* __restrict__ prm, const float* __restrict__ beta,
            Queue q, const float* __restrict__ dirs,
            const float* __restrict__ fwd_v0,
            const float* __restrict__ fwd_dd, float* __restrict__ g_img,
            float* __restrict__ g_exc,
            unsigned long long* __restrict__ counts,
            unsigned long long* __restrict__ g_march, LeArgs le, int nx,
            int ny, int nz, uint32_t seed) {
  extern __shared__ float s_walk_mem[];
  __shared__ float s_dirs[3 * kMaxDirs];
  __shared__ unsigned long long s_march;
  __shared__ int s_cut;
  const int fill = q.ctl[0];
  const unsigned n_ev = static_cast<unsigned>(fill < q.cap ? fill : q.cap);
  const unsigned n_pairs = n_ev * static_cast<unsigned>(le.n_dirs);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicMax(&q.ctl[1], fill);
  const unsigned first = blockIdx.x * blockDim.x;
  if (first >= n_pairs) return;
  float* s_exc = s_walk_mem;
  float* img = le.img_smem ? s_exc + le.n_exc : g_img;
  for (int i = threadIdx.x; i < le.n_exc; i += blockDim.x) s_exc[i] = 0.f;
  if (le.img_smem) {
    for (int i = threadIdx.x; i < le.n_img; i += blockDim.x) img[i] = 0.f;
  }
  for (int i = threadIdx.x; i < 3 * le.n_dirs; i += blockDim.x) {
    s_dirs[(i / le.n_dirs) * kMaxDirs + i % le.n_dirs] = dirs[i];
  }
  if (threadIdx.x == 0) {
    s_march = 0;
    s_cut = 0;
  }
  __syncthreads();
  unsigned long long march = 0;
  int cut = 0;
  const size_t c = static_cast<size_t>(q.cap);
  for (unsigned p = first + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    const unsigned d = p / n_ev, e = p - d * n_ev;
    le_pair(prm, beta, s_dirs, fwd_v0, fwd_dd, img, s_exc, le, nx, ny, nz,
            static_cast<int>(d), static_cast<uint32_t>(q.i[QI_LANE * c + e]),
            seed, static_cast<uint32_t>(q.i[QI_CTR * c + e]),
            q.i[QI_KIND * c + e], q.i[QI_SLOT * c + e], q.f[QF_X * c + e],
            q.f[QF_Y * c + e], q.f[QF_Z * c + e], q.f[QF_W * c + e],
            q.f[QF_UX * c + e], q.f[QF_UY * c + e], q.f[QF_UZ * c + e],
            q.f[QF_F2 * c + e], march, cut);
  }
  march = mcb::warp_sum(march);
  cut = mcb::warp_sum(cut);
  if ((threadIdx.x & 31u) == 0) {
    if (march) atomicAdd(&s_march, march);
    if (cut) atomicAdd(&s_cut, cut);
  }
  __syncthreads();
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
  if (threadIdx.x == 0) {
    if (s_march) atomicAdd(g_march, s_march);
    if (s_cut) {
      atomicAdd(&counts[4], static_cast<unsigned long long>(s_cut));
    }
  }
}

// The tally layout of a launch of record_steps<MACRO, VOL, ANALYTIC, LE>:
// its dynamic shared memory and whether the 3D tally's absorbed cells go
// to global memory (when a block's copy of them would cost blocks an SM).
// The answer depends on the two sizes alone, so the queries run once for
// the sizes of the last launch, not before every launch of a batch.
template <bool MACRO, bool VOL, bool ANALYTIC, bool LE>
cudaError_t tally_layout(int nxy, int n_acc, size_t* smem, int* vol_global) {
  static int last_nxy = -1, last_n_acc = -1, last_global = 0;
  auto kernel = record_steps<MACRO, VOL, ANALYTIC, LE>;
  const size_t cols = 2 * static_cast<size_t>(nxy) * sizeof(float);
  *smem = static_cast<size_t>(n_acc) * sizeof(float);
  *vol_global = 0;
  if (!VOL) return cudaSuccess;
  if (nxy != last_nxy || n_acc != last_n_acc) {
    int whole = 0, split = 0;
    cudaError_t e = cudaSuccess;
    if (*smem <= kMaxSmem) {
      e = mcb::smem_blocks(kernel, kThreads, *smem, &whole);
    }
    if (e == cudaSuccess) {
      e = mcb::smem_blocks(kernel, kThreads, cols, &split);
    }
    if (e != cudaSuccess) return e;
    last_nxy = nxy;
    last_n_acc = n_acc;
    last_global = whole < split;
  }
  if (last_global) {
    *smem = cols;
    *vol_global = 1;
  }
  return cudaSuccess;
}

template <bool MACRO, bool VOL, bool ANALYTIC, bool LE>
cudaError_t launch(const float* prm, const float* rec, const float* inv_a0,
                   const float* inv_dd, float* x, float* y, float* z,
                   float* ux, float* uy, float* uz, float* w, float* bl,
                   int* quota, int* alive, float* acc,
                   unsigned long long* counts, const Queue& q,
                   const float* em_prob, const float* em_alias,
                   const float* alb, int n_lanes, int nx, int ny, int nz,
                   int stride, int off_ssa, int off_f2, int inv_n_steps,
                   int use_rr, int n_acc, uint32_t seed, uint32_t step0,
                   int k_steps, int src, int ncomp, int lw, int surf,
                   cudaStream_t stream) {
  auto kernel = record_steps<MACRO, VOL, ANALYTIC, LE>;
  size_t smem = 0;
  int vol_global = 0;
  const cudaError_t e0 = tally_layout<MACRO, VOL, ANALYTIC, LE>(
      nx * ny, n_acc, &smem, &vol_global);
  if (e0 != cudaSuccess) return e0;
  // past 48 KB of static + dynamic shared memory a launch needs the
  // opt-in; the static part (counts) is under 1 KB
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      prm, rec, inv_a0, inv_dd, x, y, z, ux, uy, uz, w, bl, quota, alive,
      acc, counts, q, em_prob, em_alias, alb, n_lanes, nx, ny, nz, stride,
      off_ssa, off_f2, inv_n_steps, use_rr, n_acc, seed, step0, k_steps, src,
      ncomp, lw, surf, vol_global);
  return cudaGetLastError();
}

// The occupancy record (mcb::OCC_*) of record_steps<MACRO, VOL, ANALYTIC,
// LE> with smem bytes of dynamic shared memory (smem < 0: what a launch on
// the tally of nxy columns and n_acc entries takes).
template <bool MACRO, bool VOL, bool ANALYTIC, bool LE>
cudaError_t occupancy(int smem, int nxy, int n_acc, int* out) {
  size_t bytes = static_cast<size_t>(smem);
  int vol_global = 0;
  if (smem < 0) {
    const cudaError_t e = tally_layout<MACRO, VOL, ANALYTIC, LE>(
        nxy, n_acc, &bytes, &vol_global);
    if (e != cudaSuccess) return e;
  }
  auto kernel = record_steps<MACRO, VOL, ANALYTIC, LE>;
  if (bytes > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  return mcb::occupancy_record(kernel, kThreads, bytes, out);
}

}  // namespace

extern "C" int record_kernel_num_params() { return N_PARAMS; }

// The occupancy record (mcb::OCC_*: blocks of 128 threads resident on one
// SM, threads, dynamic shared memory, registers and spilled bytes a
// thread, SMs) of the transport kernel's (macro, vol, analytic, le)
// instantiation on the current card, with smem_bytes of dynamic shared
// memory (smem_bytes < 0: the tally layout a launch on a tally of nxy
// columns and n_acc entries takes). Returns 0 or the CUDA error.
extern "C" int record_kernel_occupancy(int macro, int vol, int analytic,
                                       int le, int smem_bytes, int nxy,
                                       int n_acc, int* out) {
  const int i = (macro ? 8 : 0) + (vol ? 4 : 0) + (analytic ? 2 : 0) +
                (le ? 1 : 0);
  cudaError_t e;
  switch (i) {
#define MCB_OCC(I, M, V, A, L) \
  case I:                     \
    e = occupancy<M, V, A, L>(smem_bytes, nxy, n_acc, out); \
    break;
    MCB_OCC(0, false, false, false, false)
    MCB_OCC(1, false, false, false, true)
    MCB_OCC(2, false, false, true, false)
    MCB_OCC(3, false, false, true, true)
    MCB_OCC(4, false, true, false, false)
    MCB_OCC(5, false, true, false, true)
    MCB_OCC(6, false, true, true, false)
    MCB_OCC(7, false, true, true, true)
    MCB_OCC(8, true, false, false, false)
    MCB_OCC(9, true, false, false, true)
    MCB_OCC(10, true, false, true, false)
    MCB_OCC(11, true, false, true, true)
    MCB_OCC(12, true, true, false, false)
    MCB_OCC(13, true, true, false, true)
    MCB_OCC(14, true, true, true, false)
    default:
      e = occupancy<true, true, true, true>(smem_bytes, nxy, n_acc, out);
#undef MCB_OCC
  }
  return static_cast<int>(e);
}

// Advance every lane by k_steps transport steps, refilling from source kind
// src (SRC_*; emission draws from the alias pair em_prob/em_alias over the
// nx*ny*nz cells, and with lw, which needs vol, pre-credits its
// atmospheric births) on a domain of ncomp components (records of `stride`
// floats; 8, 16-byte aligned, when ncomp > 1), reflecting off the surface
// kind surf (SURF_*; SURF_PX reads alb, an albedo per column). Adds the
// tally into acc, the photons started into counts[0], the lanes with work
// left (alive or quota > 0) into counts[1], the lane-steps run with a live
// photon into counts[2], the real collisions into counts[3] and, with
// radiance (n_dirs > 0), the local-estimate events into counts[5]; every
// event is queued into the struct-of-arrays queue (qf [N_QF][cap], qi
// [N_QI][cap]) after its fill qctl[0] is set to 0, and record_walk_launch
// then computes the estimates. The counters are int64 (a launch of 2^18
// lanes x 8,192 steps reaches 2^31 lane-steps); a lane with no photon and
// no quota stops stepping. Returns cudaGetLastError().
extern "C" int record_kernel_launch(
    const float* prm, const float* rec, const float* inv_a0,
    const float* inv_dd, float* x, float* y, float* z, float* ux,
    float* uy, float* uz, float* w, float* bl, int* quota, int* alive,
    float* acc, unsigned long long* counts, float* qf, int* qi, int* qctl,
    const float* em_prob, const float* em_alias, const float* alb,
    int n_lanes, int nx, int ny, int nz, int stride, int off_ssa,
    int off_f2, int inv_n_steps, int use_rr, int n_acc, uint32_t seed,
    uint32_t step0, int k_steps, int macro, int vol, int analytic, int src,
    int ncomp, int lw, int surf, int n_dirs, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dirs < 0 || n_dirs > kMaxDirs || (n_dirs > 0 && cap <= 0)) {
    return cudaErrorInvalidValue;
  }
  if (src < SRC_DIRECTIONAL || src > SRC_EMISSION) {
    return cudaErrorInvalidValue;
  }
  if (lw && (src != SRC_EMISSION || !vol)) return cudaErrorInvalidValue;
  if (ncomp < 1 || ncomp > 3 || (ncomp > 1 && stride != 8)) {
    return cudaErrorInvalidValue;
  }
  if (surf < SURF_LAMBERT || surf > SURF_PX) return cudaErrorInvalidValue;
  if (n_dirs > 0) {
    const cudaError_t e = cudaMemsetAsync(qctl, 0, sizeof(int), s);
    if (e != cudaSuccess) return e;
  }
  const Queue q{qf, qi, qctl, cap};
#define MCB_CALL(M, V, A, L)                                                 \
  static_cast<int>(launch<M, V, A, L>(                                       \
      prm, rec, inv_a0, inv_dd, x, y, z, ux, uy, uz, w, bl, quota, alive,    \
      acc, counts, q, em_prob, em_alias, alb, n_lanes, nx, ny, nz, stride,   \
      off_ssa, off_f2, inv_n_steps, use_rr, n_acc, seed, step0, k_steps,     \
      src, ncomp, lw, surf, s))
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

// The local estimates of the events record_kernel_launch queued (qf, qi,
// qctl of capacity cap): every (event, direction) pair toward the n_dirs
// directions of dirs ([3][n_dirs]), marching through beta ([nx*ny*nz], the
// records' extinction), adding the image into img (n_img entries:
// [n_sec][n_dirs][nxy]), the capped excess into exc (n_exc entries), the
// marches cut by k_dda into counts[4] and the march iterations into
// march[0]. The image goes to shared memory where it fits kWalkSmem bytes
// beside the excess. The phase source (le_phase, the forward table of
// fwd_n_s points a row), roulette (le_rr) and the cap (le_cap) are launch
// arguments. Returns cudaGetLastError().
extern "C" int record_walk_launch(
    const float* prm, const float* beta, float* qf, int* qi, int* qctl,
    int cap, const float* dirs, const float* fwd_v0, const float* fwd_dd,
    float* img, float* exc, unsigned long long* counts,
    unsigned long long* march, int nx,
    int ny, int nz, uint32_t seed, int n_dirs, int le_phase, int fwd_n_s,
    int le_rr, int le_cap, int k_dda, int n_img, int n_exc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = static_cast<size_t>(n_exc) * sizeof(float);
  if (n_dirs < 1 || n_dirs > kMaxDirs || cap <= 0 || k_dda <= 0 ||
      smem > kWalkSmem) {
    return cudaErrorInvalidValue;
  }
  const size_t img_bytes = static_cast<size_t>(n_img) * sizeof(float);
  const int img_smem = smem + img_bytes <= kWalkSmem;
  if (img_smem) smem += img_bytes;
  const LeArgs le{n_dirs, le_phase, fwd_n_s, le_rr, le_cap,
                  k_dda,  n_img,    n_exc,   img_smem};
  const Queue q{qf, qi, qctl, cap};
  // past 48 KB of static + dynamic shared memory a launch needs the opt-in
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        record_walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int blocks = 0;
  const cudaError_t e =
      mcb::persistent_blocks(record_walk, kWalkThreads, smem, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  record_walk<<<blocks, kWalkThreads, smem, s>>>(
      prm, beta, q, dirs, fwd_v0, fwd_dd, img, exc, counts, march, le, nx, ny,
      nz, seed);
  return static_cast<int>(cudaGetLastError());
}
