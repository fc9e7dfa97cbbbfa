// Tiled dense-domain kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: mcbrat3d_tpu/transport/pallas_tile.py `_build_tile_kernel`, as
// launched by `_make_tile_launch` (one pass of the pass loop). The domain
// (a dense, full-rank extinction field past every template: the MODIS
// class) is cut into at most 127 tiles, each with its own Woodcock
// majorant. One step of a photon in its tile: a jump against the tile
// majorant clipped at the tile's box (plus the nudge); at a collision the
// cell (relative to the tile origin, clipped), the field fetch, the
// null-collision test, absorption, roulette and an analytic HG or tabulated
// inverse-CDF scatter with the rotation; at the box face either an exit
// through the domain top or bottom (decided by the tile's z index) with the
// exit column taken from the wrapped exit point relative to the tile and
// Lambertian reflection, or a step into the neighbouring tile along the
// crossing axis (periodic in x and y) followed by the chain that skips up to
// skip_iters empty tiles and parks at the domain's top and bottom tiles. It
// tallies flux up, flux down and absorption per column.
//
// Two launch modes run that one step (tile_step), so the arithmetic the
// pass mode's parity with the JAX kernel proves is the arithmetic the
// production mode runs:
//
// * pass mode (the JAX kernel's): the host packs the pool into per-tile
//   cohorts and every slot takes up to k_steps steps while its photon stays
//   in its tile (with follow, the port's tail, into every tile it crosses);
// * refill mode (production, under record_kernel.relaunch_loop): a slot
//   whose photon is dead and whose quota is above 0 starts a fresh photon
//   from the source in that step, drawing at the injection sites (0, 1, 2,
//   9) at the step's counter keyed by the slot, which the transport's sites
//   (3-8) never use, so it may move in its birth step; a live photon
//   follows its path into every tile it crosses; the slot steps until
//   k_steps run out or it is dead with no quota. No sort, no pack, no
//   cohort padding: nothing on this card needs the photons grouped by tile.
//
// Design. One thread per pool slot; the slot number keys the counter
// uniforms, so the kernel draws what the JAX kernel (interpret mode) and
// the plain PyTorch pass draw. A slot with nothing to do returns at once;
// the others load their state into registers once per launch, step and
// write the state back. The TPU kernel's per-tile [*, 128] slabs, their
// DMA, the select chains that read them and the one-hot matrix tally are
// not carried over: the per-cell fields are read with __ldg from dense
// arrays in global cell order (the bench's extinction, 4 MB, stays in the
// 50 MB L2), the tile majorants (at most 127 and a zero DEAD slot) sit in
// shared memory, where the skip chain reads them too, the stacked
// inverse-CDF table goes to shared memory while it fits the caller's
// budget (else __ldg), and the tallies are float32 atomics into global
// [3, nx, ny]. The counts (photons started, slots with work left,
// lane-steps with a live photon, real collisions) are reduced per warp and
// added to 64-bit counters.
//
// What bounds it on this card: the latency of the dependent per-step math
// (log1pf, the divisions, the box exit, the uniforms' integer mixing,
// sincosf and the HG or table sampling) with one pool of slots in flight,
// and the gathers of the field at random cells; its bytes (the state once
// per launch, the field, the tallies) and its operations are both far
// below the card's rates. It does no matrix work, so wgmma and TMA do not
// apply.
//
// Arithmetic follows the JAX kernel operation by operation in float32, and
// the library is built with -fmad=false so no multiply-add is contracted
// away from the plain PyTorch pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "mcb_common.cuh"

namespace {

using mcb::clampi;
using mcb::kBig;
using mcb::kTiny;
using mcb::uniform;
using mcb::wrap;

constexpr int kThreads = 256;
// Most shared memory a block may take (the card's opt-in limit); the
// caller's table budget (tile_kernel.TABLE_SMEM) is held under it.
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxTiles = 127;

// params[] slots (mcbrat3d_tpu_torch/transport/tile_kernel.py P_*).
enum {
  P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ, P_ALBEDO, P_SSA_U, P_G_U, P_RR_W,
  P_HALF_RR, P_INV_DX, P_INV_DY, P_INV_DZ, P_TXP, P_TYP, P_TZP, P_ZMAX,
  P_ZLO, P_ZHI, P_NUDGE, P_TWO_PI, P_SMU, P_SUX, P_SUY, P_SPOT_X, P_SPOT_Y,
  N_PARAMS
};

// Source kinds of the refill (tile_kernel.SOURCE_KINDS).
enum { SRC_DIRECTIONAL, SRC_RANDOM_AZIMUTH, SRC_FLUX, SRC_SPOTLIGHT };

// K5 draw sites (tile_kernel.SITE_*, INJECTION_SITES).
enum : uint32_t {
  S_X = 0, S_Y = 1, S_SOURCE = 2, S_TAU = 3, S_COLLIDE = 4, S_ANGLE = 5,
  S_PHI = 6, S_ROULETTE = 7, S_COMPONENT = 8, S_SOURCE_PHI = 9
};

// counts[]: photons started, slots with work left (alive or quota > 0),
// lane-steps run with a live photon, real collisions.
constexpr int kCounts = 4;

// Grid and plan: cells, tile sizes in cells, tiles per axis.
struct Plan {
  int nx, ny, nz, tx, ty, tz, ntx, nty, ntz, n_tiles;
};

// The launch's scalars (the params vector).
struct Consts {
  float x0, lx, y0, ly, z0, albedo, ssa_u, g_u, rr_w, half_rr, inv_dx,
      inv_dy, inv_dz, txp, typ, tzp, z_max, z_lo, z_hi, nudge, two_pi, smu,
      sux, suy, spot_x, spot_y;
};

__device__ __forceinline__ Consts load_consts(const float* prm) {
  return Consts{prm[P_X0],    prm[P_LX],     prm[P_Y0],     prm[P_LY],
                prm[P_Z0],    prm[P_ALBEDO], prm[P_SSA_U],  prm[P_G_U],
                prm[P_RR_W],  prm[P_HALF_RR], prm[P_INV_DX], prm[P_INV_DY],
                prm[P_INV_DZ], prm[P_TXP],   prm[P_TYP],    prm[P_TZP],
                prm[P_ZMAX],  prm[P_ZLO],    prm[P_ZHI],    prm[P_NUDGE],
                prm[P_TWO_PI], prm[P_SMU],   prm[P_SUX],    prm[P_SUY],
                prm[P_SPOT_X], prm[P_SPOT_Y]};
}

// What a step reads besides the photon: the per-cell fields, the tile
// majorants (shared) and the inverse-CDF table (shared or global).
struct Tables {
  const float* fields;
  const float* s_maj;
  const float* s_a0;
  const float* s_dd;
  const float* g_a0;
  const float* g_dd;
  int inv_smem, inv_n_steps, need_ssa, need_f2;
  long long n_cells;
};

// A photon in registers: position, direction, weight and its tile
// (n_tiles: DEAD).
struct Photon {
  float x, y, z, ux, uy, uz, w;
  int tl;
};

// A tile: its indices, first cell, box and majorant.
struct Box {
  int ta, tb, tc, gx0, gy0, gz0;
  float x0p, y0p, z0p, x1p, y1p, z1p, maj;
};

__device__ __forceinline__ Box box_of(int t, const Plan& g, const Consts& c,
                                      const float* s_maj) {
  Box b;
  const int nyz = g.nty * g.ntz;
  b.ta = t / nyz;
  const int rem = t - b.ta * nyz;
  b.tb = rem / g.ntz;
  b.tc = rem - b.tb * g.ntz;
  b.x0p = c.x0 + static_cast<float>(b.ta) * c.txp;
  b.y0p = c.y0 + static_cast<float>(b.tb) * c.typ;
  b.z0p = c.z0 + static_cast<float>(b.tc) * c.tzp;
  b.x1p = b.x0p + c.txp;
  b.y1p = b.y0p + c.typ;
  b.z1p = b.z0p + c.tzp;
  b.gx0 = b.ta * g.tx;
  b.gy0 = b.tb * g.ty;
  b.gz0 = b.tc * g.tz;
  b.maj = s_maj[t];
  return b;
}

// Distance along u from p to the box face it faces; 0 when behind it.
__device__ __forceinline__ float axis_dist(float p, float u, float b0,
                                           float b1) {
  const float s = fabsf(u) > 1e-12f
                      ? ((u >= 0.f ? b1 : b0) - p) / (u == 0.f ? 1.f : u)
                      : kBig;
  return fmaxf(s, 0.f);
}

// Distance to the exit of the box [b0, b1] and its axis (0 x, 1 y, 2 z),
// ties broken x, then y, then z (pallas_tile.py:437-468).
__device__ __forceinline__ float exit_dist(float px, float py, float pz,
                                           float ux, float uy, float uz,
                                           float bx0, float bx1, float by0,
                                           float by1, float bz0, float bz1,
                                           int& axis) {
  const float sx = axis_dist(px, ux, bx0, bx1);
  const float sy = axis_dist(py, uy, by0, by1);
  const float sz = axis_dist(pz, uz, bz0, bz1);
  axis = (sx <= sy && sx <= sz) ? 0 : (sy <= sz ? 1 : 2);
  return fminf(sx, fminf(sy, sz));
}

__device__ __forceinline__ int wrapi(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ float table(const float* s, const float* g, int i,
                                       bool in_smem) {
  return in_smem ? s[i] : __ldg(g + i);
}

// A fresh photon from the source at the slot's injection draws of counter
// ctr (tile_kernel._fresh): the entry point at the top (one point for the
// spotlight), the source's direction, weight 1, and the tile under the
// entry point in the top layer of tiles.
__device__ __forceinline__ void inject(Photon& p, const Consts& c,
                                       const Plan& g, int src, uint32_t ul,
                                       uint32_t seed, uint32_t ctr) {
  if (src == SRC_SPOTLIGHT) {
    p.x = c.x0 + c.spot_x * c.lx;
    p.y = c.y0 + c.spot_y * c.ly;
  } else {
    p.x = c.x0 + uniform(ul, seed, ctr, S_X) * c.lx;
    p.y = c.y0 + uniform(ul, seed, ctr, S_Y) * c.ly;
  }
  if (src == SRC_DIRECTIONAL || src == SRC_SPOTLIGHT) {
    p.ux = c.sux;
    p.uy = c.suy;
    p.uz = -c.smu;
  } else {
    float mu, phi;
    if (src == SRC_RANDOM_AZIMUTH) {
      mu = c.smu;
      phi = c.two_pi * uniform(ul, seed, ctr, S_SOURCE);
    } else {  // flux: mu = sqrt(u), the azimuth at the fourth draw
      mu = sqrtf(fmaxf(uniform(ul, seed, ctr, S_SOURCE), 1e-12f));
      phi = c.two_pi * uniform(ul, seed, ctr, S_SOURCE_PHI);
    }
    const float s_sin = sqrtf(fmaxf(0.f, 1.f - mu * mu));
    p.ux = s_sin * cosf(phi);
    p.uy = s_sin * sinf(phi);
    p.uz = -mu;
  }
  p.z = c.z_hi;
  p.w = 1.f;
  const int ix = clampi(static_cast<int>((p.x - c.x0) * c.inv_dx), g.nx - 1);
  const int iy = clampi(static_cast<int>((p.y - c.y0) * c.inv_dy), g.ny - 1);
  p.tl = ((ix / g.tx) * g.nty + iy / g.ty) * g.ntz + (g.ntz - 1);
}

// One transport step of a live photon in the tile b (its tile p.tl), with
// the uniforms of counter ctr: a collision (real or null), an exit through
// the domain top or bottom, or a crossing into the next non-empty tile
// (p.tl updated; n_tiles when the photon dies).
template <int NCOMP, bool ANALYTIC, bool RR>
__device__ __forceinline__ void tile_step(Photon& p, const Box& b,
                                          const Consts& c, const Plan& g,
                                          const Tables& t, float* acc,
                                          int skip_iters, uint32_t ul,
                                          uint32_t seed, uint32_t ctr,
                                          unsigned int& n_real) {
  const int nxy = g.nx * g.ny;
  const float u_ang = uniform(ul, seed, ctr, S_ANGLE);
  const float phi_rot = c.two_pi * uniform(ul, seed, ctr, S_PHI);

  // ---- Woodcock jump against the tile majorant, clipped at the box ----
  const float tau = -log1pf(-uniform(ul, seed, ctr, S_TAU));
  const float d_samp = b.maj > kTiny ? tau / fmaxf(b.maj, kTiny) : kBig;
  int axis;
  const float t_exit = exit_dist(p.x, p.y, p.z, p.ux, p.uy, p.uz, b.x0p,
                                 b.x1p, b.y0p, b.y1p, b.z0p, b.z1p, axis);

  if (d_samp < t_exit) {
    // ---- collision point and cell, relative to the tile origin ----
    const float xn = p.x + p.ux * d_samp;
    const float yn = p.y + p.uy * d_samp;
    const float zn = p.z + p.uz * d_samp;
    const int lix = clampi(static_cast<int>((xn - b.x0p) * c.inv_dx),
                           g.tx - 1);
    const int liy = clampi(static_cast<int>((yn - b.y0p) * c.inv_dy),
                           g.ty - 1);
    const int liz = clampi(static_cast<int>((zn - b.z0p) * c.inv_dz),
                           g.tz - 1);
    const int col = (b.gx0 + lix) * g.ny + (b.gy0 + liy);
    const long long cell = static_cast<long long>(col) * g.nz + b.gz0 + liz;
    p.x = xn;
    p.y = yn;
    p.z = fminf(fmaxf(zn, c.z0), c.z_max);
    const float* f = t.fields;
    const long long nc = t.n_cells;
    const float beta = __ldg(f + cell);
    if (!(uniform(ul, seed, ctr, S_COLLIDE) * b.maj < beta)) return;
    n_real += 1;

    // ---- real collision: fields, absorption, roulette ----
    float ssa, f2;
    if (NCOMP == 1) {
      ssa = t.need_ssa ? __ldg(f + nc + cell) : c.ssa_u;
      f2 = t.need_f2 ? __ldg(f + (1 + t.need_ssa) * nc + cell) : c.g_u;
    } else {
      // effective ssa; the component by one uniform against the
      // cumulative scattering fractions
      ssa = __ldg(f + nc + cell);
      const float u_cmp = uniform(ul, seed, ctr, S_COMPONENT);
      int k = u_cmp >= __ldg(f + 2 * nc + cell) ? 1 : 0;
      if (NCOMP == 3 && u_cmp >= __ldg(f + 3 * nc + cell)) k = 2;
      f2 = __ldg(f + (1 + NCOMP + k) * nc + cell);
    }
    const float absorbed = p.w * (1.f - ssa);
    p.w = p.w * ssa;
    if (absorbed != 0.f) atomicAdd(&acc[2 * nxy + col], absorbed);
    if (RR && p.w < c.half_rr) {
      p.w = uniform(ul, seed, ctr, S_ROULETTE) < p.w / c.rr_w ? c.rr_w : 0.f;
    }
    if (p.w <= kTiny) {
      p.tl = g.n_tiles;
      return;
    }

    // ---- scatter: analytic HG or the tabulated inverse CDF ----
    float cos_t;
    if (ANALYTIC) {
      cos_t = mcb::hg_cos(f2, u_ang);
    } else {
      const int n_s = t.inv_n_steps;
      const float t_u = u_ang * static_cast<float>(n_s - 1);
      int ki = static_cast<int>(t_u);
      ki = ki < 0 ? 0 : (ki > n_s - 2 ? n_s - 2 : ki);
      const float frac = t_u - static_cast<float>(ki);
      const int flat = (NCOMP > 1 || t.need_f2)
                           ? static_cast<int>(f2 + 0.5f) * n_s + ki
                           : ki;
      cos_t = cosf(table(t.s_a0, t.g_a0, flat, t.inv_smem) +
                   frac * table(t.s_dd, t.g_dd, flat, t.inv_smem));
    }
    mcb::rotate(p.ux, p.uy, p.uz, cos_t, phi_rot);
    return;
  }

  // ---- the box face: domain exits are topological, by the tile's z
  // index ----
  const bool exit_top = axis == 2 && p.uz > 0.f && b.tc == g.ntz - 1;
  const bool exit_bot = axis == 2 && p.uz < 0.f && b.tc == 0;
  if (exit_top || exit_bot) {
    // exit column from the wrapped exit point relative to the tile
    const float z_b = exit_top ? c.z_max : c.z0;
    const float t_b = (z_b - p.z) / (fabsf(p.uz) < 1e-12f ? 1.f : p.uz);
    const float xe = c.x0 + wrap((p.x + p.ux * t_b) - c.x0, c.lx);
    const float ye = c.y0 + wrap((p.y + p.uy * t_b) - c.y0, c.ly);
    const int lixe = clampi(static_cast<int>((xe - b.x0p) * c.inv_dx),
                            g.tx - 1);
    const int liye = clampi(static_cast<int>((ye - b.y0p) * c.inv_dy),
                            g.ty - 1);
    const int col_e = (b.gx0 + lixe) * g.ny + (b.gy0 + liye);
    atomicAdd(&acc[(exit_top ? 0 : nxy) + col_e], p.w);
    if (exit_top) {
      p.tl = g.n_tiles;
      return;
    }
    // ---- Lambertian reflection (reuses u_ang and phi_rot) ----
    const float w_refl = p.w * c.albedo;
    p.x = xe;
    p.y = ye;
    p.z = c.z_lo;
    if (w_refl <= kTiny) {
      p.tl = g.n_tiles;
      return;
    }
    const float mu_new = sqrtf(fmaxf(u_ang, 1e-12f));
    const float sin_new = sqrtf(fmaxf(0.f, 1.f - mu_new * mu_new));
    float sp, cp;
    sincosf(phi_rot, &sp, &cp);
    p.ux = sin_new * cp;
    p.uy = sin_new * sp;
    p.uz = mu_new;
    p.w = w_refl;
    return;
  }

  // ---- into the neighbouring tile along the crossing axis ----
  const float d = t_exit + c.nudge;
  float px = c.x0 + wrap((p.x + p.ux * d) - c.x0, c.lx);
  float py = c.y0 + wrap((p.y + p.uy * d) - c.y0, c.ly);
  float pz = fminf(fmaxf(p.z + p.uz * d, c.z_lo), c.z_hi);
  const int sgx = p.ux >= 0.f ? 1 : -1, sgy = p.uy >= 0.f ? 1 : -1;
  const int sgz = p.uz >= 0.f ? 1 : -1;
  int na = b.ta, nb = b.tb, nc = b.tc;
  if (axis == 0) {
    na = wrapi(b.ta + sgx, g.ntx);
  } else if (axis == 1) {
    nb = wrapi(b.tb + sgy, g.nty);
  } else {
    nc = b.tc + sgz;
  }
  // ---- empty-tile skip chain: no collision can happen where the
  // majorant is zero; crossings out of the domain top or bottom park
  for (int i = 0; i < skip_iters; ++i) {
    const int tn = (na * g.nty + nb) * g.ntz + nc;
    if (t.s_maj[tn < g.n_tiles ? tn : g.n_tiles] > 0.f) break;
    const float bx0 = c.x0 + static_cast<float>(na) * c.txp;
    const float by0 = c.y0 + static_cast<float>(nb) * c.typ;
    const float bz0 = c.z0 + static_cast<float>(nc) * c.tzp;
    int ax;
    const float t_x = exit_dist(px, py, pz, p.ux, p.uy, p.uz, bx0,
                                bx0 + c.txp, by0, by0 + c.typ, bz0,
                                bz0 + c.tzp, ax) +
                      c.nudge;
    if (ax == 2 && ((nc == g.ntz - 1 && p.uz > 0.f) ||
                    (nc == 0 && p.uz < 0.f))) {
      break;
    }
    px = c.x0 + wrap((px + p.ux * t_x) - c.x0, c.lx);
    py = c.y0 + wrap((py + p.uy * t_x) - c.y0, c.ly);
    pz = fminf(fmaxf(pz + p.uz * t_x, c.z_lo), c.z_hi);
    if (ax == 0) {
      na = wrapi(na + sgx, g.ntx);
    } else if (ax == 1) {
      nb = wrapi(nb + sgy, g.nty);
    } else {
      nc += sgz;
    }
  }
  p.x = px;
  p.y = py;
  p.z = pz;
  p.tl = (na * g.nty + nb) * g.ntz + nc;
}

template <int NCOMP, bool ANALYTIC, bool RR, bool REFILL>
__global__ void __launch_bounds__(kThreads)
tile_steps(const float* __restrict__ prm, const float* __restrict__ fields,
           const float* __restrict__ g_majs,
           const float* __restrict__ g_inv_a0,
           const float* __restrict__ g_inv_dd, float* __restrict__ st,
           int* __restrict__ tiles, int* __restrict__ quotas,
           float* __restrict__ acc, unsigned long long* __restrict__ counts,
           int n_pad, Plan g, int need_ssa, int need_f2, int inv_n_steps,
           int inv_len, int inv_smem, uint32_t seed, uint32_t step0,
           int k_steps, int follow, int skip_iters, int src) {
  extern __shared__ float smem[];
  __shared__ float s_maj[kMaxTiles + 1];
  float* s_a0 = smem;                             // [inv_len]
  float* s_dd = smem + (inv_smem ? inv_len : 0);  // [inv_len]
  for (int i = threadIdx.x; i <= g.n_tiles; i += blockDim.x) {
    s_maj[i] = g_majs[i];
  }
  if (!ANALYTIC && inv_smem) {
    for (int i = threadIdx.x; i < inv_len; i += blockDim.x) {
      s_a0[i] = g_inv_a0[i];
      s_dd[i] = g_inv_dd[i];
    }
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int t0 = j < n_pad ? tiles[j] : g.n_tiles;
  int quota = REFILL && j < n_pad ? quotas[j] : 0;
  unsigned int n_started = 0, n_work = 0, n_real = 0, n_steps = 0;
  if (t0 < g.n_tiles || quota > 0) {
    const Consts c = load_consts(prm);
    const Tables t{fields,   s_maj,       s_a0,     s_dd,
                   g_inv_a0, g_inv_dd,    inv_smem, inv_n_steps,
                   need_ssa, need_f2,
                   static_cast<long long>(g.nx) * g.ny * g.nz};
    Photon p{st[j],         st[n_pad + j],     st[2 * n_pad + j],
             st[3 * n_pad + j], st[4 * n_pad + j], st[5 * n_pad + j],
             st[6 * n_pad + j], t0};
    const uint32_t ul = static_cast<uint32_t>(j);
    // the tile the slot steps in: the pass mode's own tile, or (follow,
    // refill) the one it crossed into or was born in
    int cur = -1;
    Box b;
    for (int k = 0; k < k_steps; ++k) {
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      if (p.tl >= g.n_tiles) {
        if (!REFILL || quota <= 0) break;
        inject(p, c, g, src, ul, seed, ctr);
        quota -= 1;
        n_started += 1;
      }
      if (p.tl != cur) {
        if (!REFILL && !follow && cur >= 0) break;
        cur = p.tl;
        b = box_of(cur, g, c, s_maj);
      }
      n_steps += 1;
      tile_step<NCOMP, ANALYTIC, RR>(p, b, c, g, t, acc, skip_iters, ul, seed,
                                     ctr, n_real);
    }

    st[j] = p.x;
    st[n_pad + j] = p.y;
    st[2 * n_pad + j] = p.z;
    st[3 * n_pad + j] = p.ux;
    st[4 * n_pad + j] = p.uy;
    st[5 * n_pad + j] = p.uz;
    st[6 * n_pad + j] = p.w;
    tiles[j] = p.tl;
    if (REFILL) {
      quotas[j] = quota;
      n_work = p.tl < g.n_tiles || quota > 0;
    }
  }
  // exact integer counts: one 64-bit atomic per warp and count
  const unsigned int v[kCounts] = {n_started, n_work, n_steps, n_real};
#pragma unroll
  for (int i = 0; i < kCounts; ++i) {
    const unsigned int s = __reduce_add_sync(0xffffffffu, v[i]);
    if ((threadIdx.x & 31) == 0 && s) {
      atomicAdd(&counts[i], static_cast<unsigned long long>(s));
    }
  }
}

struct Args {
  const float *prm, *fields, *majs, *inv_a0, *inv_dd;
  float* st;
  int* tiles;
  int* quota;
  float* acc;
  unsigned long long* counts;
  int n_pad;
  Plan g;
  int need_ssa, need_f2, inv_n_steps, inv_len;
  uint32_t seed, step0;
  int k_steps, follow, skip_iters, src;
  size_t table_smem;
};

template <int NCOMP, bool ANALYTIC, bool RR, bool REFILL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = tile_steps<NCOMP, ANALYTIC, RR, REFILL>;
  // the inverse-CDF table goes to shared memory while it fits the budget
  const size_t inv_bytes = 2 * static_cast<size_t>(a.inv_len) * sizeof(float);
  const int inv_smem = !ANALYTIC && inv_bytes <= a.table_smem;
  const size_t smem = inv_smem ? inv_bytes : 0;
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n_pad + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.prm, a.fields, a.majs, a.inv_a0, a.inv_dd, a.st, a.tiles, a.quota,
      a.acc, a.counts, a.n_pad, a.g, a.need_ssa, a.need_f2, a.inv_n_steps,
      a.inv_len, inv_smem, a.seed, a.step0, a.k_steps, a.follow,
      a.skip_iters, a.src);
  return cudaGetLastError();
}

template <int NCOMP, bool ANALYTIC, bool RR>
cudaError_t launch_mode(const Args& a, int refill, cudaStream_t s) {
  return refill ? launch<NCOMP, ANALYTIC, RR, true>(a, s)
                : launch<NCOMP, ANALYTIC, RR, false>(a, s);
}

template <int NCOMP>
cudaError_t launch_flags(const Args& a, int analytic, int rr, int refill,
                         cudaStream_t s) {
  if (analytic) {
    return rr ? launch_mode<NCOMP, true, true>(a, refill, s)
              : launch_mode<NCOMP, true, false>(a, refill, s);
  }
  return rr ? launch_mode<NCOMP, false, true>(a, refill, s)
            : launch_mode<NCOMP, false, false>(a, refill, s);
}

}  // namespace

extern "C" int tile_kernel_num_params() { return N_PARAMS; }

// One launch over the pool (state st [7, n_pad]: x, y, z, ux, uy, uz, w;
// tiles [n_pad], n_tiles = DEAD): every slot takes up to k_steps steps,
// with counters step0 on, and its state and tile are updated in place.
// Pass mode (refill 0; quota unused): a slot steps while its photon stays
// in its tile (with follow, across tiles). Refill mode (refill 1): a dead
// slot whose quota [n_pad] is above 0 starts a photon of source kind src
// (SRC_*) and takes one from its quota; photons cross tiles. Adds the
// tallies into acc ([up nxy | down nxy | absorbed nxy]) and into counts
// [photons started, slots with work left, lane-steps run with a live
// photon, real collisions] (the first two 0 in pass mode). fields holds n_f
// per-cell fields in global cell order, majs the n_tiles majorants and a
// zero DEAD slot. table_smem is a block's shared-memory budget in bytes for
// the inverse-CDF table. Returns cudaGetLastError().
extern "C" int tile_kernel_launch(
    const float* prm, const float* fields, const float* majs,
    const float* inv_a0, const float* inv_dd, float* st, int* tiles,
    int* quota, float* acc, unsigned long long* counts, int n_pad, int nx,
    int ny, int nz, int tx, int ty, int tz, int ntx, int nty, int ntz,
    int n_f, int need_ssa, int need_f2, int ncomp, int analytic,
    int inv_n_steps, int inv_len, int use_rr, uint32_t seed, uint32_t step0,
    int k_steps, int follow, int skip_iters, int table_smem, int refill,
    int src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = ntx * nty * ntz;
  const int want_f = ncomp == 1 ? 1 + (need_ssa != 0) + (need_f2 != 0)
                                : 2 + (ncomp - 1) + ncomp;
  if (n_pad <= 0 || ncomp < 1 || ncomp > 3 || n_f != want_f ||
      tx <= 0 || ty <= 0 || tz <= 0 || ntx * tx != nx || nty * ty != ny ||
      ntz * tz != nz || n_tiles > kMaxTiles || k_steps < 0 ||
      skip_iters < 0 ||
      (!analytic && (inv_n_steps < 2 || inv_len < inv_n_steps)) ||
      table_smem < 0 || static_cast<size_t>(table_smem) > kMaxSmem ||
      (refill && (quota == nullptr || src < SRC_DIRECTIONAL ||
                  src > SRC_SPOTLIGHT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{prm,     fields,   majs,      inv_a0,
               inv_dd,  st,       tiles,     quota,
               acc,     counts,   n_pad,
               Plan{nx, ny, nz, tx, ty, tz, ntx, nty, ntz, n_tiles},
               need_ssa, need_f2, inv_n_steps, inv_len,
               seed,    step0,    k_steps,   follow,    skip_iters,
               src,     static_cast<size_t>(table_smem)};
  switch (ncomp) {
    case 1:
      return static_cast<int>(launch_flags<1>(a, analytic, use_rr, refill, s));
    case 2:
      return static_cast<int>(launch_flags<2>(a, analytic, use_rr, refill, s));
    default:
      return static_cast<int>(launch_flags<3>(a, analytic, use_rr, refill, s));
  }
}
