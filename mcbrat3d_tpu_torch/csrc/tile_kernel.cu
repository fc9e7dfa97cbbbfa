// Tiled dense-domain kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: mcbrat3d_tpu/transport/pallas_tile.py `_build_tile_kernel`, as
// launched by `_make_tile_launch` (one pass of the pass loop). The domain
// (a dense, full-rank extinction field past every template: the MODIS
// class) is cut into at most 127 tiles, each with its own Woodcock
// majorant. The photon pool is packed by the host into per-tile cohorts;
// in one pass every slot takes up to k_steps steps while its photon stays
// in its tile: a jump against the tile majorant clipped at the tile's box
// (plus the nudge); at a collision the cell (relative to the tile origin,
// clipped), the field fetch, the null-collision test, absorption, roulette
// and an analytic HG or tabulated inverse-CDF scatter with the rotation;
// at the box face either an exit through the domain top or bottom (decided
// by the tile's z index) with the exit column taken from the wrapped exit
// point relative to the tile and Lambertian reflection, or a step into the
// neighbouring tile along the crossing axis (periodic in x and y) followed
// by the chain that skips up to skip_iters empty tiles and parks at the
// domain's top and bottom tiles. It tallies flux up, flux down and
// absorption per column. In the tail of a batch (follow) the host skips the
// sort and a slot follows its photon into every tile it crosses into.
//
// Design. One thread per pool slot; the slot number keys the counter
// uniforms, so the kernel draws what the JAX kernel (interpret mode) and
// the plain PyTorch pass draw. A slot whose tile is DEAD (n_tiles) returns
// at once; the others load their state into registers, step until the
// photon leaves the tile, dies or k_steps are done, and write the state
// back. The TPU kernel's per-tile [*, 128] slabs, their DMA, the select
// chains that read them and the one-hot matrix tally are not carried over:
// the per-cell fields are read with __ldg from dense arrays in global cell
// order (the bench's extinction, 4 MB, stays in the 50 MB L2), the tile
// majorants (at most 127 and a zero DEAD slot) sit in shared memory, where
// the skip chain reads them too, the stacked inverse-CDF table goes to
// shared memory while it fits the caller's budget (else __ldg), and the
// tallies are float32 atomics into global [3, nx, ny]. Real collisions and
// lane-steps are counted as integers, reduced per warp, and added to two
// 64-bit counters.
//
// What bounds it on this card: the latency of the dependent per-step math
// (log1pf, the divisions, the box exit, the uniforms' integer mixing,
// sincosf and the HG or table sampling) with one pool of slots in flight,
// and the gathers of the field at random cells; its bytes (the state once
// per pass, the field, the tallies) and its operations are both far below
// the card's rates. It does no matrix work, so wgmma and TMA do not apply.
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
  P_ZLO, P_ZHI, P_NUDGE, P_TWO_PI, N_PARAMS
};

// K5 draw sites (tile_kernel.SITE_*).
enum : uint32_t {
  S_TAU = 3, S_COLLIDE = 4, S_ANGLE = 5, S_PHI = 6, S_ROULETTE = 7,
  S_COMPONENT = 8
};

// Grid and plan: cells, tile sizes in cells, tiles per axis.
struct Plan {
  int nx, ny, nz, tx, ty, tz, ntx, nty, ntz, n_tiles;
};

// A tile: its indices, first cell, box and majorant.
struct Box {
  int ta, tb, tc, gx0, gy0, gz0;
  float x0p, y0p, z0p, x1p, y1p, z1p, maj;
};

__device__ __forceinline__ Box box_of(int t, const Plan& g, float x0,
                                      float y0, float z0, float txp,
                                      float typ, float tzp,
                                      const float* s_maj) {
  Box b;
  const int nyz = g.nty * g.ntz;
  b.ta = t / nyz;
  const int rem = t - b.ta * nyz;
  b.tb = rem / g.ntz;
  b.tc = rem - b.tb * g.ntz;
  b.x0p = x0 + static_cast<float>(b.ta) * txp;
  b.y0p = y0 + static_cast<float>(b.tb) * typ;
  b.z0p = z0 + static_cast<float>(b.tc) * tzp;
  b.x1p = b.x0p + txp;
  b.y1p = b.y0p + typ;
  b.z1p = b.z0p + tzp;
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

template <int NCOMP, bool ANALYTIC, bool RR>
__global__ void __launch_bounds__(kThreads)
tile_steps(const float* __restrict__ prm, const float* __restrict__ fields,
           const float* __restrict__ g_majs,
           const float* __restrict__ g_inv_a0,
           const float* __restrict__ g_inv_dd, float* __restrict__ st,
           int* __restrict__ tiles, float* __restrict__ acc,
           unsigned long long* __restrict__ counts, int n_pad, Plan g,
           int need_ssa, int need_f2, int inv_n_steps, int inv_len,
           int inv_smem, uint32_t seed, uint32_t step0, int k_steps,
           int follow, int skip_iters) {
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
  unsigned int n_real = 0, n_steps = 0;
  if (t0 < g.n_tiles) {
    const float x0 = prm[P_X0], lx = prm[P_LX], y0 = prm[P_Y0];
    const float ly = prm[P_LY], z0 = prm[P_Z0];
    const float albedo = prm[P_ALBEDO], ssa_u = prm[P_SSA_U];
    const float g_u = prm[P_G_U], rr_w = prm[P_RR_W];
    const float half_rr = prm[P_HALF_RR];
    const float inv_dx = prm[P_INV_DX], inv_dy = prm[P_INV_DY];
    const float inv_dz = prm[P_INV_DZ];
    const float txp = prm[P_TXP], typ = prm[P_TYP], tzp = prm[P_TZP];
    const float z_max = prm[P_ZMAX], z_lo = prm[P_ZLO], z_hi = prm[P_ZHI];
    const float nudge = prm[P_NUDGE], two_pi = prm[P_TWO_PI];
    const int nxy = g.nx * g.ny;
    const long long n_cells = static_cast<long long>(nxy) * g.nz;

    // the tile the slot steps in (with follow, the one it crossed into)
    int cur = t0;
    Box b = box_of(cur, g, x0, y0, z0, txp, typ, tzp, s_maj);
    float x = st[j], y = st[n_pad + j], z = st[2 * n_pad + j];
    float ux = st[3 * n_pad + j], uy = st[4 * n_pad + j];
    float uz = st[5 * n_pad + j], w = st[6 * n_pad + j];
    int tl = t0;
    const uint32_t ul = static_cast<uint32_t>(j);

    for (int k = 0; k < k_steps && tl < g.n_tiles; ++k) {
      if (tl != cur) {
        if (!follow) break;
        cur = tl;
        b = box_of(cur, g, x0, y0, z0, txp, typ, tzp, s_maj);
      }
      const int ta = b.ta, tb = b.tb, tc = b.tc;
      const int gx0 = b.gx0, gy0 = b.gy0, gz0 = b.gz0;
      const float tx0p = b.x0p, ty0p = b.y0p, tz0p = b.z0p;
      const float tx1p = b.x1p, ty1p = b.y1p, tz1p = b.z1p;
      const float maj = b.maj;
      const uint32_t ctr = step0 + static_cast<uint32_t>(k);
      n_steps += 1;
      const float u_ang = uniform(ul, seed, ctr, S_ANGLE);
      const float phi_rot = two_pi * uniform(ul, seed, ctr, S_PHI);

      // ---- Woodcock jump against the tile majorant, clipped at the box --
      const float tau = -log1pf(-uniform(ul, seed, ctr, S_TAU));
      const float d_samp = maj > kTiny ? tau / fmaxf(maj, kTiny) : kBig;
      int axis;
      const float t_exit = exit_dist(x, y, z, ux, uy, uz, tx0p, tx1p, ty0p,
                                     ty1p, tz0p, tz1p, axis);

      if (d_samp < t_exit) {
        // ---- collision point and cell, relative to the tile origin ----
        const float xn = x + ux * d_samp;
        const float yn = y + uy * d_samp;
        const float zn = z + uz * d_samp;
        const int lix = clampi(static_cast<int>((xn - tx0p) * inv_dx),
                               g.tx - 1);
        const int liy = clampi(static_cast<int>((yn - ty0p) * inv_dy),
                               g.ty - 1);
        const int liz = clampi(static_cast<int>((zn - tz0p) * inv_dz),
                               g.tz - 1);
        const int col = (gx0 + lix) * g.ny + (gy0 + liy);
        const long long cell = static_cast<long long>(col) * g.nz + gz0 + liz;
        x = xn;
        y = yn;
        z = fminf(fmaxf(zn, z0), z_max);
        const float beta = __ldg(fields + cell);
        if (!(uniform(ul, seed, ctr, S_COLLIDE) * maj < beta)) continue;
        n_real += 1;

        // ---- real collision: fields, absorption, roulette ----
        float ssa, f2;
        if (NCOMP == 1) {
          ssa = need_ssa ? __ldg(fields + n_cells + cell) : ssa_u;
          f2 = need_f2 ? __ldg(fields + (1 + need_ssa) * n_cells + cell)
                       : g_u;
        } else {
          // effective ssa; the component by one uniform against the
          // cumulative scattering fractions
          ssa = __ldg(fields + n_cells + cell);
          const float u_cmp = uniform(ul, seed, ctr, S_COMPONENT);
          int c = u_cmp >= __ldg(fields + 2 * n_cells + cell) ? 1 : 0;
          if (NCOMP == 3 && u_cmp >= __ldg(fields + 3 * n_cells + cell)) c = 2;
          f2 = __ldg(fields + (1 + NCOMP + c) * n_cells + cell);
        }
        const float absorbed = w * (1.f - ssa);
        w = w * ssa;
        if (absorbed != 0.f) atomicAdd(&acc[2 * nxy + col], absorbed);
        if (RR && w < half_rr) {
          w = uniform(ul, seed, ctr, S_ROULETTE) < w / rr_w ? rr_w : 0.f;
        }
        if (w <= kTiny) {
          tl = g.n_tiles;
          break;
        }

        // ---- scatter: analytic HG or the tabulated inverse CDF ----
        float cos_t;
        if (ANALYTIC) {
          cos_t = mcb::hg_cos(f2, u_ang);
        } else {
          const float t_u = u_ang * static_cast<float>(inv_n_steps - 1);
          int ki = static_cast<int>(t_u);
          ki = ki < 0 ? 0 : (ki > inv_n_steps - 2 ? inv_n_steps - 2 : ki);
          const float frac = t_u - static_cast<float>(ki);
          const int flat =
              (NCOMP > 1 || need_f2)
                  ? static_cast<int>(f2 + 0.5f) * inv_n_steps + ki
                  : ki;
          cos_t = cosf(table(s_a0, g_inv_a0, flat, inv_smem) +
                       frac * table(s_dd, g_inv_dd, flat, inv_smem));
        }
        mcb::rotate(ux, uy, uz, cos_t, phi_rot);
        continue;
      }

      // ---- the box face: domain exits are topological, by the tile's z
      // index ----
      const bool exit_top = axis == 2 && uz > 0.f && tc == g.ntz - 1;
      const bool exit_bot = axis == 2 && uz < 0.f && tc == 0;
      if (exit_top || exit_bot) {
        // exit column from the wrapped exit point relative to the tile
        const float z_b = exit_top ? z_max : z0;
        const float t_b = (z_b - z) / (fabsf(uz) < 1e-12f ? 1.f : uz);
        const float xe = x0 + wrap((x + ux * t_b) - x0, lx);
        const float ye = y0 + wrap((y + uy * t_b) - y0, ly);
        const int lixe = clampi(static_cast<int>((xe - tx0p) * inv_dx),
                                g.tx - 1);
        const int liye = clampi(static_cast<int>((ye - ty0p) * inv_dy),
                                g.ty - 1);
        const int col_e = (gx0 + lixe) * g.ny + (gy0 + liye);
        atomicAdd(&acc[(exit_top ? 0 : nxy) + col_e], w);
        if (exit_top) {
          tl = g.n_tiles;
          break;
        }
        // ---- Lambertian reflection (reuses u_ang and phi_rot) ----
        const float w_refl = w * albedo;
        x = xe;
        y = ye;
        z = z_lo;
        if (w_refl <= kTiny) {
          tl = g.n_tiles;
          break;
        }
        const float mu_new = sqrtf(fmaxf(u_ang, 1e-12f));
        const float sin_new = sqrtf(fmaxf(0.f, 1.f - mu_new * mu_new));
        float sp, cp;
        sincosf(phi_rot, &sp, &cp);
        ux = sin_new * cp;
        uy = sin_new * sp;
        uz = mu_new;
        w = w_refl;
        continue;
      }

      // ---- into the neighbouring tile along the crossing axis ----
      const float d = t_exit + nudge;
      float px = x0 + wrap((x + ux * d) - x0, lx);
      float py = y0 + wrap((y + uy * d) - y0, ly);
      float pz = fminf(fmaxf(z + uz * d, z_lo), z_hi);
      const int sgx = ux >= 0.f ? 1 : -1, sgy = uy >= 0.f ? 1 : -1;
      const int sgz = uz >= 0.f ? 1 : -1;
      int na = ta, nb = tb, nc = tc;
      if (axis == 0) {
        na = wrapi(ta + sgx, g.ntx);
      } else if (axis == 1) {
        nb = wrapi(tb + sgy, g.nty);
      } else {
        nc = tc + sgz;
      }
      // ---- empty-tile skip chain: no collision can happen where the
      // majorant is zero; crossings out of the domain top or bottom park
      for (int i = 0; i < skip_iters; ++i) {
        const int tn = (na * g.nty + nb) * g.ntz + nc;
        if (s_maj[tn < g.n_tiles ? tn : g.n_tiles] > 0.f) break;
        const float bx0 = x0 + static_cast<float>(na) * txp;
        const float by0 = y0 + static_cast<float>(nb) * typ;
        const float bz0 = z0 + static_cast<float>(nc) * tzp;
        int ax;
        const float t_x = exit_dist(px, py, pz, ux, uy, uz, bx0, bx0 + txp,
                                    by0, by0 + typ, bz0, bz0 + tzp, ax) +
                          nudge;
        if (ax == 2 && ((nc == g.ntz - 1 && uz > 0.f) ||
                        (nc == 0 && uz < 0.f))) {
          break;
        }
        px = x0 + wrap((px + ux * t_x) - x0, lx);
        py = y0 + wrap((py + uy * t_x) - y0, ly);
        pz = fminf(fmaxf(pz + uz * t_x, z_lo), z_hi);
        if (ax == 0) {
          na = wrapi(na + sgx, g.ntx);
        } else if (ax == 1) {
          nb = wrapi(nb + sgy, g.nty);
        } else {
          nc += sgz;
        }
      }
      x = px;
      y = py;
      z = pz;
      tl = (na * g.nty + nb) * g.ntz + nc;
    }

    st[j] = x;
    st[n_pad + j] = y;
    st[2 * n_pad + j] = z;
    st[3 * n_pad + j] = ux;
    st[4 * n_pad + j] = uy;
    st[5 * n_pad + j] = uz;
    st[6 * n_pad + j] = w;
    tiles[j] = tl;
  }
  // exact integer counts: one 64-bit atomic per warp
  n_real = __reduce_add_sync(0xffffffffu, n_real);
  n_steps = __reduce_add_sync(0xffffffffu, n_steps);
  if ((threadIdx.x & 31) == 0) {
    if (n_real) atomicAdd(&counts[0], static_cast<unsigned long long>(n_real));
    if (n_steps) {
      atomicAdd(&counts[1], static_cast<unsigned long long>(n_steps));
    }
  }
}

struct Args {
  const float *prm, *fields, *majs, *inv_a0, *inv_dd;
  float* st;
  int* tiles;
  float* acc;
  unsigned long long* counts;
  int n_pad;
  Plan g;
  int need_ssa, need_f2, inv_n_steps, inv_len;
  uint32_t seed, step0;
  int k_steps, follow, skip_iters;
  size_t table_smem;
};

template <int NCOMP, bool ANALYTIC, bool RR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = tile_steps<NCOMP, ANALYTIC, RR>;
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
      a.prm, a.fields, a.majs, a.inv_a0, a.inv_dd, a.st, a.tiles, a.acc,
      a.counts, a.n_pad, a.g, a.need_ssa, a.need_f2, a.inv_n_steps,
      a.inv_len, inv_smem, a.seed, a.step0, a.k_steps, a.follow,
      a.skip_iters);
  return cudaGetLastError();
}

template <int NCOMP>
cudaError_t launch_flags(const Args& a, int analytic, int rr,
                         cudaStream_t s) {
  if (analytic) {
    return rr ? launch<NCOMP, true, true>(a, s)
              : launch<NCOMP, true, false>(a, s);
  }
  return rr ? launch<NCOMP, false, true>(a, s)
            : launch<NCOMP, false, false>(a, s);
}

}  // namespace

extern "C" int tile_kernel_num_params() { return N_PARAMS; }

// One pass over the packed pool (state st [7, n_pad]: x, y, z, ux, uy, uz,
// w; tiles [n_pad], n_tiles = DEAD): every slot takes up to k_steps steps,
// with counters step0 on, while its photon stays in its tile (with follow,
// across tiles), and its state and tile are updated in place. Adds the tallies into acc ([up nxy | down nxy | absorbed nxy]),
// the real collisions into counts[0] and the lane-steps run with a live
// photon into counts[1]. fields holds n_f per-cell fields in global cell
// order, majs the n_tiles majorants and a zero DEAD slot. table_smem is a
// block's shared-memory budget in bytes for the inverse-CDF table. Returns
// cudaGetLastError().
extern "C" int tile_kernel_launch(
    const float* prm, const float* fields, const float* majs,
    const float* inv_a0, const float* inv_dd, float* st, int* tiles,
    float* acc, unsigned long long* counts, int n_pad, int nx, int ny, int nz,
    int tx, int ty, int tz, int ntx, int nty, int ntz, int n_f, int need_ssa,
    int need_f2, int ncomp, int analytic, int inv_n_steps, int inv_len,
    int use_rr, uint32_t seed, uint32_t step0, int k_steps, int follow,
    int skip_iters, int table_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = ntx * nty * ntz;
  const int want_f = ncomp == 1 ? 1 + (need_ssa != 0) + (need_f2 != 0)
                                : 2 + (ncomp - 1) + ncomp;
  if (n_pad <= 0 || ncomp < 1 || ncomp > 3 || n_f != want_f ||
      tx <= 0 || ty <= 0 || tz <= 0 || ntx * tx != nx || nty * ty != ny ||
      ntz * tz != nz || n_tiles > kMaxTiles || k_steps < 0 ||
      skip_iters < 0 ||
      (!analytic && (inv_n_steps < 2 || inv_len < inv_n_steps)) ||
      table_smem < 0 || static_cast<size_t>(table_smem) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{prm,     fields,   majs,      inv_a0,
               inv_dd,  st,       tiles,     acc,
               counts,  n_pad,
               Plan{nx, ny, nz, tx, ty, tz, ntx, nty, ntz, n_tiles},
               need_ssa, need_f2, inv_n_steps, inv_len,
               seed,    step0,    k_steps,   follow,    skip_iters,
               static_cast<size_t>(table_smem)};
  switch (ncomp) {
    case 1:
      return static_cast<int>(launch_flags<1>(a, analytic, use_rr, s));
    case 2:
      return static_cast<int>(launch_flags<2>(a, analytic, use_rr, s));
    default:
      return static_cast<int>(launch_flags<3>(a, analytic, use_rr, s));
  }
}
