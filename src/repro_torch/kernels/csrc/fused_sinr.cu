// Fused CRRM pipeline D -> G -> RSRP -> (total, argmax, serving row) on Hopper.
//
// Replaces the Pallas TPU kernel fused_sinr_accumulate,
// src/repro/kernels/fused_sinr.py:139 (body _make_kernel).  For every output
// row r -- UE row idx[r] of U when an index is given, row r otherwise -- it
// streams all M cells in index order and keeps
//
//   total[r, k]  = sum_j r_ijk               (interference + wanted)
//   best_val[r]  = max_j meas_ij             (wideband measurement)
//   best_idx[r]  = argmax_j meas_ij          (attachment, lowest index wins)
//   w_best[r, k] = r_{i, best_idx, k}        (serving row)
//
// so the (N, M) distance, gain and RSRP matrices never reach device memory.
//
// Design.
// * A group of G lanes (a template parameter) owns one UE row.  Lane l
//   takes the cells l, l+G, l+2G, ... and keeps a partial total and a
//   partial best (value, index, serving row); within a lane the strict '>'
//   keeps the lowest index.  The group then merges over log2(G)
//   __shfl_xor_sync steps: totals add, and a lane takes its partner's best
//   when it is larger, or equal with a lower index -- jnp.argmax's
//   tie-break, across lanes too.  A group reads the contiguous M*K fading
//   floats of its row (coalesced), and a lane's dependent chain is M/G links
//   long.  Every launch takes G = 8: on an H100 it is the fastest at
//   100 000 rows for every M timed (126 to 600), and within 6 % of G = 16 at
//   10 000 rows (PERF.md).  G = 16 and 32 are built for the UMa/UMi family
//   at K <= 4 only, so that chip_smoke.py and the card tests can time and
//   check them.
// * Cells (x, y, z, boresight as one float4, powers k-major, per-cell
//   constants of the model) are staged in shared memory in tiles of TILE_M,
//   so neighbouring lanes read neighbouring words.  When M <= TILE_M a block
//   stages them once and walks its rows grid-stride (one wave of blocks).
// * A lane takes its links four at a time (fewer for K > 4), their fading
//   loads issued first; a link past the tile's end is computed on an earlier
//   cell and masked, so every step is one branch-free block in which the
//   links interleave.  The common case -- no fading, one sector, no
//   attach_on_mean -- is a compile-time path without those tests.
// * The pathloss family is a template parameter (UMa and UMi share one), so
//   no switch sits in the link loop.  Each model's constants are folded on
//   the host in float64 (kernel_spec() in repro_torch/sim/pathloss.py; the
//   layouts are listed at each family below) into a log2-gain form: a link
//   costs one log2 of d3d^2 and one exp2 of the log2 gain.  Distances are
//   compared on squares (no sqrtf but RMa's linear term).  The breakpoint
//   term log2(d_bp^2 + dh^2) depends on the two heights only: when a tile's
//   cells share one height it is computed once per row, else per link.
//   UMa and UMi are continuous at the breakpoint (at d2d = d_bp,
//   40 lg d3d - 9 lg d3d^2 = 22 lg d3d), so a link whose squared compare
//   flips by an ulp against the plain version's sqrt compare changes its
//   pathloss only by rounding; RMa jumps by < 0.01 dB there, and a flip
//   needs q2 within an ulp of d_bp^2.
// * Sectored: the bearing offset is wrapped by off - 2 pi rint(off / 2 pi)
//   instead of atan2(sin, cos); near +-pi the attenuation clamps at 30 dB,
//   so the side of the wrap cannot change the result.  The attenuation is
//   added to the log2 gain before the one exp2.
// * Dirty rows by index: the kernel reads U[idx[r]] and fading row idx[r]
//   itself (int32 or int64 index, repeats allowed) and writes compact rows.
//   The range is the caller's contract; a row whose index is out of range
//   reads nothing and gets NaN outputs and attachment -1.
//
// Bound: with no fading, operations; the special-function pipe's results
// per link need about a third of the kernel's time at M = 127, and no
// profiler reading says which of instruction issue, latency or occupancy
// holds the rest (PERF.md).  With per-RB fading, the (R, M, K) fading rows
// are read once, which sets a byte bound.
//
// Accuracy: built without --use_fast_math, with the accurate log2f and
// exp2f.  chip_smoke.py prints the per-link gain's error against the plain
// version and against a float64 evaluation, and holds the attachment to a
// float64 argmax.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int TILE_M = 256;
constexpr int MAX_PL_PARAMS = 64;
constexpr int MAX_K = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -3.4e38f;
// log2(gain) = -S_DB * pathloss(dB)
constexpr float S_DB = 0.33219280948873623f;          // 0.1 * log2(10)
constexpr float INV_LOG2_10 = 0.30102999566398120f;   // log10(x) = log2(x) * this
constexpr float TWO_PI = 6.283185307179586f;
constexpr float INV_TWO_PI = 0.15915494309189535f;
// stock 3GPP horizontal pattern, 65 deg half-power beamwidth, 30 dB floor:
// att = min(12 (off / phi3)^2, 30) dB, as log2 gain
constexpr float SECT_A = -S_DB * 12.0f / (1.1344640137963142f * 1.1344640137963142f);
constexpr float SECT_FLOOR = -S_DB * 30.0f;

// model ids (repro_torch/sim/pathloss.py PL_*) and the template families
enum Family { F_RMA = 0, F_RMA_DISC = 1, F_UM = 2, F_INH = 4, F_POW = 5 };

// passed by value: lands in the kernel's constant parameter bank
struct PLParams {
  float v[MAX_PL_PARAMS];
};

struct Args {
  const float* U;      // (N, 3)
  const float* C;      // (M, 3)
  const float* P;      // (M, K)
  const float* bore;   // (M,)
  const float* fad;    // none / (N, M) / (N, M, K)
  const void* idx;     // none / (R,) int32 / (R,) int64
  float* total;        // (R, K)
  float* best_val;     // (R,)
  int* best_idx;       // (R,)
  float* w_best;       // (R, K)
  int N, R, M, K;
  int fad_mode;        // 0 none, 1 wideband (N, M), 2 per-RB (N, M, K)
  int idx_bits;        // 0 none, 32, 64
  int attach_on_mean;
  int n_sectors;
};

// log2 of x clamped below at lo (the plain version's clamps)
__device__ __forceinline__ float log2c(float x, float lo) {
  return log2f(fmaxf(x, lo));
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// Each family: per-cell constants staged in shared memory (cell), per-row
// constants (Row, row), the terms that depend on the two heights only
// (Heights, heights; kHeights says whether there are any) and the log2 gain
// of one link (log2gain) from q2 = d2d^2, q3 = d3d^2.
// L3 = log2(max(q3, 1e-18)) = 2 log2(max(d3d, 1e-9)).  The folded forms equal
// the formulas for d3d >= 1e-9 m, where the plain version's clamps are idle.
template <int F>
struct PL;

// 3GPP UMa / UMi: v = kappa, c1, s1, c2, s2, t2, LOS, cn, sn, hn
//   d_bp = kappa (h_bs - 1)(h_ut - 1)
//   LOS  = d2d <= d_bp ? c1 + s1 L3
//                      : c2 + t2 log2(max(d_bp^2 + (h_bs - h_ut)^2, 1e-9)) + s2 L3
//   NLOS = min(LOS, cn + hn h_ut + sn L3)
template <>
struct PL<F_UM> {
  static constexpr bool kHeights = true;
  struct Row { float kh, hu, cn; };
  struct Heights { float bp2, c2; };
  static __device__ __forceinline__ void cell(const PLParams&, float hb,
                                              float& a, float& b, float& c) {
    a = hb - 1.0f;
    b = c = 0.0f;
  }
  static __device__ __forceinline__ Row row(const PLParams& p, float hu) {
    return {p.v[0] * (hu - 1.0f), hu, fmaf(p.v[9], hu, p.v[7])};
  }
  static __device__ __forceinline__ Heights heights(const PLParams& p,
                                                    const Row& r, float hb,
                                                    float a) {
    const float dbp = a * r.kh;
    const float dh = hb - r.hu;
    // d_bp < 0 (a UE below 1 m): never the near branch
    return {dbp >= 0.0f ? dbp * dbp : -1.0f,
            fmaf(p.v[5], log2c(fmaf(dbp, dbp, dh * dh), 1e-9f), p.v[3])};
  }
  static __device__ __forceinline__ float log2gain(const PLParams& p,
                                                   const Row& r,
                                                   const Heights& h, float q2,
                                                   float q3, float, float) {
    const float L3 = log2c(q3, 1e-18f);
    float lg = q2 <= h.bp2 ? fmaf(p.v[2], L3, p.v[1]) : fmaf(p.v[4], L3, h.c2);
    if (p.v[6] == 0.0f) lg = fminf(lg, fmaf(p.v[8], L3, r.cn));
    return lg;
  }
};

// RMa: v = kappa, C0, s1, lin, LOS, fixed, hb_fixed, hu_fixed, Kc, h
//   (with fixed != 0 the pathloss reads hb_fixed / hu_fixed, not positions)
//   d_bp = kappa h_bs h_ut;  pl1(d) = C0 + s1 log2(d^2) + lin d
//   LOS  = d2d <= d_bp ? pl1(d3d) : pl1(d_bp) + 4 log2(max(d_bp, 1)) - 2 L3
//   NLOS = min(LOS, Kc + kcell(h_bs) + kue(h_ut) + sB(h_bs) L3), with
//   lhb = lg h_bs, B = 43.42 - 3.1 lhb, sB = -B / 20,
//   kcell = -S (-(24.37 - 3.7 (h / h_bs)^2) lhb - 3 B)   (staged per cell)
//   kue = 3.2 S lg(11.75 h_ut)^2                           (per row)
template <>
struct PL<F_RMA> {
  static constexpr bool kHeights = true;
  struct Row { float kh, kue; };
  struct Heights { float bp2, c2; };
  static __device__ __forceinline__ void cell(const PLParams& p, float z,
                                              float& a, float& b, float& c) {
    const float hb = p.v[5] != 0.0f ? p.v[6] : z;
    const float lhb = log2c(hb, 1e-9f) * INV_LOG2_10;
    const float B = 43.42f - 3.1f * lhb;
    const float hh = p.v[9] / hb;
    a = hb;
    b = p.v[8] - S_DB * (-(24.37f - 3.7f * hh * hh) * lhb - 3.0f * B);
    c = -0.05f * B;
  }
  static __device__ __forceinline__ Row row(const PLParams& p, float z) {
    const float hu = p.v[5] != 0.0f ? p.v[7] : z;
    const float lu = log2c(11.75f * hu, 1e-9f) * INV_LOG2_10;
    return {p.v[0] * hu, 3.2f * S_DB * lu * lu};
  }
  static __device__ __forceinline__ Heights heights(const PLParams& p,
                                                    const Row& r, float,
                                                    float a) {
    const float dbp = a * r.kh;
    return {dbp >= 0.0f ? dbp * dbp : -1.0f,
            p.v[1] + 2.0f * p.v[2] * log2c(dbp, 1e-9f) + p.v[3] * dbp +
                4.0f * log2c(dbp, 1.0f)};
  }
  static __device__ __forceinline__ float log2gain(const PLParams& p,
                                                   const Row& r,
                                                   const Heights& h, float q2,
                                                   float q3, float b, float c) {
    const float L3 = log2c(q3, 1e-18f);
    float lg = q2 <= h.bp2 ? fmaf(p.v[3], sqrtf(q3), fmaf(p.v[2], L3, p.v[1]))
                           : fmaf(-2.0f, L3, h.c2);
    if (p.v[4] == 0.0f) lg = fminf(lg, fmaf(c, L3, b + r.kue));
    return lg;
  }
};

// The families below have no height-only terms.
struct NoHeights {
  static constexpr bool kHeights = false;
  struct Heights {};
  static __device__ __forceinline__ void cell(const PLParams&, float, float& a,
                                              float& b, float& c) {
    a = b = c = 0.0f;
  }
};

// RMa over a height LUT: v = C0, s1, lin, LOS, h_min, h_step, sn, H, then
// per height bin k at v[8 + 3k]: d_bp, c2, cn
//   k = clamp(rint((h_ut - h_min) / h_step), 0, H - 1)
//   LOS  = d2d <= d_bp ? C0 + s1 L3 + lin d3d : c2 - 2 L3
//   NLOS = min(LOS, cn + sn L3)
template <>
struct PL<F_RMA_DISC> : NoHeights {
  struct Row { float bp2, c2, cn; };
  static __device__ __forceinline__ Row row(const PLParams& p, float hu) {
    const int H = static_cast<int>(p.v[7]);
    int k = static_cast<int>(rintf((hu - p.v[4]) / p.v[5]));
    k = min(max(k, 0), H - 1);
    const float dbp = p.v[8 + 3 * k];
    return {dbp >= 0.0f ? dbp * dbp : -1.0f, p.v[9 + 3 * k], p.v[10 + 3 * k]};
  }
  static __device__ __forceinline__ Heights heights(const PLParams&,
                                                    const Row&, float, float) {
    return {};
  }
  static __device__ __forceinline__ float log2gain(const PLParams& p,
                                                   const Row& r,
                                                   const Heights&, float q2,
                                                   float q3, float, float) {
    const float L3 = log2c(q3, 1e-18f);
    float lg = q2 <= r.bp2 ? fmaf(p.v[2], sqrtf(q3), fmaf(p.v[1], L3, p.v[0]))
                           : fmaf(-2.0f, L3, r.c2);
    if (p.v[3] == 0.0f) lg = fminf(lg, fmaf(p.v[6], L3, r.cn));
    return lg;
  }
};

// InH office: v = c1, s1, LOS, cn, sn
//   LOS = c1 + s1 L3;  NLOS = min(LOS, cn + sn L3)
template <>
struct PL<F_INH> : NoHeights {
  struct Row {};
  static __device__ __forceinline__ Row row(const PLParams&, float) { return {}; }
  static __device__ __forceinline__ Heights heights(const PLParams&,
                                                    const Row&, float, float) {
    return {};
  }
  static __device__ __forceinline__ float log2gain(const PLParams& p,
                                                   const Row&, const Heights&,
                                                   float, float q3, float,
                                                   float) {
    const float L3 = log2c(q3, 1e-18f);
    float lg = fmaf(p.v[1], L3, p.v[0]);
    if (p.v[2] == 0.0f) lg = fminf(lg, fmaf(p.v[4], L3, p.v[3]));
    return lg;
  }
};

// power law g = max(d3d / d0, 1e-9)^-alpha: v = -alpha / 2, 1 / d0^2
//   log2 g = v0 log2(max(q3 v1, 1e-18))
template <>
struct PL<F_POW> : NoHeights {
  struct Row {};
  static __device__ __forceinline__ Row row(const PLParams&, float) { return {}; }
  static __device__ __forceinline__ Heights heights(const PLParams&,
                                                    const Row&, float, float) {
    return {};
  }
  static __device__ __forceinline__ float log2gain(const PLParams& p,
                                                   const Row&, const Heights&,
                                                   float, float q3, float,
                                                   float) {
    return p.v[0] * log2c(q3 * p.v[1], 1e-18f);
  }
};

struct Tile {
  float4 pos[TILE_M];   // x, y, z, boresight: one 16-byte load per link
  float ca[TILE_M], cb[TILE_M], cc[TILE_M];
};

// Stages cells [j0, j0 + m) and returns, to every thread of the block,
// whether they all share one height (then a row's height-only terms are
// computed once, not per link).
template <int F, int KMAX>
__device__ __forceinline__ bool stage(const Args& a, const PLParams& pl,
                                      int j0, int m, Tile& t, float* sp) {
  for (int s = threadIdx.x; s < m; s += BLOCK) {
    const int j = j0 + s;
    const float z = a.C[3 * j + 2];
    t.pos[s] = make_float4(a.C[3 * j], a.C[3 * j + 1], z, a.bore[j]);
    PL<F>::cell(pl, z, t.ca[s], t.cb[s], t.cc[s]);
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < a.K) sp[k * TILE_M + s] = a.P[static_cast<size_t>(j) * a.K + k];
  }
  __syncthreads();
  bool same = true;
  for (int s = threadIdx.x; s < m; s += BLOCK)
    same = same && t.pos[s].z == t.pos[0].z && t.ca[s] == t.ca[0];
  return __syncthreads_and(same) != 0;
}

// The links of one UE row with the staged cells [0, m) of a tile: gain,
// RSRP row, running total and best (strict '>': the lowest index of this
// lane wins a tie).  PER_LINK computes the height-only terms for every link
// (cells of different heights); otherwise once, from the tile's one height.
template <int F, int KMAX, int G, bool PER_LINK, bool SIMPLE>
__device__ __forceinline__ void links(
    const Args& a, const PLParams& pl, const typename PL<F>::Row& row,
    const Tile& t, const float* sp, int j0, int m, int lane, float ux,
    float uy, float uz, const float* frow, bool vec4, float (&tot)[KMAX],
    float (&wb)[KMAX], float& bv, int& bi) {
  // SIMPLE: no fading, one sector, no attach_on_mean, known at compile time
  const int fad_mode = SIMPLE ? 0 : a.fad_mode;
  const bool sectored = !SIMPLE && a.n_sectors > 1;
  const bool on_mean = !SIMPLE && a.attach_on_mean;
  typename PL<F>::Heights h0{};
  if constexpr (!PER_LINK) h0 = PL<F>::heights(pl, row, t.pos[0].z, t.ca[0]);
  // a link past the tile's end (valid false) reads an earlier cell and adds
  // nothing: the last step stays one branch-free block for every lane
  auto link = [&](int jj, bool valid, const float* f, float fw) {
    const float4 c = t.pos[jj];
    const float dx = ux - c.x;
    const float dy = uy - c.y;
    const float dz = uz - c.z;
    const float q2 = dx * dx + dy * dy;
    const float q3 = q2 + dz * dz;
    typename PL<F>::Heights h = h0;
    if constexpr (PER_LINK) h = PL<F>::heights(pl, row, c.z, t.ca[jj]);
    float lg = PL<F>::log2gain(pl, row, h, q2, q3, t.cb[jj], t.cc[jj]);
    if (sectored) {
      float off = atan2f(dy, dx) - c.w;
      off = fmaf(-TWO_PI, rintf(off * INV_TWO_PI), off);
      lg += fmaxf(SECT_A * off * off, SECT_FLOOR);
    }
    const float g = exp2f(lg);
    const float gw = fad_mode == 1 ? g * fw : g;
    float rr[KMAX];
    float meas = 0.0f, mean = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      rr[k] = 0.0f;
      if (k == 0 || k < a.K) {   // K >= 1
        const float p = sp[k * TILE_M + jj];
        rr[k] = (fad_mode == 2 ? g * f[k] : gw) * p;
        meas = k == 0 ? rr[0] : meas + rr[k];
        if (on_mean) mean = k == 0 ? g * p : fmaf(g, p, mean);
        tot[k] += valid ? rr[k] : 0.0f;
      }
    }
    if (on_mean) meas = mean;
    if (valid && meas > bv) {
      bv = meas;
      bi = j0 + jj;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) wb[k] = rr[k];
    }
  };
  // UNR links per lane per step, their fading loads issued first so that up
  // to UNR * 16 bytes per lane are in flight before any is used; the steps
  // carry no branch, so the UNR links interleave
  constexpr int UNR = KMAX <= 4 ? 4 : (KMAX <= 8 ? 2 : 1);
  auto load = [&](int jj, bool valid, float* f, float& fw) {
    fw = 1.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) f[k] = 0.0f;
    if (fad_mode == 0) return;
    const size_t link_at = static_cast<size_t>(j0 + jj);
    if (fad_mode == 1) {
      fw = valid ? __ldcs(frow + link_at) : 1.0f;
      return;
    }
    const float* fl = frow + link_at * a.K;
    if constexpr (KMAX == 4) {
      if (vec4) {   // K == 4 on a 16-byte boundary: one 16-byte load
        const float4 v = valid ? __ldcs(reinterpret_cast<const float4*>(fl))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        f[0] = v.x;
        f[1] = v.y;
        f[2] = v.z;
        f[3] = v.w;
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < a.K) f[k] = valid ? __ldcs(fl + k) : 0.0f;
  };
  for (int jb = lane; jb < m; jb += UNR * G) {
    float f[UNR][KMAX];
    float fw[UNR];
    bool valid[UNR];
    int jj[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      valid[u] = jb + u * G < m;
      jj[u] = valid[u] ? jb + u * G : jb;
      load(jj[u], valid[u], f[u], fw[u]);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) link(jj[u], valid[u], f[u], fw[u]);
  }
}

// Resident blocks per SM asked of the register allocator: it then keeps
// K = 1 at 40 and K = 4 at 64 registers a thread (a few bytes spill), which
// measured faster than the fewer blocks it would otherwise fit (PERF.md).
constexpr int min_blocks(int kmax) { return kmax == 1 ? 6 : kmax == 4 ? 4 : 1; }

template <int F, int KMAX, int G>
__global__ void __launch_bounds__(BLOCK, min_blocks(KMAX))
fused_sinr_kernel(const Args a, const PLParams pl) {
  static_assert(G == 8 || G == 16 || G == 32, "lane group of 8, 16 or 32");
  constexpr int ROWS = BLOCK / G;
  __shared__ Tile t;
  __shared__ float sp[KMAX * TILE_M];

  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const bool one_tile = a.M <= TILE_M;
  bool uniform = false;
  if (one_tile) uniform = stage<F, KMAX>(a, pl, 0, a.M, t, sp);
  const bool vec4 = KMAX == 4 && a.K == 4 && a.fad_mode == 2 &&
                    (reinterpret_cast<uintptr_t>(a.fad) & 15) == 0;
  const size_t fad_row = static_cast<size_t>(a.M) * (a.fad_mode == 2 ? a.K : 1);
  const bool simple = a.fad_mode == 0 && a.n_sectors <= 1 && !a.attach_on_mean;

  for (int base = blockIdx.x * ROWS; base < a.R; base += gridDim.x * ROWS) {
    const int r = base + grp;
    long long ue = r;
    if (r < a.R && a.idx_bits == 32) ue = static_cast<const int*>(a.idx)[r];
    else if (r < a.R && a.idx_bits == 64) ue = static_cast<const long long*>(a.idx)[r];
    const bool live = r < a.R && ue >= 0 && ue < a.N;
    float ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (live) {
      ux = a.U[3 * ue];
      uy = a.U[3 * ue + 1];
      uz = a.U[3 * ue + 2];
    }
    const typename PL<F>::Row row = PL<F>::row(pl, uz);
    const float* frow = a.fad_mode != 0 && live ? a.fad + ue * fad_row : nullptr;
    float tot[KMAX], wb[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) tot[k] = wb[k] = 0.0f;
    float bv = NEG_BIG;
    int bi = 0;

    for (int j0 = 0; j0 < a.M; j0 += TILE_M) {
      const int m = min(TILE_M, a.M - j0);
      if (!one_tile) {
        __syncthreads();
        uniform = stage<F, KMAX>(a, pl, j0, m, t, sp);
      }
      if (!live) continue;
#define FS_LINKS(PER_LINK, SIMPLE)                                          \
  links<F, KMAX, G, PER_LINK, SIMPLE>(a, pl, row, t, sp, j0, m, lane, ux, uy, \
                                      uz, frow, vec4, tot, wb, bv, bi)
      if constexpr (PL<F>::kHeights) {
        if (!uniform) {
          if (simple) FS_LINKS(true, true); else FS_LINKS(true, false);
          continue;
        }
      }
      if (simple) FS_LINKS(false, true); else FS_LINKS(false, false);
#undef FS_LINKS
    }

    // merge the G lanes of the group: every lane of the warp takes part
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const bool take = ov > bv || (ov == bv && oi < bi);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        tot[k] += __shfl_xor_sync(FULL, tot[k], off);
        const float ow = __shfl_xor_sync(FULL, wb[k], off);
        if (take) wb[k] = ow;
      }
      if (take) {
        bv = ov;
        bi = oi;
      }
    }
    if (r < a.R) {
      const float nan = nan_f();
      if (lane == 0) {
        a.best_val[r] = live ? bv : nan;
        a.best_idx[r] = live ? bi : -1;
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < a.K && k % G == lane) {
          a.total[static_cast<size_t>(r) * a.K + k] = live ? tot[k] : nan;
          a.w_best[static_cast<size_t>(r) * a.K + k] = live ? wb[k] : nan;
        }
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int F, int KMAX, int G>
int launch(const Args& a, const PLParams& pl, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM of this instantiation
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_sinr_kernel<F, KMAX, G>, BLOCK, 0);
    if (per_sm < 1) per_sm = 1;
  }
  constexpr int ROWS = BLOCK / G;
  const long long need = (static_cast<long long>(a.R) + ROWS - 1) / ROWS;
  const long long wave = static_cast<long long>(per_sm) * sm_count();
  const int grid = static_cast<int>(need < wave ? need : wave);
  fused_sinr_kernel<F, KMAX, G><<<grid, BLOCK, 0, stream>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int KMAX>
int by_group(int group, const Args& a, const PLParams& pl, cudaStream_t s) {
  if (group == 8) return launch<F, KMAX, 8>(a, pl, s);
  if constexpr (F == F_UM && KMAX <= 4) {   // the timing and test hooks
    if (group == 16) return launch<F, KMAX, 16>(a, pl, s);
    if (group == 32) return launch<F, KMAX, 32>(a, pl, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int F>
int by_k(int group, const Args& a, const PLParams& pl, cudaStream_t s) {
  if (a.K == 1) return by_group<F, 1>(group, a, pl, s);
  if (a.K <= 4) return by_group<F, 4>(group, a, pl, s);
  if (a.K <= 8) return by_group<F, 8>(group, a, pl, s);
  return by_group<F, 16>(group, a, pl, s);
}

}  // namespace

extern "C" {

int fused_sinr_max_k() { return MAX_K; }
int fused_sinr_max_pl_params() { return MAX_PL_PARAMS; }

// Launches on ``stream`` and returns cudaGetLastError(); 0 means launched.
// N rows of U (and of fad), R output rows (R = N without an index).
int fused_sinr_launch(const float* U, const float* C, const float* P,
                      const float* bore, const float* fad, const void* idx,
                      int idx_bits, float* total, float* best_val,
                      int* best_idx, float* w_best, int N, int R, int M, int K,
                      int fad_mode, int attach_on_mean, int n_sectors,
                      int group, int pl_model, const float* pl_params,
                      int n_pl, void* stream) {
  if (n_pl > MAX_PL_PARAMS || K < 1 || K > MAX_K || N < 1 || R < 1 || M < 1 ||
      (idx_bits != 0 && idx_bits != 32 && idx_bits != 64) ||
      (idx_bits == 0 && R != N))
    return static_cast<int>(cudaErrorInvalidValue);
  PLParams pl;
  for (int q = 0; q < MAX_PL_PARAMS; ++q) pl.v[q] = q < n_pl ? pl_params[q] : 0.0f;
  const Args a{U, C, P, bore, fad, idx, total, best_val, best_idx, w_best,
               N, R, M, K, fad_mode, idx_bits, attach_on_mean, n_sectors};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl_model) {
    case 0: return by_k<F_RMA>(group, a, pl, s);
    case 1: return by_k<F_RMA_DISC>(group, a, pl, s);
    case 2:  // UMa
    case 3:  // UMi: the same formulas, other constants
      return by_k<F_UM>(group, a, pl, s);
    case 4: return by_k<F_INH>(group, a, pl, s);
    case 5: return by_k<F_POW>(group, a, pl, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
