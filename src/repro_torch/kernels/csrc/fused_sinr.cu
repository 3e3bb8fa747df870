// Fused CRRM pipeline D -> G -> RSRP -> (total, argmax, serving row) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_sinr.py
// (fused_sinr_accumulate, body _make_kernel).  For every UE row i it streams
// all M cells in index order and keeps, in registers,
//
//   total[i, k]  = sum_j r_ijk               (interference + wanted)
//   best_val[i]  = max_j meas_ij             (wideband measurement)
//   best_idx[i]  = argmax_j meas_ij          (attachment, lowest index wins)
//   w_best[i, k] = r_{i, best_idx, k}        (serving row)
//
// so the (N, M) distance, gain and RSRP matrices never reach device memory.
//
// Design: one thread per UE row; cell positions, boresights and powers are
// staged through shared memory in tiles of TILE_M cells; the strict '>' of
// the running max gives jnp.argmax's lowest-index tie-break.  The per-link
// math follows repro.sim.radio.compute_distances (d3d built from d2d) and
// make_gain_fn; pathloss is a switch on a model id (ids and parameter
// layouts fixed in repro_torch/sim/pathloss.py).
//
// Bound: with no fading the work is arithmetic -- several log10f, one powf
// and two sqrtf per link (plus atan2f/sinf/cosf/powf when sectored) on a few
// bytes of input per UE.  With per-RB fading the (N, M, K) fading tensor is
// read once, which sets a byte bound.  This first version reads fading rows
// uncoalesced (neighbouring threads are M floats apart); a warp per row or a
// transposed fading layout is later work.
//
// Built without --use_fast_math: gamma and the argmax must stay within the
// port's tolerance of the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_M = 128;
constexpr int BLOCK = 128;
constexpr int MAX_PL_PARAMS = 64;
constexpr float NEG_BIG = -3.4e38f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float C_LIGHT = 299792458.0f;

enum PathlossModel {
  PL_RMA = 0,
  PL_RMA_DISCRETISED = 1,
  PL_UMA = 2,
  PL_UMI = 3,
  PL_INH = 4,
  PL_POWER_LAW = 5,
};

// passed by value: lands in the kernel's constant parameter bank
struct PLParams {
  int model;
  int n;
  float v[MAX_PL_PARAMS];
};

__device__ __forceinline__ float lg(float x) { return log10f(fmaxf(x, 1e-9f)); }

// RMa PL1 (TR 38.901 Table 7.4.1-1): v = fc, ., h, a, b
__device__ __forceinline__ float rma_pl1(float d3d, float fc, float h, float a,
                                         float b) {
  return 20.0f * lg(40.0f * PI_F * d3d * fc / 3.0f) + a * lg(d3d) - b +
         0.002f * lg(h) * d3d;
}

// RMa: v = fc, W, h, a, b, LOS, fixed, h_bs_fixed, h_ut_fixed
__device__ float rma_db(const PLParams& p, float d2d, float d3d, float h_bs,
                        float h_ut) {
  const float fc = p.v[0], W = p.v[1], h = p.v[2], a = p.v[3], b = p.v[4];
  const bool los = p.v[5] != 0.0f;
  if (p.v[6] != 0.0f) {
    h_bs = p.v[7];
    h_ut = p.v[8];
  }
  const float d_bp = 2.0f * PI_F * h_bs * h_ut * (fc * 1e9f) / C_LIGHT;
  const float pl1 = rma_pl1(d3d, fc, h, a, b);
  const float pl2 = rma_pl1(d_bp, fc, h, a, b) + 40.0f * lg(d3d / fmaxf(d_bp, 1.0f));
  const float pl_los = d2d <= d_bp ? pl1 : pl2;
  if (los) return pl_los;
  const float hh = h / h_bs;
  const float l_ut = lg(11.75f * h_ut);
  const float pl_nlos = 161.04f - 7.1f * lg(W) + 7.5f * lg(h) -
                        (24.37f - 3.7f * hh * hh) * lg(h_bs) +
                        (43.42f - 3.1f * lg(h_bs)) * (lg(d3d) - 3.0f) +
                        20.0f * lg(fc) - (3.2f * l_ut * l_ut - 4.97f);
  return fmaxf(pl_los, pl_nlos);
}

// RMa LUT: v = fc, h, a, b, LOS, h_ut_min, h_ut_step, B, H, A[H], d_bp[H], pl1_bp[H]
__device__ float rma_disc_db(const PLParams& p, float d2d, float d3d, float h_ut) {
  const float fc = p.v[0], h = p.v[1], a = p.v[2], b = p.v[3];
  const bool los = p.v[4] != 0.0f;
  const int H = static_cast<int>(p.v[8]);
  int k = static_cast<int>(rintf((h_ut - p.v[5]) / p.v[6]));
  k = min(max(k, 0), H - 1);
  const float A = p.v[9 + k], d_bp = p.v[9 + H + k], pl1_bp = p.v[9 + 2 * H + k];
  const float pl1 = rma_pl1(d3d, fc, h, a, b);
  const float pl2 = pl1_bp + 40.0f * lg(d3d / fmaxf(d_bp, 1.0f));
  const float pl_los = d2d <= d_bp ? pl1 : pl2;
  if (los) return pl_los;
  return fmaxf(pl_los, A + p.v[7] * lg(d3d));
}

// UMa: v = fc, LOS
__device__ float uma_db(const PLParams& p, float d2d, float d3d, float h_bs,
                        float h_ut) {
  const float fc = p.v[0];
  const float d_bp = 4.0f * (h_bs - 1.0f) * (h_ut - 1.0f) * (fc * 1e9f) / C_LIGHT;
  const float dh = h_bs - h_ut;
  const float pl1 = 28.0f + 22.0f * lg(d3d) + 20.0f * lg(fc);
  const float pl2 = 28.0f + 40.0f * lg(d3d) + 20.0f * lg(fc) -
                    9.0f * lg(d_bp * d_bp + dh * dh);
  const float pl_los = d2d <= d_bp ? pl1 : pl2;
  if (p.v[1] != 0.0f) return pl_los;
  const float pl_nlos = 13.54f + 39.08f * lg(d3d) + 20.0f * lg(fc) - 0.6f * (h_ut - 1.5f);
  return fmaxf(pl_los, pl_nlos);
}

// UMi street canyon: v = fc, LOS
__device__ float umi_db(const PLParams& p, float d2d, float d3d, float h_bs,
                        float h_ut) {
  const float fc = p.v[0];
  const float d_bp = 4.0f * (h_bs - 1.0f) * (h_ut - 1.0f) * (fc * 1e9f) / C_LIGHT;
  const float dh = h_bs - h_ut;
  const float pl1 = 32.4f + 21.0f * lg(d3d) + 20.0f * lg(fc);
  const float pl2 = 32.4f + 40.0f * lg(d3d) + 20.0f * lg(fc) -
                    9.5f * lg(d_bp * d_bp + dh * dh);
  const float pl_los = d2d <= d_bp ? pl1 : pl2;
  if (p.v[1] != 0.0f) return pl_los;
  const float pl_nlos = 35.3f * lg(d3d) + 22.4f + 21.3f * lg(fc) - 0.3f * (h_ut - 1.5f);
  return fmaxf(pl_los, pl_nlos);
}

// InH office: v = fc, LOS
__device__ float inh_db(const PLParams& p, float d3d) {
  const float fc = p.v[0];
  const float pl_los = 32.4f + 17.3f * lg(d3d) + 20.0f * lg(fc);
  if (p.v[1] != 0.0f) return pl_los;
  return fmaxf(pl_los, 38.3f * lg(d3d) + 17.30f + 24.9f * lg(fc));
}

__device__ float pathgain(const PLParams& p, float d2d, float d3d, float h_bs,
                          float h_ut) {
  float pl;
  switch (p.model) {
    case PL_RMA: pl = rma_db(p, d2d, d3d, h_bs, h_ut); break;
    case PL_RMA_DISCRETISED: pl = rma_disc_db(p, d2d, d3d, h_ut); break;
    case PL_UMA: pl = uma_db(p, d2d, d3d, h_bs, h_ut); break;
    case PL_UMI: pl = umi_db(p, d2d, d3d, h_bs, h_ut); break;
    case PL_INH: pl = inh_db(p, d3d); break;
    default:  // PL_POWER_LAW: v = alpha, d0 -- the exact power law, no dB trip
      return powf(fmaxf(d3d / p.v[1], 1e-9f), -p.v[0]);
  }
  return powf(10.0f, -0.1f * pl);
}

// stock 3GPP horizontal pattern: 65 deg half-power beamwidth, 30 dB floor
__device__ __forceinline__ float sector_gain(float dx, float dy, float bore) {
  const float phi3 = 1.1344640137963142f;  // 65 deg in radians
  float off = atan2f(dy, dx) - bore;
  off = atan2f(sinf(off), cosf(off));
  const float q = off / phi3;
  const float att = fminf(12.0f * q * q, 30.0f);
  return powf(10.0f, 0.1f * (0.0f - att));
}

// fad_mode: 0 none, 1 wideband (N, M), 2 per-RB (N, M, K)
template <int KMAX>
__global__ void __launch_bounds__(BLOCK)
fused_sinr_kernel(const float* __restrict__ U, const float* __restrict__ C,
                  const float* __restrict__ P, const float* __restrict__ bore,
                  const float* __restrict__ fad, float* __restrict__ total,
                  float* __restrict__ best_val, int* __restrict__ best_idx,
                  float* __restrict__ w_best, int N, int M, int K, int fad_mode,
                  int attach_on_mean, int n_sectors, PLParams pl) {
  __shared__ float sx[TILE_M], sy[TILE_M], sz[TILE_M], sb[TILE_M];
  __shared__ float sp[TILE_M * KMAX];

  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < N;
  float ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (valid) {
    ux = U[3 * i];
    uy = U[3 * i + 1];
    uz = U[3 * i + 2];
  }
  float tot[KMAX], wb[KMAX], r[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    tot[k] = 0.0f;
    wb[k] = 0.0f;
  }
  float bv = NEG_BIG;
  int bi = 0;

  for (int j0 = 0; j0 < M; j0 += TILE_M) {
    const int m = min(TILE_M, M - j0);
    for (int t = threadIdx.x; t < m; t += BLOCK) {
      const int j = j0 + t;
      sx[t] = C[3 * j];
      sy[t] = C[3 * j + 1];
      sz[t] = C[3 * j + 2];
      sb[t] = bore[j];
      for (int k = 0; k < K; ++k) sp[t * KMAX + k] = P[j * K + k];
    }
    __syncthreads();
    if (valid) {
      for (int jj = 0; jj < m; ++jj) {
        const int j = j0 + jj;
        const float dx = ux - sx[jj];
        const float dy = uy - sy[jj];
        const float dz = uz - sz[jj];
        const float d2d = sqrtf(dx * dx + dy * dy);
        const float d3d = sqrtf(d2d * d2d + dz * dz);
        float g = pathgain(pl, d2d, d3d, sz[jj], uz);
        if (n_sectors > 1) g *= sector_gain(dx, dy, sb[jj]);
        float meas = 0.0f, mean = 0.0f;
        const size_t link = static_cast<size_t>(i) * M + j;
        const float fw = fad_mode == 1 ? fad[link] : 1.0f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          r[k] = 0.0f;
          if (k < K) {
            const float p = sp[jj * KMAX + k];
            float gk = g;
            if (fad_mode == 1) gk = g * fw;
            else if (fad_mode == 2) gk = g * fad[link * K + k];
            r[k] = gk * p;
            meas += r[k];
            mean += g * p;
            tot[k] += r[k];
          }
        }
        if (attach_on_mean) meas = mean;
        if (meas > bv) {
          bv = meas;
          bi = j;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) wb[k] = r[k];
        }
      }
    }
    __syncthreads();
  }
  if (valid) {
    for (int k = 0; k < K; ++k) {
      total[static_cast<size_t>(i) * K + k] = tot[k];
      w_best[static_cast<size_t>(i) * K + k] = wb[k];
    }
    best_val[i] = bv;
    best_idx[i] = bi;
  }
}

template <int KMAX>
void launch(const float* U, const float* C, const float* P, const float* bore,
            const float* fad, float* total, float* best_val, int* best_idx,
            float* w_best, int N, int M, int K, int fad_mode, int attach_on_mean,
            int n_sectors, const PLParams& pl, cudaStream_t stream) {
  const int grid = (N + BLOCK - 1) / BLOCK;
  fused_sinr_kernel<KMAX><<<grid, BLOCK, 0, stream>>>(
      U, C, P, bore, fad, total, best_val, best_idx, w_best, N, M, K, fad_mode,
      attach_on_mean, n_sectors, pl);
}

}  // namespace

extern "C" {

int fused_sinr_max_k() { return 16; }
int fused_sinr_max_pl_params() { return MAX_PL_PARAMS; }

// Launches on ``stream`` and returns cudaGetLastError(); 0 means launched.
int fused_sinr_launch(const float* U, const float* C, const float* P,
                      const float* bore, const float* fad, float* total,
                      float* best_val, int* best_idx, float* w_best, int N,
                      int M, int K, int fad_mode, int attach_on_mean,
                      int n_sectors, int pl_model, const float* pl_params,
                      int n_pl, void* stream) {
  if (n_pl > MAX_PL_PARAMS || K < 1 || K > 16 || N < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PLParams pl;
  pl.model = pl_model;
  pl.n = n_pl;
  for (int q = 0; q < MAX_PL_PARAMS; ++q) pl.v[q] = q < n_pl ? pl_params[q] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 1)
    launch<1>(U, C, P, bore, fad, total, best_val, best_idx, w_best, N, M, K,
              fad_mode, attach_on_mean, n_sectors, pl, s);
  else if (K <= 4)
    launch<4>(U, C, P, bore, fad, total, best_val, best_idx, w_best, N, M, K,
              fad_mode, attach_on_mean, n_sectors, pl, s);
  else if (K <= 8)
    launch<8>(U, C, P, bore, fad, total, best_val, best_idx, w_best, N, M, K,
              fad_mode, attach_on_mean, n_sectors, pl, s);
  else
    launch<16>(U, C, P, bore, fad, total, best_val, best_idx, w_best, N, M, K,
               fad_mode, attach_on_mean, n_sectors, pl, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
