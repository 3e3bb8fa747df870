// The fault re-pricing over the carried gain in one pass, on Hopper.
//
// Replaces no TPU kernel: the JAX package re-prices with XLA's fused
// elementwise and reduction ops (repro.sim.radio.radio_update_cells), and
// the port's torch version of it made several full passes over the carried
// (N, M) gain on every TTI of a fault run (the RSRP product, its sum, the
// argmax, the cell total, a copy of the gain).  This kernel is that
// function, radio_update_cells's per-UE re-pricing, in one read of G.  For
// every UE row i it computes each link's RSRP once, as a rounded product
//
//   R[i, j, k] = G[i, j(, k)] * P[j, k]                    (__fmul_rn)
//
// and feeds that one product to
//
//   meas[i, j] = sum_k R[i, j, k]       (or sum_k G0[i, j] * P[j, k])
//   a[i]       = argmax_j meas[i, j]    (the lowest index wins ties)
//   total[k]   = sum_j R[i, j, k]
//   gamma[i,k] = w / (noise_w + (total[k] - w)),   w = R[i, a[i], k]
//
// and writes only a (N,) int32 and gamma (N, K).  R and meas never reach
// device memory.  At K = 1 meas is R itself, so the attachment is bit-equal
// to the plain version's argmax; the cell total is summed in another order
// than PyTorch's reduction.  No fast math: every product, sum and the
// division round to nearest, as the plain version's separate kernels do.
//
// Bound: bytes.  One pass reads 4 N M bytes of G (plus G0 where it is
// given) and writes 4 N (K + 1); a link costs ~3 float operations.  For the
// million-UE field (1M x 127, K = 1) that is 516 MB, 0.154 ms at 3.35 TB/s.
//
// Design.
// * A block owns tiles of TR consecutive UE rows (TR a multiple of 4, so a
//   tile of 127-float rows starts on a 16-byte boundary although a row does
//   not).  A tile is one contiguous run of G (and one of G0), copied into
//   shared memory by cp.async 16-byte copies (4-byte ones for a ragged
//   tail).  Blocks are persistent (one wave) and double-buffered: the copy
//   of the block's next tile is in flight while it reduces the current one.
// * A group of 8 lanes reduces one row from shared memory, lane l the
//   cells l, l + 8, ... in ascending order, then merges over three
//   __shfl_xor_sync steps: totals add, and a lane takes its partner's best
//   when larger, or equal with a lower index (fused_sinr's merge).  The
//   four groups of a warp take rows 8 apart: with an odd row length (127
//   floats) their rows start 8, 16 or 24 banks apart, so at K = 1 a warp's
//   32 reads of G hit 32 distinct banks and its reads of P are one word
//   broadcast to each group.
// * Every launch is one full pass over every row; there is no early exit,
//   so the caller's selection on "any cell changed" stays branch-free.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BLOCK = 256;
constexpr int GROUP = 8;                      // lanes per UE row
constexpr int GROUPS = BLOCK / GROUP;
constexpr int STAGES = 2;                     // tile buffers in the ring
// bytes of one tile buffer (the G and G0 rows of TR UE rows).  On an H100
// at 1M x 127, 2 or 3 stages of 16 or 32 KB and 4 or 8 lanes a row time
// within 4 % of each other; 16 lanes, 8 KB tiles and 4 stages of them are
// slower (PERF.md)
constexpr int TILE_BYTES = 16384;
constexpr int MAX_K = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* G;    // (N, M) or (N, M, K)
  const float* G0;   // (N, M) or nullptr
  const float* P;    // (M, K)
  int* a;            // (N,)
  float* gamma;      // (N, K)
  float noise_w;
  int N, M, K;
  int g_stride_k;    // 1: G is (N, M, K); 0: G is (N, M)
  int TR;            // rows per tile
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most STAGES - 1 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// Copy ``count`` floats from ``src`` to shared ``dst``, both 16-byte
// aligned, by the block's threads.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long count) {
  const long long n4 = count >> 2;
  for (long long q = threadIdx.x; q < n4; q += BLOCK)
    cp_async16(dst + 4 * q, src + 4 * q);
  const int rem = static_cast<int>(count & 3);
  if (threadIdx.x < rem)
    cp_async4(dst + 4 * n4 + threadIdx.x, src + 4 * n4 + threadIdx.x);
}

template <int KMAX>
__global__ void __launch_bounds__(BLOCK)
reprice_cells_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = p.M, K = p.K;
  const int RG = p.g_stride_k ? M * K : M;      // floats of a G row
  const int R0 = p.G0 != nullptr ? M : 0;       // floats of a G0 row
  const int TR = p.TR;
  const int buf_floats = TR * (RG + R0);
  float* Ps = smem + STAGES * buf_floats;
  for (int q = threadIdx.x; q < M * K; q += BLOCK) Ps[q] = p.P[q];

  const int ntiles = (p.N + TR - 1) / TR;
  auto issue = [&](int t, int b) {
    const long long r0 = static_cast<long long>(t) * TR;
    const int rows = min(TR, p.N - static_cast<int>(r0));
    float* dst = smem + b * buf_floats;
    copy_tile(dst, p.G + r0 * RG, static_cast<long long>(rows) * RG);
    if (R0) copy_tile(dst + TR * RG, p.G0 + r0 * R0,
                      static_cast<long long>(rows) * R0);
  };

  const int lane = threadIdx.x & (GROUP - 1);
  // the warp's groups take rows WARPS apart (see the design note)
  constexpr int WARPS = BLOCK / 32, PER_WARP = 32 / GROUP;
  const int grp = threadIdx.x / GROUP;
  const int slot = (grp % PER_WARP) * WARPS + grp / PER_WARP;

  // the ring: tiles blockIdx.x + i gridDim.x for i = 0, 1, ... in buffer
  // i % STAGES, each copy issued STAGES - 1 tiles ahead of its reduction
  const int grid = static_cast<int>(gridDim.x);
  for (int s = 0; s < STAGES - 1; ++s) {
    const int ts = static_cast<int>(blockIdx.x) + s * grid;
    if (ts < ntiles) issue(ts, s);
    cp_async_commit();
  }
  int b = 0;
  for (int t = blockIdx.x; t < ntiles; t += grid) {
    const int ahead = t + (STAGES - 1) * grid;
    if (ahead < ntiles) issue(ahead, (b + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait_ring();
    __syncthreads();

    const float* Gs = smem + b * buf_floats;
    const float* G0s = Gs + TR * RG;
    const int row0 = t * TR;
    const int rows = min(TR, p.N - row0);
    for (int base = 0; base < rows; base += GROUPS) {   // uniform bound
      const int r = base + slot;
      const bool live = r < rows;
      const float* g = Gs + r * RG;
      const float* g0 = G0s + r * R0;
      float tot[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) tot[k] = 0.0f;
      // a lane walks its cells in ascending order: strict '>' keeps the
      // lowest index of its share.  NaN ranks above every number, as in
      // torch.argmax, and the first NaN is kept; a lane starts at its first
      // cell, so an all -inf row attaches to cell 0 and no index is ever
      // out of range
      float bv = -INFINITY;
      int bi = lane;
      if (KMAX == 1 && R0 == 0) {
        if (live) {
#pragma unroll 4
          for (int j = lane; j < M; j += GROUP) {
            const float rv = __fmul_rn(g[j], Ps[j]);
            tot[0] = __fadd_rn(tot[0], rv);
            if (rv > bv || (rv != rv && bv == bv)) {
              bv = rv;
              bi = j;
            }
          }
        }
      } else if (live) {
        for (int j = lane; j < M; j += GROUP) {
          float mv = 0.0f;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
              const float gv = g[p.g_stride_k ? j * K + k : j];
              const float rv = __fmul_rn(gv, Ps[j * K + k]);
              tot[k] = __fadd_rn(tot[k], rv);
              if (R0 == 0) mv = k == 0 ? rv : __fadd_rn(mv, rv);
            }
          }
          if (R0) {
            const float g0v = g0[j];
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
              if (k < K) {
                const float rv = __fmul_rn(g0v, Ps[j * K + k]);
                mv = k == 0 ? rv : __fadd_rn(mv, rv);
              }
            }
          }
          if (mv > bv || (mv != mv && bv == bv)) {
            bv = mv;
            bi = j;
          }
        }
      }
      // merge the lanes of the group: every lane of the warp takes part
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          tot[k] = __fadd_rn(tot[k], __shfl_xor_sync(FULL, tot[k], off));
        const bool o_nan = ov != ov, b_nan = bv != bv;
        if (o_nan ? (!b_nan || oi < bi)
                  : (!b_nan && (ov > bv || (ov == bv && oi < bi)))) {
          bv = ov;
          bi = oi;
        }
      }
      if (live) {
        const size_t row = static_cast<size_t>(row0) + r;
        if (lane == 0) p.a[row] = bi;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K && k % GROUP == lane) {
            const float gv = g[p.g_stride_k ? bi * K + k : bi];
            const float w = __fmul_rn(gv, Ps[bi * K + k]);
            const float u = __fsub_rn(tot[k], w);
            p.gamma[row * K + k] = __fdiv_rn(w, __fadd_rn(p.noise_w, u));
          }
        }
      }
    }
    __syncthreads();   // the buffer is refilled by the next iteration's copy
    b = (b + 1) % STAGES;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int KMAX>
int launch(const Args& p, int smem, cudaStream_t stream) {
  // resident blocks per SM at the last device and shared-memory size of
  // this instantiation (one launch shape on the main path, so set once)
  static int last_dev = -1, last_smem = -1, per_sm = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem != last_smem || dev != last_dev) {
    cudaError_t e = cudaFuncSetAttribute(
        reprice_cells_kernel<KMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reprice_cells_kernel<KMAX>, BLOCK, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    last_smem = smem;
    last_dev = dev;
  }
  const long long tiles = (static_cast<long long>(p.N) + p.TR - 1) / p.TR;
  const long long wave = static_cast<long long>(per_sm) * sm_count();
  const int grid = static_cast<int>(tiles < wave ? tiles : wave);
  reprice_cells_kernel<KMAX><<<grid, BLOCK, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int reprice_cells_max_k() { return MAX_K; }

// Shared-memory bytes of a launch: STAGES tile buffers and the powers.
// Returns -1 when even a tile of 4 rows does not fit in 227 KB.
int reprice_cells_smem_bytes(int M, int K, int g_stride_k, int has_g0,
                             int* tile_rows) {
  const long long row = 4LL * ((g_stride_k ? M * K : M) + (has_g0 ? M : 0));
  long long tr = (TILE_BYTES / row) & ~3LL;
  if (tr < 4) tr = 4;
  const long long bytes = STAGES * tr * row + 4LL * M * K;
  if (tile_rows) *tile_rows = static_cast<int>(tr);
  return bytes > 232448 ? -1 : static_cast<int>(bytes);
}

// Launches on ``stream`` and returns cudaGetLastError(); 0 means launched.
// G and G0 (null when absent) must be 16-byte aligned.
int reprice_cells_launch(const float* G, const float* G0, const float* P,
                         float noise_w, int* a, float* gamma, int N, int M,
                         int K, int g_stride_k, void* stream) {
  if (N < 1 || M < 1 || K < 1 || K > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  int tr = 0;
  const int smem =
      reprice_cells_smem_bytes(M, K, g_stride_k, G0 != nullptr, &tr);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{G, G0, P, a, gamma, noise_w, N, M, K, g_stride_k, tr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 1) return launch<1>(p, smem, s);
  if (K <= 4) return launch<4>(p, smem, s);
  if (K <= 8) return launch<8>(p, smem, s);
  return launch<16>(p, smem, s);
}

}  // extern "C"
