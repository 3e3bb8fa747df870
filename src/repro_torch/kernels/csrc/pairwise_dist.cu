// Pairwise UE-cell distances (the D block) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_dist.py
// (pairwise_dist, body _dist_kernel).  For UE rows U (N, 3) and cells
// C (M, 3) it writes the (N, M) row-major matrices
//
//   d2d[i, j] = sqrt(dx^2 + dy^2)        dx, dy, dz = U[i] - C[j]
//   d3d[i, j] = sqrt(d2d[i, j]^2 + dz^2)
//
// exactly as repro.sim.radio.compute_distances defines them.  The TPU kernel
// used the MXU form |u|^2 + |c|^2 - 2 u.c, which loses up to ~0.2 m to
// cancellation at a 5 km extent; with a 3-wide contraction tensor cores buy
// nothing, so this kernel subtracts directly.
//
// Bound: bytes.  Each link costs 8 bytes of stores and ~10 flops, so the
// card's store bandwidth sets the time (8 N M bytes at 3.35 TB/s).
//
// Design: a block owns a tile of ROWS UE rows x up to TILE_M cells.  The
// tile's cells (as x/y/z arrays) and rows sit in shared memory.  The
// block's threads walk the tile's elements in row-major order, so
// neighbouring threads write neighbouring addresses and both output stores
// coalesce; where the tile spans all M cells the tile is one contiguous
// run of the outputs.  A thread keeps its (row, column) position and
// advances it by the block size without dividing.  Ragged edges (N not a
// multiple of ROWS, M not of TILE_M) are masked here: nothing is padded.
//
// The products and sums use explicit round-to-nearest intrinsics, so nvcc
// does not contract dx*dx + dy*dy into an FMA: the results are bitwise those
// of the plain PyTorch version's separate multiply and add kernels.  No fast
// math: sqrtf stays correctly rounded.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ROWS = 64;
constexpr int TILE_M = 2048;

__global__ void __launch_bounds__(BLOCK)
pairwise_dist_kernel(const float* __restrict__ U, const float* __restrict__ C,
                     float* __restrict__ d2d, float* __restrict__ d3d, int N,
                     int M) {
  __shared__ float cx[TILE_M], cy[TILE_M], cz[TILE_M];
  __shared__ float ux[ROWS], uy[ROWS], uz[ROWS];

  const int r0 = blockIdx.x * ROWS;
  const int c0 = blockIdx.y * TILE_M;
  const int rows = min(ROWS, N - r0);
  const int cols = min(TILE_M, M - c0);

  for (int q = threadIdx.x; q < cols; q += BLOCK) {
    const float* c = C + 3 * static_cast<size_t>(c0 + q);
    cx[q] = c[0];
    cy[q] = c[1];
    cz[q] = c[2];
  }
  for (int q = threadIdx.x; q < rows; q += BLOCK) {
    const float* u = U + 3 * static_cast<size_t>(r0 + q);
    ux[q] = u[0];
    uy[q] = u[1];
    uz[q] = u[2];
  }
  __syncthreads();

  // element l of the tile is (row l / cols, column l % cols); advance by
  // BLOCK = step_r rows + step_c columns per iteration
  const int step_r = BLOCK / cols;
  const int step_c = BLOCK - step_r * cols;
  int r = threadIdx.x / cols;
  int c = threadIdx.x - r * cols;
  while (r < rows) {
    const float dx = __fsub_rn(ux[r], cx[c]);
    const float dy = __fsub_rn(uy[r], cy[c]);
    const float dz = __fsub_rn(uz[r], cz[c]);
    const float d2 = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const float d3 = sqrtf(__fadd_rn(__fmul_rn(d2, d2), __fmul_rn(dz, dz)));
    const size_t o = static_cast<size_t>(r0 + r) * M + (c0 + c);
    d2d[o] = d2;
    d3d[o] = d3;
    r += step_r;
    c += step_c;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(); 0 means launched.
int pairwise_dist_launch(const float* U, const float* C, float* d2d,
                         float* d3d, int N, int M, void* stream) {
  if (N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + ROWS - 1) / ROWS, (M + TILE_M - 1) / TILE_M);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  pairwise_dist_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      U, C, d2d, d3d, N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
