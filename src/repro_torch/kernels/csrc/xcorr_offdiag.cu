// Fused off-diagonal penalty R_off = sum_{i != j} (Z1^T Z2)_ij^2 (paper
// Eq. 2, the O(n d^2) baseline) without the d x d matrix C in device memory.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/xcorr_offdiag/kernel.py:
//   xcorr_offdiag <- off_diagonal_sq_sum_raw / _xcorr_kernel
// The backward pass is the reference's Gram trick in plain torch products
// (xcorr_offdiag/ops.py), as the reference computes it outside Pallas.
//
// Bound on an H100 at the training shape (n = 256, d = 2048): 2 n d^2 =
// 2.1 GFLOP of f32 FMA against 4.2 MB read -> 511 FLOP/B, far above the
// f32 CUDA-core ridge (20 FLOP/B): bound by operations (31 us at
// 67 TFLOP/s); at d = 8192 16x the work for 4x the bytes.
//
// Design.  The TPU kernel walks a sequential (I, J, K) grid and carries one
// scalar in its resident output block.  Hopper blocks run in no order, so:
//   pass 1: one block per 64 x 64 tile of C loops over the whole batch
//   contraction n itself (16-row slices of both column slabs staged in
//   shared memory, read along the feature axis: coalesced), keeps the tile
//   in registers (4 x 4 per thread, rows ty + 16 i, columns tx + 16 j),
//   squares it, masks the GLOBAL diagonal (row i0 + r == column j0 + c) and
//   reduces the tile to one partial in a fixed order (warp shuffles, then
//   the 8 warp sums in order) written to partial[tile];
//   pass 2: one block sums the partials in a fixed order (strided per
//   thread, then a fixed tree).
// No atomics: the result is bit-identical from run to run.  Ragged edges
// (d = 2039) are masked at load with zero fill, so padding rows and columns
// of C are exact zeros and add nothing.  Plain f32 FMA, no tensor cores
// (later work).
//
// C interface: pointers to contiguous float32 device buffers, sizes as int,
// the CUDA stream; the entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int XT = 64;   // C tile edge
constexpr int XK = 16;   // batch rows per shared-memory slice
constexpr int TPB = 256;

__global__ void __launch_bounds__(TPB) xcorr_tile_kernel(
    const float* __restrict__ z1, const float* __restrict__ z2, float* __restrict__ partial,
    int n, int d) {
  __shared__ float sa[XK][XT];
  __shared__ float sb[XK][XT];
  __shared__ float warp_sums[TPB / 32];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * XT;  // rows of C: features of z1
  const int j0 = blockIdx.x * XT;  // columns of C: features of z2

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += XK) {
#pragma unroll
    for (int r = 0; r < (XK * XT) / TPB; ++r) {
      const int e = tid + r * TPB;
      const int cc = e % XT;
      const int kk = e / XT;
      const int gk = k0 + kk;
      const long long row = (long long)gk * d;
      sa[kk][cc] = (gk < n && i0 + cc < d) ? z1[row + i0 + cc] : 0.f;
      sb[kk][cc] = (gk < n && j0 + cc < d) ? z2[row + j0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < XK; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gi = i0 + ty + 16 * i;
      const int gj = j0 + tx + 16 * j;
      if (gi != gj) s = fmaf(acc[i][j], acc[i][j], s);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = s;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < TPB / 32; ++w) total += warp_sums[w];
    partial[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(TPB) sum_partials_kernel(
    const float* __restrict__ partial, int count, float* __restrict__ out) {
  __shared__ float buf[TPB];
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += TPB) s += partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int stride = TPB / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

}  // namespace

extern "C" {

// partial: (ceil(d / 64))^2 floats of scratch; out: one float
int xcorr_offdiag_off_diagonal_sq_sum(const float* z1, const float* z2, float* partial, float* out,
                                      int n, int d, cudaStream_t stream) {
  const int tiles = (d + XT - 1) / XT;
  const dim3 grid(tiles, tiles);
  xcorr_tile_kernel<<<grid, TPB, 0, stream>>>(z1, z2, partial, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, TPB, 0, stream>>>(partial, tiles * tiles, out);
  return (int)cudaGetLastError();
}

const char* xcorr_offdiag_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
