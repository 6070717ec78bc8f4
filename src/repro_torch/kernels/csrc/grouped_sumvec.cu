// Grouped (block) summary-vector kernels (paper Eq. 13), forward and vjp.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/grouped_sumvec/kernel.py:
//   pmatmul    <- _pmatmul_raw / _mm_kernel    (f32 (M, K) @ (K, N))
//   freq_outer <- _freq_outer_raw / _fo_kernel (G[f] = a[f]^T b[f] per frequency)
//   freq_mat   <- _freq_mat_raw / _fm_kernel   (Y[f] = a[f] m[f] per frequency;
//                                               only freq_outer's vjp runs it)
// The vjps (kernel.py) reuse these: pmatmul's is two more pmatmuls,
// freq_outer's two freq_mats, freq_mat's one freq_mat and one freq_outer.
//
// Bound on an H100 at the serving shapes (d = 2048, b = 128, n = 256):
//   pmatmul, the block DFT (4096, 128) x (128, 130): 136 MFLOP against
//   4.3 MB -> 32 FLOP/B, above the f32 CUDA-core ridge (20 FLOP/B): bound
//   by operations.
//   freq_outer (F, K, N) = (65, 512, 16): 17 MFLOP against 4.3 MB -> 4
//   FLOP/B: bound by bytes (each input element is used N = d/b times).
//   freq_mat (65, 512, 16) x (65, 16, 16): the same 17 MFLOP against
//   4.3 MB: bound by bytes; at d = 8192 (N = 64) 16 FLOP/B, still bytes.
//
// Design.  On the TPU the K grid axis carried the sum in the resident output
// block; here the loop over K runs inside one CUDA block, so every output is
// one fixed-order f32 FMA chain (no atomics, deterministic).
//   pmatmul: a 64 x 64 output tile per block, 16-deep K slices of A and B in
//   shared memory, 4 x 4 register outputs per thread (rows ty + 16 i,
//   columns tx + 16 j: conflict-free shared reads, coalesced stores).
//   freq_outer: one block per (frequency, 16 x 16 output tile), one output
//   per thread, 64-deep slices of a[f] and b[f] staged in shared memory.  The
//   group axis N = d / b is small (16 at d = 2048), so a one-output-per-thread
//   tile keeps every thread busy where a larger register tile would idle.
//   freq_mat: m[f] is at most 64 x 64 on the paper's widths (16 KiB), a
//   slab of it fits in shared memory beside a 64-row slice of a[f]; the
//   TPU kernel's K grid axis has no counterpart: each block owns 64 output
//   rows x 16 output columns of one frequency outright and loops over the
//   contraction N in 64-wide slices (one pass when N <= 64).  Four outputs
//   per thread (rows ty + 16 i, column tx).
// Ragged edges are masked at load (zero fill) and at store; nothing is
// padded in device memory.  Plain f32 FMA, no tensor cores (later work).
//
// C interface: pointers to contiguous float32 device buffers, sizes as int,
// the CUDA stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TPB = 256;

__global__ void __launch_bounds__(TPB) pmatmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
    int M, int K, int N) {
  __shared__ float sa[BK][BM + 1];
  __shared__ float sb[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / TPB; ++r) {
      const int e = tid + r * TPB;
      const int kk = e % BK;
      const int mm = e / BK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      sa[kk][mm] = (gm < M && gk < K) ? a[(long long)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / TPB; ++r) {
      const int e = tid + r * TPB;
      const int nn = e % BN;
      const int kk = e / BN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      sb[kk][nn] = (gk < K && gn < N) ? b[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) c[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

constexpr int FT = 16;   // output tile edge
constexpr int FK = 64;   // K slice depth

// out[f, i, j] = sum_k a[f, k, i] * b[f, k, j];  a: (F, K, N), b: (F, K, NB)
__global__ void __launch_bounds__(FT * FT) freq_outer_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
    int K, int N, int NB) {
  __shared__ float sa[FK][FT];
  __shared__ float sb[FK][FT + 1];

  const int f = blockIdx.z;
  const int i0 = blockIdx.y * FT;
  const int j0 = blockIdx.x * FT;
  const int tx = threadIdx.x % FT;
  const int ty = threadIdx.x / FT;
  const float* af = a + (long long)f * K * N;
  const float* bf = b + (long long)f * K * NB;

  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int r = 0; r < (FK * FT) / (FT * FT); ++r) {
      const int e = threadIdx.x + r * FT * FT;
      const int c = e % FT;
      const int kk = e / FT;
      const int gk = k0 + kk;
      sa[kk][c] = (gk < K && i0 + c < N) ? af[(long long)gk * N + i0 + c] : 0.f;
      sb[kk][c] = (gk < K && j0 + c < NB) ? bf[(long long)gk * NB + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < FK; ++kk) acc = fmaf(sa[kk][ty], sb[kk][tx], acc);
    __syncthreads();
  }
  const int i = i0 + ty;
  const int j = j0 + tx;
  if (i < N && j < NB) out[((long long)f * N + i) * NB + j] = acc;
}

constexpr int MK = 64;   // freq_mat: rows of a[f] (and of y[f]) per block
constexpr int MN = 16;   // output columns per block
constexpr int MC = 64;   // contraction slice depth

// y[f, k, j] = sum_c a[f, k, c] * m[f, c, j];  a: (F, K, N), m: (F, N, N2)
__global__ void __launch_bounds__(256) freq_mat_kernel(
    const float* __restrict__ a, const float* __restrict__ m, float* __restrict__ y,
    int K, int N, int N2) {
  __shared__ float sa[MK][MC + 1];
  __shared__ float sm[MC][MN];

  const int f = blockIdx.z;
  const int k0 = blockIdx.y * MK;
  const int j0 = blockIdx.x * MN;
  const int tx = threadIdx.x % MN;
  const int ty = threadIdx.x / MN;
  const float* af = a + (long long)f * K * N;
  const float* mf = m + (long long)f * N * N2;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < N; c0 += MC) {
    // a slice: MK rows x MC columns, read along c (coalesced)
#pragma unroll
    for (int r = 0; r < (MK * MC) / 256; ++r) {
      const int e = threadIdx.x + r * 256;
      const int cc = e % MC;
      const int kk = e / MC;
      const int gk = k0 + kk;
      const int gc = c0 + cc;
      sa[kk][cc] = (gk < K && gc < N) ? af[(long long)gk * N + gc] : 0.f;
    }
    // m slab: MC rows x MN columns
#pragma unroll
    for (int r = 0; r < (MC * MN) / 256; ++r) {
      const int e = threadIdx.x + r * 256;
      const int jj = e % MN;
      const int cc = e / MN;
      const int gc = c0 + cc;
      const int gj = j0 + jj;
      sm[cc][jj] = (gc < N && gj < N2) ? mf[(long long)gc * N2 + gj] : 0.f;
    }
    __syncthreads();
    const int depth = min(MC, N - c0);
    for (int cc = 0; cc < depth; ++cc) {
      const float mv = sm[cc][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(sa[ty + 16 * i][cc], mv, acc[i]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= N2) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k < K) y[((long long)f * K + k) * N2 + j] = acc[i];
  }
}

}  // namespace

extern "C" {

int grouped_sumvec_pmatmul(const float* a, const float* b, float* c, int M, int K, int N,
                           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pmatmul_kernel<<<grid, TPB, 0, stream>>>(a, b, c, M, K, N);
  return (int)cudaGetLastError();
}

int grouped_sumvec_freq_outer(const float* a, const float* b, float* out, int F, int K, int N,
                              int NB, cudaStream_t stream) {
  const dim3 grid((NB + FT - 1) / FT, (N + FT - 1) / FT, F);
  freq_outer_kernel<<<grid, FT * FT, 0, stream>>>(a, b, out, K, N, NB);
  return (int)cudaGetLastError();
}

int grouped_sumvec_freq_mat(const float* a, const float* m, float* y, int F, int K, int N, int N2,
                            cudaStream_t stream) {
  const dim3 grid((N2 + MN - 1) / MN, (K + MK - 1) / MK, F);
  freq_mat_kernel<<<grid, 256, 0, stream>>>(a, m, y, K, N, N2);
  return (int)cudaGetLastError();
}

const char* grouped_sumvec_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
