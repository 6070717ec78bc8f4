// Four-step-FFT kernels for the ungrouped summary vector (paper Eq. 6/12).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/sumvec_fft/kernel.py:
//   cmatmul  <- _cmatmul_raw / _cmm_kernel  (complex matmul on re/im planes)
//   ctwiddle <- _ctwiddle_raw / _ctw_kernel (rows times a constant complex plane)
//
// Bound on an H100 at the serving shapes (d = 2048, plan 32 x 64, n = 256):
//   cmatmul stage 3 (8192, 64) x (64, 64): 8 M K N = 268 MFLOP of f32 FMA
//   against 8.4 MB moved -> 32 FLOP/B, above the f32 CUDA-core ridge
//   (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B): bound by operations.  Stage 1 has
//   a real input (Ai = 0) and half the work.
//   ctwiddle (256, 2048): 6 FLOP per 16 bytes -> bound by bytes.
//
// Design.  On the TPU the K grid axis carried the sum in the resident output
// block; here one CUDA block owns a 64 x 64 output tile and loops over K
// itself, staging 16-deep slices of A and B (both planes) in shared memory,
// so each output is a fixed-order f32 FMA chain: no atomics, deterministic.
// Each of the 256 threads keeps a 4 x 4 tile of both the real and imaginary
// accumulators in registers (rows ty + 16 i, columns tx + 16 j: neighbouring
// threads read neighbouring shared-memory words and store neighbouring
// global words).  Ragged edges are masked at load (zero fill) and at store;
// nothing is padded to tiles in device memory.  A null Ai folds the real
// input case (four-step stage 1) into half the FMAs.  Plain f32 FMA, no
// tensor cores: wgmma/TMA are later work.
//
// C interface: pointers to contiguous float32 device buffers, sizes as int,
// the CUDA stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TPB = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <bool HAS_AI>
__global__ void __launch_bounds__(TPB) cmatmul_kernel(
    const float* __restrict__ ar, const float* __restrict__ ai,
    const float* __restrict__ br, const float* __restrict__ bi,
    float* __restrict__ cr, float* __restrict__ ci, int M, int K, int N) {
  __shared__ float sar[BK][BM + 1];
  __shared__ float sai[HAS_AI ? BK : 1][BM + 1];
  __shared__ float sbr[BK][BN];
  __shared__ float sbi[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float accr[4][4];
  float acci[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      accr[i][j] = 0.f;
      acci[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slice: BM rows x BK columns, read along k (coalesced), stored k-major
#pragma unroll
    for (int r = 0; r < (BM * BK) / TPB; ++r) {
      const int e = tid + r * TPB;
      const int kk = e % BK;
      const int mm = e / BK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      const bool in = gm < M && gk < K;
      const long long off = (long long)gm * K + gk;
      sar[kk][mm] = in ? ar[off] : 0.f;
      if (HAS_AI) sai[kk][mm] = in ? ai[off] : 0.f;
    }
    // B slice: BK rows x BN columns, read along n
#pragma unroll
    for (int r = 0; r < (BK * BN) / TPB; ++r) {
      const int e = tid + r * TPB;
      const int nn = e % BN;
      const int kk = e / BN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      const bool in = gk < K && gn < N;
      const long long off = (long long)gk * N + gn;
      sbr[kk][nn] = in ? br[off] : 0.f;
      sbi[kk][nn] = in ? bi[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[4], xi[4], yr[4], yi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = sar[kk][ty + 16 * i];
        xi[i] = HAS_AI ? sai[kk][ty + 16 * i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yr[j] = sbr[kk][tx + 16 * j];
        yi[j] = sbi[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accr[i][j] = fmaf(xr[i], yr[j], accr[i][j]);
          acci[i][j] = fmaf(xr[i], yi[j], acci[i][j]);
          if (HAS_AI) {
            accr[i][j] = fmaf(-xi[i], yi[j], accr[i][j]);
            acci[i][j] = fmaf(xi[i], yr[j], acci[i][j]);
          }
        }
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
      if (gn >= N) continue;
      const long long off = (long long)gm * N + gn;
      cr[off] = accr[i][j];
      ci[off] = acci[i][j];
    }
  }
}

__global__ void ctwiddle_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                const float* __restrict__ wr, const float* __restrict__ wi,
                                float* __restrict__ yr, float* __restrict__ yi,
                                long long total, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int col = (int)(e % d);
    const float a = xr[e], b = xi[e];
    const float c = wr[col], s = wi[col];
    yr[e] = a * c - b * s;
    yi[e] = a * s + b * c;
  }
}

}  // namespace

extern "C" {

int sumvec_fft_cmatmul(const float* ar, const float* ai, const float* br, const float* bi,
                       float* cr, float* ci, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (ai != nullptr) {
    cmatmul_kernel<true><<<grid, TPB, 0, stream>>>(ar, ai, br, bi, cr, ci, M, K, N);
  } else {
    cmatmul_kernel<false><<<grid, TPB, 0, stream>>>(ar, ai, br, bi, cr, ci, M, K, N);
  }
  return (int)cudaGetLastError();
}

int sumvec_fft_ctwiddle(const float* xr, const float* xi, const float* wr, const float* wi,
                        float* yr, float* yi, int n, int d, cudaStream_t stream) {
  const long long total = (long long)n * d;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  ctwiddle_kernel<<<(unsigned)blocks, threads, 0, stream>>>(xr, xi, wr, wi, yr, yi, total, d);
  return (int)cudaGetLastError();
}

const char* sumvec_fft_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
