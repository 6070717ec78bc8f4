// Four-step-FFT kernels for the ungrouped summary vector (paper Eq. 6/12),
// forward and vjp.
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
//   ctwiddle (256, 2048): 6 FLOP per 16 bytes -> bound by bytes (8.4 MB,
//   2.5 us at 3.35 TB/s; the served path finds its input in L2).
//
// Design.  cmatmul: on the TPU the K grid axis carried the sum in the
// resident output block; here one CUDA block owns a 64 x 64 output tile
// and loops over K itself, staging 16-deep slices of A and B (both planes)
// in shared memory, so each output is a fixed-order f32 FMA chain: no atomics, deterministic.
// Each of the 256 threads keeps a 4 x 4 tile of both the real and imaginary
// accumulators in registers (rows ty + 16 i, columns tx + 16 j: neighbouring
// threads read neighbouring shared-memory words and store neighbouring
// global words).  Ragged edges are masked at load (zero fill) and at store;
// nothing is padded to tiles in device memory.  A null Ai folds the real
// input case (four-step stage 1) into half the FMAs, and a null Ci (the vjp
// of that stage needs Re dA = Re(g B^H) only) halves them again.
// ctwiddle (redesigned): a 2-D grid of (column chunk, row group); a thread
// owns one float4 of columns (16-byte loads and stores) and 4 rows, loads its
// float4 of w once for all of them and issues all 8 row loads before any
// store; 32-bit offsets unless n d >= 2^31.  A scalar twin (one float a
// thread) takes d % 4 != 0 (the padded plan's dp = 121) and any operand not
// on a 16-byte boundary; the entry picks it from the sizes and pointers.
// The vjps (kernel.py) are these kernels on conjugated operands:
// dA = cmatmul(g, B^H), dx = ctwiddle(g, conj w).  Plain f32 FMA, no
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

template <bool HAS_AI, bool HAS_CI>
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
          if (HAS_CI) acci[i][j] = fmaf(xr[i], yi[j], acci[i][j]);
          if (HAS_AI) {
            accr[i][j] = fmaf(-xi[i], yi[j], accr[i][j]);
            if (HAS_CI) acci[i][j] = fmaf(xi[i], yr[j], acci[i][j]);
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
      if (HAS_CI) ci[off] = acci[i][j];
    }
  }
}

constexpr int TW_THREADS = 128;  // column vectors per block
constexpr int TW_ROWS = 4;       // rows per thread, one twiddle load for all
constexpr int TW_MAX_GRID_Y = 65535;

__device__ __forceinline__ void cmul(float a, float b, float c, float s, float& re, float& im) {
  re = a * c - b * s;
  im = a * s + b * c;
}

__device__ __forceinline__ void cmul(const float4& a, const float4& b, const float4& c,
                                     const float4& s, float4& re, float4& im) {
  cmul(a.x, b.x, c.x, s.x, re.x, im.x);
  cmul(a.y, b.y, c.y, s.y, re.y, im.y);
  cmul(a.z, b.z, c.z, s.z, re.z, im.z);
  cmul(a.w, b.w, c.w, s.w, re.w, im.w);
}

// y = x o w on (n, cols) planes of V (float4: 4 columns a vector, or float),
// w of cols V broadcast over the rows.  Thread (blockIdx.x, threadIdx.x)
// owns one column vector and loads its twiddle once; blockIdx.y walks row
// groups of TW_ROWS (grid-stride past 65535 groups).  All TW_ROWS loads of
// both planes are issued before any store.  Idx: int where n * cols < 2^31.
template <typename V, typename Idx>
__global__ void __launch_bounds__(TW_THREADS) ctwiddle_kernel(
    const V* __restrict__ xr, const V* __restrict__ xi, const V* __restrict__ wr,
    const V* __restrict__ wi, V* __restrict__ yr, V* __restrict__ yi, int n, int cols) {
  const int col = blockIdx.x * TW_THREADS + threadIdx.x;
  if (col >= cols) return;
  const V c = wr[col];
  const V s = wi[col];
  for (int r0 = blockIdx.y * TW_ROWS; r0 < n; r0 += gridDim.y * TW_ROWS) {
    V a[TW_ROWS], b[TW_ROWS];
#pragma unroll
    for (int r = 0; r < TW_ROWS; ++r) {
      if (r0 + r < n) {
        const Idx off = (Idx)(r0 + r) * cols + col;
        a[r] = xr[off];
        b[r] = xi[off];
      }
    }
#pragma unroll
    for (int r = 0; r < TW_ROWS; ++r) {
      if (r0 + r < n) {
        const Idx off = (Idx)(r0 + r) * cols + col;
        V re, im;
        cmul(a[r], b[r], c, s, re, im);
        yr[off] = re;
        yi[off] = im;
      }
    }
  }
}

template <typename V>
void launch_ctwiddle(const float* xr, const float* xi, const float* wr, const float* wi, float* yr,
                     float* yi, int n, int cols, bool wide, cudaStream_t stream) {
  const int groups = (n + TW_ROWS - 1) / TW_ROWS;
  const dim3 grid((cols + TW_THREADS - 1) / TW_THREADS, groups < TW_MAX_GRID_Y ? groups : TW_MAX_GRID_Y);
  const V* x_r = reinterpret_cast<const V*>(xr);
  const V* x_i = reinterpret_cast<const V*>(xi);
  const V* w_r = reinterpret_cast<const V*>(wr);
  const V* w_i = reinterpret_cast<const V*>(wi);
  V* y_r = reinterpret_cast<V*>(yr);
  V* y_i = reinterpret_cast<V*>(yi);
  if (wide) {
    ctwiddle_kernel<V, long long><<<grid, TW_THREADS, 0, stream>>>(x_r, x_i, w_r, w_i, y_r, y_i, n, cols);
  } else {
    ctwiddle_kernel<V, int><<<grid, TW_THREADS, 0, stream>>>(x_r, x_i, w_r, w_i, y_r, y_i, n, cols);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15u) == 0; }

}  // namespace

extern "C" {

int sumvec_fft_cmatmul(const float* ar, const float* ai, const float* br, const float* bi,
                       float* cr, float* ci, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (ai != nullptr && ci != nullptr) {
    cmatmul_kernel<true, true><<<grid, TPB, 0, stream>>>(ar, ai, br, bi, cr, ci, M, K, N);
  } else if (ai != nullptr) {
    cmatmul_kernel<true, false><<<grid, TPB, 0, stream>>>(ar, ai, br, bi, cr, ci, M, K, N);
  } else if (ci != nullptr) {
    cmatmul_kernel<false, true><<<grid, TPB, 0, stream>>>(ar, ai, br, bi, cr, ci, M, K, N);
  } else {
    cmatmul_kernel<false, false><<<grid, TPB, 0, stream>>>(ar, ai, br, bi, cr, ci, M, K, N);
  }
  return (int)cudaGetLastError();
}

int sumvec_fft_ctwiddle(const float* xr, const float* xi, const float* wr, const float* wi,
                        float* yr, float* yi, int n, int d, cudaStream_t stream) {
  // float4 where every row of every plane starts on 16 bytes; one float a
  // thread otherwise (d % 4 != 0, e.g. the padded plan's dp = 121, or a
  // contiguous view at an odd offset)
  const bool vec = d % 4 == 0 && aligned16(xr) && aligned16(xi) && aligned16(wr) && aligned16(wi) &&
                   aligned16(yr) && aligned16(yi);
  const bool wide = (long long)n * d >= (1LL << 31);
  if (vec) {
    launch_ctwiddle<float4>(xr, xi, wr, wi, yr, yi, n, d / 4, wide, stream);
  } else {
    launch_ctwiddle<float>(xr, xi, wr, wi, yr, yi, n, d, wide, stream);
  }
  return (int)cudaGetLastError();
}

const char* sumvec_fft_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
