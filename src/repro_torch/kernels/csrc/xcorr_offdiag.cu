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
// f32 CUDA-core ridge (20 FLOP/B): bound by operations (32 us at
// 67 TFLOP/s); at d = 8192 16x the work for 4x the bytes.
//
// Design.  The TPU kernel walks a sequential (I, J, K) grid and carries one
// scalar in its resident output block.  Hopper blocks run in no order, so:
//   pass 1 (xcorr_tile_kernel): one block per BM x BN = 128 x 128 tile of C
//   loops over the whole batch contraction n itself.  C = Z1^T Z2 is a TN
//   product: a K slice of a column slab, rows k0 .. k0 + XK of
//   z[:, j0 : j0 + 128], is already in outer-product layout (row k of the
//   slice holds the k-th term's 128 factors), so the slabs are staged as they
//   lie in memory, no transpose.  A ring of STAGES = 3 slices of XK = 32 rows
//   of both slabs is kept in flight in shared memory: where every row starts
//   on 16 bytes (d % 4 == 0, both operands aligned) by bulk copies of the
//   copy engine, one 512-byte row a lane of warp 0, completion counted in
//   the stage's mbarrier; otherwise (the scalar twin of the same template,
//   chosen in the C entry: d = 2039, a view 4 bytes off) by 4-byte cp.async
//   pieces of every thread, zeros past d.  The slice after next is issued
//   before the current one is consumed, and one block barrier a slice frees
//   its stage.  Each of the 16 x 16 threads keeps a TM x TN = 8 x 8 register
//   tile (rows 4 ty + 64 a + i, columns 4 tx + 64 c + j), fed by four 16-byte
//   shared reads a k: 64 FMAs per 16 floats read, the 4 FMAs a float at
//   which the shared-memory pipe keeps pace with the FMA pipe; a quarter
//   warp's B reads cover 128 contiguous bytes, conflict-free, its A reads
//   one address.  The slice loop is unrolled by 8, not 32 (a smaller loop
//   body ran faster).  The epilogue squares the tile in registers, drops
//   what lies past d, masks the GLOBAL diagonal only in tiles that meet it
//   (blockIdx.x == blockIdx.y here), and reduces in a fixed order (warp
//   shuffles, then the 8 warp sums in order) to one partial per tile.
//   pass 2 (sum_partials_kernel): one block sums the partials in a fixed
//   order (strided per thread, then a fixed tree).
// No atomics: the result is bit-identical from run to run.  Two blocks of
// 256 threads an SM (127 registers, 2 x 96 KB of ring): 256 tiles at
// d = 2048, one wave on 132 SMs.  Plain f32 FMA, no tensor cores.
// The design search (PERF.md) also timed 8 x 16 and 16 x 8 thread
// tiles (one block an SM, or two of 128 threads), 64 x 128 tiles of 128
// threads, 64 x 256 tiles whose warps share their A rows, slices of 8 and 16
// rows with 2 to 6 stages, and a fully unrolled slice loop: none was faster
// at both d = 2048 and d = 8192 by more than ~2 %, most were slower.  The
// kernel reaches about half the f32 peak: the shared-memory reads (a
// wavefront for each 4 bytes a lane receives) keep pace with the FMAs only
// just.

// C interface: pointers to contiguous float32 device buffers, sizes as int,
// the CUDA stream; the entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <atomic>

#include "sm90_async.cuh"

namespace {

using namespace sm90;

constexpr int GY = 16;               // thread grid: GY rows x GX columns
constexpr int GX = 16;
constexpr int TM = 8;                // rows of C a thread owns (a multiple of 4)
constexpr int TN = 8;                // columns of C a thread owns (a multiple of 4)
constexpr int BM = GY * TM;          // C tile rows: features of z1
constexpr int BN = GX * TN;          // C tile columns: features of z2
constexpr int XK = 32;               // batch rows per ring stage
constexpr int STAGES = 3;
constexpr int TPB = GY * GX;
constexpr int MIN_BLOCKS = 2;        // blocks an SM (registers: 65536 / (MIN_BLOCKS TPB))
constexpr int SLAB_A = XK * BM;      // floats of z1's slice
constexpr int STAGE = XK * (BM + BN);
constexpr int SMEM = STAGES * STAGE * 4 + STAGES * 8;

// Rows [k0, k0 + rows) x the slabs' live columns of both operands into stage
// ``sa`` (row pitch BM) / ``sb`` (row pitch BN), completion counted in
// ``bar``.  BULK: warp 0, one row of one operand a lane; otherwise 4-byte
// pieces of every thread (zeros past d) and one arrival each.
template <bool BULK>
__device__ __forceinline__ void stage_slice(float* sa, float* sb, const float* __restrict__ z1,
                                            const float* __restrict__ z2, int k0, int rows, int d, int i0,
                                            int j0, int ca, int cb, unsigned bar) {
  const int tid = threadIdx.x;
  if (BULK) {
    if (tid >= 32) return;
    if (tid == 0) mbar_arrive_expect_tx(bar, rows * (ca + cb) * 4);
    __syncwarp();
    for (int e = tid; e < 2 * rows; e += 32) {
      const bool second = e >= rows;
      const int r = second ? e - rows : e;
      const long long row = (long long)(k0 + r) * d;
      if (second) bulk_copy(smem_addr(sb + r * BN), z2 + row + j0, cb * 4, bar);
      else bulk_copy(smem_addr(sa + r * BM), z1 + row + i0, ca * 4, bar);
    }
  } else {
    for (int e = tid; e < rows * BM; e += TPB) {
      const int r = e / BM;
      const int c = e - r * BM;
      cp_async<1>(sa + e, c < ca ? z1 + (long long)(k0 + r) * d + i0 + c : z1, c < ca ? 4 : 0);
    }
    for (int e = tid; e < rows * BN; e += TPB) {
      const int r = e / BN;
      const int c = e - r * BN;
      cp_async<1>(sb + e, c < cb ? z2 + (long long)(k0 + r) * d + j0 + c : z2, c < cb ? 4 : 0);
    }
    cp_async_arrive(bar);
  }
}

// one k of a stage into a thread's TM x TN tile: rows 4 GY a + 4 ty + (0..3),
// columns 4 GX c + 4 tx + (0..3); TM / 4 + TN / 4 16-byte reads, TM TN FMAs
__device__ __forceinline__ void tile_step(const float* sa, const float* sb, int ty, int tx,
                                          float (&acc)[TM][TN]) {
  float x[TM], y[TN];
#pragma unroll
  for (int a = 0; a < TM / 4; ++a) {
    const float4 v = *reinterpret_cast<const float4*>(sa + 4 * GY * a + 4 * ty);
    x[4 * a] = v.x;
    x[4 * a + 1] = v.y;
    x[4 * a + 2] = v.z;
    x[4 * a + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < TN / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(sb + 4 * GX * c + 4 * tx);
    y[4 * c] = v.x;
    y[4 * c + 1] = v.y;
    y[4 * c + 2] = v.z;
    y[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
}

template <bool BULK>
__global__ void __launch_bounds__(TPB, MIN_BLOCKS) xcorr_tile_kernel(
    const float* __restrict__ z1, const float* __restrict__ z2, float* __restrict__ partial, int n, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + STAGES * STAGE);
  __shared__ float warp_sums[TPB / 32];

  const int tid = threadIdx.x;
  const int ty = tid / GX;
  const int tx = tid % GX;
  const int i0 = blockIdx.y * BM;  // rows of C: features of z1
  const int j0 = blockIdx.x * BN;  // columns of C: features of z2
  const int ca = min(BM, d - i0);
  const int cb = min(BN, d - j0);
  const int nk = (n + XK - 1) / XK;
  auto bar = [&](int s) { return smem_addr(bars + s); };
  auto issue = [&](int kc) {
    const int s = kc % STAGES;
    float* sa = smem + s * STAGE;
    stage_slice<BULK>(sa, sa + SLAB_A, z1, z2, kc * XK, min(XK, n - kc * XK), d, i0, j0, ca, cb, bar(s));
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar(s), BULK ? 1 : TPB);
    mbar_init_fence();
  }
  __syncthreads();
  for (int kc = 0; kc < STAGES - 1 && kc < nk; ++kc) issue(kc);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    // the stage of slice kc - 1 is free (the barrier closing the last trip)
    if (kc + STAGES - 1 < nk) issue(kc + STAGES - 1);
    const int s = kc % STAGES;
    mbar_wait(bar(s), (kc / STAGES) & 1);
    const float* sa = smem + s * STAGE;
    const float* sb = sa + SLAB_A;
    const int live = n - kc * XK;
    if (live >= XK) {
#pragma unroll 8
      for (int kk = 0; kk < XK; ++kk) tile_step(sa + kk * BM, sb + kk * BN, ty, tx, acc);
    } else {
      for (int kk = 0; kk < live; ++kk) tile_step(sa + kk * BM, sb + kk * BN, ty, tx, acc);
    }
    __syncthreads();
  }
  if (!BULK) cp_async_wait_all();

  // square, drop rows / columns past d and the global diagonal (only in a
  // tile that meets it), fixed order
  const bool diag_tile = i0 < j0 + BN && j0 < i0 + BM;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = 4 * GY * (i / 4) + 4 * ty + (i & 3);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = 4 * GX * (j / 4) + 4 * tx + (j & 3);
      if (r < ca && c < cb && !(diag_tile && i0 + r == j0 + c)) sum = fmaf(acc[i][j], acc[i][j], sum);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = sum;
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

template <bool BULK>
cudaError_t run_tiles(const float* z1, const float* z2, float* partial, int n, int d, cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(xcorr_tile_kernel<BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const dim3 grid((d + BN - 1) / BN, (d + BM - 1) / BM);
  xcorr_tile_kernel<BULK><<<grid, TPB, SMEM, stream>>>(z1, z2, partial, n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// partial: ceil(d / BM) * ceil(d / BN) floats of scratch; out: one float
int xcorr_offdiag_off_diagonal_sq_sum(const float* z1, const float* z2, float* partial, float* out,
                                      int n, int d, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  // bulk row copies where every row of both operands starts on 16 bytes
  const bool bulk = d % 4 == 0 && aligned(z1, 16) && aligned(z2, 16);
  cudaError_t err = bulk ? run_tiles<true>(z1, z2, partial, n, d, stream)
                         : run_tiles<false>(z1, z2, partial, n, d, stream);
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, TPB, 0, stream>>>(partial, ((d + BM - 1) / BM) * ((d + BN - 1) / BN), out);
  return (int)cudaGetLastError();
}

const char* xcorr_offdiag_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
