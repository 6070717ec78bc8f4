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
//   FLOP/B: bound by bytes, 0.0013 ms (each input element is used N = d/b
//   times); at d = 8192 (65, 512, 64) 273 MFLOP against 18.1 MB: bytes,
//   0.0054 ms, with the FMAs alone at 0.0041 ms.
//   freq_mat (65, 512, 16) x (65, 16, 16): the same 17 MFLOP against
//   4.3 MB: bound by bytes; at d = 8192 (N = 64) 16 FLOP/B, still bytes.
//
// Design.  On the TPU the K grid axis carried the sum in the resident output
// block; here the loop over K runs inside one CUDA block, so every output is
// a fixed-order f32 FMA sum (no atomics, deterministic).
//   pmatmul (redesigned): a block owns 16 rows and all of N up to 132
//   columns, so the DFT's N = 130 and its vjp's N = 128 need one block
//   column, not three 64-wide tiles of which the last holds 2 live columns.
//   A producer warp keeps a 4-stage ring of 32-deep K slices in flight: B's
//   slice (the contiguous slab b[k0 N, (k0 + 32) N) where N <= 132) by one
//   bulk copy of the copy engine, A's by cp.async in 16-byte pieces.  Where
//   A's rows are not 16-byte aligned (the vjp's K = 130, the q = 1
//   synthesis' K = 65) the block's 16 rows of A, contiguous in memory, stay
//   resident instead, one bulk copy: 8- or 4-byte cp.async pieces cost the
//   warp's load units about a cycle each.  Four consumer warps hold 8 x 4
//   register tiles fed by 4-float shared reads (12 reads per 128 FMAs); two
//   of them take each slice's first 16 k, two the last 16, and their sums
//   are added in a fixed order at the end.  Measured on NVIDIA H100 80GB
//   HBM3, 700 W (tools/kernel_ab.py, PERF.md): 16 rows a block (256 blocks
//   at M = 4096, two per SM) beat 32 and 8; 3 stages came within 2 % of 4,
//   6 lost.
//   Every block reads all of B (66.5 KB at the main shape), so L2 traffic
//   as much as the FMAs holds it above its bound.
//   freq_outer (redesigned): two kernels, picked by the entry from N and
//   NB; each block sums all of K for its outputs.  Narrow outputs (N or NB
//   < 64; d = 2048's N = 16): a few dependent steps, not bytes or FMAs, set
//   the time (an empty launch takes ~1 us of device time, a trip to memory
//   about as long), so the design keeps them few.  The output tile is halved
//   (8 x 8 at d = 2048) until it holds at most one 4 x 4 tile a thread and
//   the grid has a block an SM (260 blocks); each
//   thread loads its 16-byte pieces of a's and b's rows straight into
//   registers, 16 rows at once (all of its rows at d = 2048), for a 4 x 4
//   register tile (no shared-memory staging, no barrier in the loop), and
//   the 32 K groups' tiles of a 128-thread block are summed in one
//   shared-memory pass and a fixed butterfly of shuffles.  Wide
//   outputs (N, NB >= 64; d = 8192): the FMAs set the time.  Blocks of 64 x
//   32 (130, one an SM) hold all of K in shared memory (four 128-row stages,
//   192 KB): a's 64 and b's 32 columns of 128 rows by one 2-D tensor copy
//   (TMA) each; 8 x 8 register tiles in halves, so a
//   warp (one K group) reads contiguous 16-byte pieces.  Measured on NVIDIA
//   H100 80GB HBM3, 700 W (PERF.md): d = 2048 about 0.0042 ms (from 0.0089;
//   the aim of 0.0026 missed, ~3.3x the bound), d = 8192 about 0.0117 ms
//   (from 0.048; below bmm's 0.0126, the aim of 0.0108 missed: the FMA loop,
//   four 16-byte shared reads to 64 FMAs, runs at about a third of the f32
//   peak).  Dropped after measuring: a K split over a thread-block cluster
//   summed through distributed shared memory (a fixed cost that grew with
//   the cluster, 7.7 us at K = 1 for 4 blocks), shared-memory rings for the
//   narrow tiles, a bulk copy a row or cp.async pieces for b's columns,
//   16 x 8 register tiles, 512 threads, 256-thread blocks for narrow tiles.
//   freq_mat (redesigned): a stream of rows of a[f] against one m[f] (at
//   most 64 x 64 = 16 KiB on the paper's widths).  One wave of small blocks,
//   each owning up to 128 rows of y[f] and all its columns (up to 64): at
//   the main path's shapes the block's rows of a (contiguous) and m[f] come
//   by one bulk copy each; a thread keeps a 4-row x 4- (N2 <= 28) or 8-
//   (N2 > 28) column strip in registers and stores it with 16-byte stores.
//   The old 64 x 16 tiles staged three quarters zeros at N = 16.  A scalar
//   twin (4-byte pieces and stores) takes N or N2 % 4 != 0 and operands off
//   a 16-byte boundary; the entry picks it from sizes and pointers.
// Ragged edges are masked at load (zero fill) and at store; nothing is
// padded in device memory.  Plain f32 FMA, no tensor cores (later work).
//
// C interface: pointers to contiguous float32 device buffers, sizes as int,
// the CUDA stream; each entry returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "sm90_async.cuh"

namespace {

using namespace sm90;

constexpr int PM_BM = 16;                      // rows of A (and C) a block owns
constexpr int PM_TM = 8;                       // rows a thread owns
constexpr int PM_RG = PM_BM / PM_TM;           // row groups
constexpr int PM_KH = 2;                       // K halves: two warps share a row group
constexpr int PM_CONSUMERS = 32 * PM_RG * PM_KH;
constexpr int PM_THREADS = PM_CONSUMERS + 32;  // + one producer warp
constexpr int PM_BN = 132;                     // columns a block owns: 32 lanes x 4, and a tail of 4
constexpr int PM_KC = 32;                      // K depth of one ring stage
constexpr int PM_STAGES = 4;
constexpr int PM_AP = PM_KC + 4;               // row pitch of the A tile (floats)
constexpr int PM_A_FLOATS = PM_BM * PM_AP;
constexpr int PM_STAGE_FLOATS = PM_A_FLOATS + PM_KC * PM_BN;
constexpr int PM_KPANEL = 256;                 // K up to which A's 16 rows may stay resident
constexpr int PM_PANEL_FLOATS = PM_BM * PM_KPANEL + 4;  // + the last step's overhang
constexpr int PM_RED_FLOATS = (PM_TM * 4 + 1) * 32 * PM_RG;  // one K half's sums
// shared memory: the ring, the A panel (only when resident), the K half's
// sums, the barriers
constexpr int PM_SMEM_RING = (PM_STAGES * PM_STAGE_FLOATS + PM_RED_FLOATS) * 4 + 2 * PM_STAGES * 8;
constexpr int PM_SMEM_PANEL = PM_SMEM_RING + PM_PANEL_FLOATS * 4;

// A stays resident where its rows could go only in 8- or 4-byte pieces
// (K % 4 != 0: the vjp's K = 130, the q = 1 synthesis' K = 65)
__host__ __device__ inline bool resident_a(int K) { return K <= PM_KPANEL && K % 4 != 0; }

// The producer warp stages rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of
// a row-major (R, C) matrix with row stride ld (shared row pitch ``pitch``)
// in pieces of W floats, zeros outside; C % W == 0, so a piece is wholly
// inside or outside.
template <int W, int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(float* s, int pitch, const float* g, int ld, int r0, int c0, int R,
                                           int C, int lane) {
  constexpr int PER_ROW = COLS / W;
  for (int e = lane; e < ROWS * PER_ROW; e += 32) {
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * W;
    const bool in = r0 + r < R && c0 + c < C;
    cp_async<W>(s + r * pitch + c, in ? g + (long long)(r0 + r) * ld + c0 + c : g, in ? 4 * W : 0);
  }
}

// ... and the ``count`` floats g[base, base + count) of a buffer of ``end``
// floats, contiguous (W | base), zeros past its end
template <int W>
__device__ __forceinline__ void stage_flat(float* s, const float* g, long long base, int count, long long end,
                                           int lane) {
  for (int f = lane * W; f < count; f += 32 * W) {
    const long long left = end - (base + f);
    const unsigned bytes = left >= W ? 4 * W : left > 0 ? 4 * (unsigned)left : 0;
    cp_async<W>(s + f, bytes ? g + base + f : g, bytes);
  }
}

__device__ __forceinline__ void stage_flat_w(int w, float* s, const float* g, long long base, int count,
                                             long long end, int lane) {
  if (w == 4) stage_flat<4>(s, g, base, count, end, lane);
  else if (w == 2) stage_flat<2>(s, g, base, count, end, lane);
  else stage_flat<1>(s, g, base, count, end, lane);
}

template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile_w(int w, float* s, int pitch, const float* g, int ld, int r0, int c0,
                                             int R, int C, int lane) {
  if (w == 4) stage_tile<4, ROWS, COLS>(s, pitch, g, ld, r0, c0, R, C, lane);
  else if (w == 2) stage_tile<2, ROWS, COLS>(s, pitch, g, ld, r0, c0, R, C, lane);
  else stage_tile<1, ROWS, COLS>(s, pitch, g, ld, r0, c0, R, C, lane);
}

// four consecutive floats of a row in shared memory: one 16-byte load where
// the pitch allows, else two 8-byte or four 4-byte loads
template <int R>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (R == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (R == 2) {
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 2);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

// k = 4 k4 .. 4 k4 + 3 of one stage into a thread's 8 x 4 tile (and its
// tail output): 8 reads of 4 floats of A (broadcast: a warp shares its rows),
// 4 of B, 128 (+ 4) FMAs in k order; with PART only the first ``live`` k
// (the last slice of a K that is no multiple of 4).  A rows at ``apitch``,
// B rows at ``bpitch``.
template <int AR, int BR, bool PART>
__device__ __forceinline__ void pm_step(const float* sa, int apitch, const float* sb, int bpitch, int k4, int live,
                                        int rg, int lane, bool tail, float (&acc)[PM_TM][4], float& acc_t) {
  float4 av[PM_TM], bv[4];
#pragma unroll
  for (int i = 0; i < PM_TM; ++i) av[i] = load4<AR>(sa + (rg * PM_TM + i) * apitch + 4 * k4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) bv[kk] = load4<BR>(sb + (4 * k4 + kk) * bpitch + 4 * lane);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (PART && 4 * k4 + kk >= live) break;
    const float4 y = bv[kk];
#pragma unroll
    for (int i = 0; i < PM_TM; ++i) {
      const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
      acc[i][0] = fmaf(x, y.x, acc[i][0]);
      acc[i][1] = fmaf(x, y.y, acc[i][1]);
      acc[i][2] = fmaf(x, y.z, acc[i][2]);
      acc[i][3] = fmaf(x, y.w, acc[i][3]);
    }
  }
  if (tail) {
    const float4 x = load4<AR>(sa + (rg * PM_TM + lane / 4) * apitch + 4 * k4);
    const float* y = sb + 4 * k4 * bpitch + 128 + lane % 4;
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (PART && 4 * k4 + kk >= live) break;
      acc_t = fmaf(xs[kk], y[kk * bpitch], acc_t);
    }
  }
}

// C = A @ B, A (M, K), B (K, N), row-major f32.  A block owns PM_BM = 16
// rows and PM_BN = 132 columns of C, so N = 128 and N = 130 take one block
// column.  Warp specialised:
//   * one producer warp fills a ring of PM_STAGES stages, each a PM_KC-deep
//     slice of B (and of A when K > PM_KPANEL).  Where N <= PM_BN the B
//     slice is the contiguous slab b[k0 N, (k0 + PM_KC) N), kept at pitch N,
//     and goes by one bulk copy (the copy engine, not the warp's load units)
//     when b is 16-byte aligned.  Where A's rows are not 16-byte aligned
//     (K % 4 != 0) and K <= PM_KPANEL the block's 16 rows of A, contiguous
//     in memory, stay resident at pitch K, loaded with the first slice by
//     one bulk copy where a is 16-byte aligned (the vjp's K = 130, the q = 1
//     synthesis' K = 65).  Anything else goes by
//     cp.async in aw- / bw-float pieces with zero fill: A otherwise in
//     PM_KC-deep slices at pitch PM_AP, B otherwise, and the last slice
//     of a K that is no multiple of PM_KC (the flat B slab only as deep as
//     the consumers read).  A stage is full when its barrier has the
//     producer's 33 arrivals and the bulk bytes; the consumers' 4 arrivals
//     free it again.
//   * four consumer warps: warp (h, rg) owns rows 8 rg .. 8 rg + 7; lane l
//     owns columns 4 l .. 4 l + 3 of them (an 8 x 4 register tile) and,
//     where the block's columns run past 128, tail output (row 8 rg + l / 4,
//     column 128 + l % 4).  Warp h takes k % PM_KC in [16 h, 16 h + 16) of
//     every slice, and no k past K; at the end the two halves' sums are
//     added in shared memory, h = 0's first.  So every output is two f32
//     FMA chains in k order and one add, always in that order:
//     deterministic, no atomics.
// AR, BR: the float width of A and B reads (4, 2 or 1, from the pitch).
template <int AR, int BR>
__global__ void __launch_bounds__(PM_THREADS) pmatmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int M, int K, int N,
    int aw, int bw, int b_bulk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const bool resident = resident_a(K);
  float* panel = smem + PM_STAGES * PM_STAGE_FLOATS;
  float* red = panel + (resident ? PM_PANEL_FLOATS : 0);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(red + PM_RED_FLOATS);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * PM_BM;
  const int n0 = blockIdx.y * PM_BN;
  const bool flat = N <= PM_BN;
  const int pitch = flat ? N : PM_BN;
  const int nk = (K + PM_KC - 1) / PM_KC;
  auto full_bar = [&](int s) { return smem_addr(bars + s); };
  auto empty_bar = [&](int s) { return smem_addr(bars + PM_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < PM_STAGES; ++s) {
      mbar_init(full_bar(s), 33);
      mbar_init(empty_bar(s), PM_RG * PM_KH);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == PM_RG * PM_KH) {  // the producer
    const int rows = min(PM_BM, M - m0);
    const bool bulk_panel = resident && aw == 4 && rows * K % 4 == 0;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % PM_STAGES;
      mbar_wait(empty_bar(s), ((kc / PM_STAGES) & 1) ^ 1);
      float* sa = smem + s * PM_STAGE_FLOATS;
      float* sb = sa + PM_A_FLOATS;
      const int k0 = kc * PM_KC;
      const bool whole = k0 + PM_KC <= K;
      const int depth = whole ? PM_KC : (K - k0 + 3) / 4 * 4;  // k the consumers read
      const bool bulk_b = whole && b_bulk;
      if (lane == 0) {
        const int bytes_b = bulk_b ? PM_KC * N * 4 : 0;
        mbar_arrive_expect_tx(full_bar(s), bytes_b + (kc == 0 && bulk_panel ? rows * K * 4 : 0));
      }
      __syncwarp();
      if (bulk_b) {
        if (lane == 0) bulk_copy(smem_addr(sb), b + (long long)k0 * N, PM_KC * N * 4, full_bar(s));
      } else if (flat) {
        stage_flat_w(bw, sb, b, (long long)k0 * N, depth * N, (long long)K * N, lane);
      } else {
        stage_tile_w<PM_KC, PM_BN>(bw, sb, PM_BN, b, N, k0, n0, K, N, lane);
      }
      if (resident) {
        if (kc == 0 && bulk_panel) {
          if (lane == 0) bulk_copy(smem_addr(panel), a + (long long)m0 * K, rows * K * 4, full_bar(s));
        } else if (kc == 0) {
          stage_flat_w(aw, panel, a, (long long)m0 * K, rows * K, (long long)M * K, lane);
        }
      } else {
        stage_tile_w<PM_BM, PM_KC>(aw, sa, PM_AP, a, K, m0, k0, M, K, lane);
      }
      cp_async_arrive(full_bar(s));
    }
    cp_async_wait_all();
  } else {  // the consumers
    const int rg = warp % PM_RG;
    const int h = warp / PM_RG;
    const bool tail = n0 + 128 < N;  // uniform over the block
    const int apitch = resident ? K : PM_AP;
    float acc[PM_TM][4];
#pragma unroll
    for (int i = 0; i < PM_TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float acc_t = 0.f;
    constexpr int STEPS = PM_KC / 4 / PM_KH;  // k4 steps of a warp per slice
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % PM_STAGES;
      mbar_wait(full_bar(s), (kc / PM_STAGES) & 1);
      const float* sa = resident ? panel + kc * PM_KC : smem + s * PM_STAGE_FLOATS;
      const float* sb = smem + s * PM_STAGE_FLOATS + PM_A_FLOATS;
      const int live = K - kc * PM_KC;  // k left, counted from this slice's start
      if (live >= PM_KC) {
#pragma unroll
        for (int q = 0; q < STEPS; ++q)
          pm_step<AR, BR, false>(sa, apitch, sb, pitch, h * STEPS + q, 0, rg, lane, tail, acc, acc_t);
      } else {
        for (int q = 0; q < STEPS; ++q) {
          const int k4 = h * STEPS + q;
          if (4 * k4 + 4 <= live) pm_step<AR, BR, false>(sa, apitch, sb, pitch, k4, 0, rg, lane, tail, acc, acc_t);
          else if (4 * k4 < live) pm_step<AR, BR, true>(sa, apitch, sb, pitch, k4, live, rg, lane, tail, acc, acc_t);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(s));
    }

    // h = 1 hands its sums to h = 0, which adds them to its own and stores
    const int t = rg * 32 + lane;
    constexpr int T = 32 * PM_RG;
    if (h == 1) {
#pragma unroll
      for (int i = 0; i < PM_TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[(i * 4 + j) * T + t] = acc[i][j];
      red[PM_TM * 4 * T + t] = acc_t;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(PM_CONSUMERS) : "memory");
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < PM_TM; ++i) {
        const int gm = m0 + rg * PM_TM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gn = n0 + 4 * lane + j;
          const float v = acc[i][j] + red[(i * 4 + j) * T + t];
          if (gm < M && gn < N) c[(long long)gm * N + gn] = v;
        }
      }
      const int tm = m0 + rg * PM_TM + lane / 4;
      const int tn = n0 + 128 + lane % 4;
      if (tail && tm < M && tn < N) c[(long long)tm * N + tn] = acc_t + red[PM_TM * 4 * T + t];
    }
  }
}

// the piece a row-major operand is staged in: 16 bytes where every row starts
// on 16 bytes, 8 where on 8, else 4
int piece(const float* p, int ld) {
  if (ld % 4 == 0 && aligned(p, 16)) return 4;
  if (ld % 2 == 0 && aligned(p, 8)) return 2;
  return 1;
}

// the float width a pitch allows for 16-, 8- or 4-byte shared reads
int width(int pitch) { return pitch % 4 == 0 ? 4 : pitch % 2 == 0 ? 2 : 1; }

// the widest piece (4, 2 or 1 floats) every address p + W i is aligned to
int base_width(const float* p) { return aligned(p, 16) ? 4 : aligned(p, 8) ? 2 : 1; }

template <int AR, int BR>
cudaError_t run_pmatmul(const float* a, const float* b, float* c, int M, int K, int N, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in, once per device
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(pmatmul_kernel<AR, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize, PM_SMEM_PANEL);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const bool flat = N <= PM_BN;
  // a resident A panel starts at m0 K with m0 % 16 == 0, a flat B slab at
  // k0 N with k0 % 32 == 0: only the base's alignment counts for them
  const bool resident = resident_a(K);
  const int aw = resident ? base_width(a) : piece(a, K);
  const int bw = flat ? base_width(b) : piece(b, N);
  const dim3 grid((M + PM_BM - 1) / PM_BM, (N + PM_BN - 1) / PM_BN);
  const int smem = resident ? PM_SMEM_PANEL : PM_SMEM_RING;
  pmatmul_kernel<AR, BR><<<grid, PM_THREADS, smem, stream>>>(a, b, c, M, K, N, aw, bw, flat && bw == 4);
  return cudaGetLastError();
}

template <int AR>
cudaError_t run_pmatmul_b(int br, const float* a, const float* b, float* c, int M, int K, int N,
                          cudaStream_t stream) {
  if (br == 4) return run_pmatmul<AR, 4>(a, b, c, M, K, N, stream);
  if (br == 2) return run_pmatmul<AR, 2>(a, b, c, M, K, N, stream);
  return run_pmatmul<AR, 1>(a, b, c, M, K, N, stream);
}

constexpr int FO_EDGE = 64;      // freq_outer: rows / columns of G a block owns at most
constexpr int FO_THREADS = 128;  // the register-fed kernel (N or NB < FO_EDGE)
constexpr int FO_MIN_EDGE = 8;   // rows / columns of G its blocks own at least, where G has them
constexpr int FO_KG = 32;        // thread groups that split a block's K rows, at most
constexpr int FO_ROWS = 16;      // K rows a thread has in flight at once
// the staged kernel (N and NB of at least FO_EDGE)
constexpr int FS_THREADS = 256;
constexpr int FS_KG = 8;         // thread groups that split a block's K rows, at most
constexpr int FS_STAGES = 4;
constexpr int FS_STAGE_FLOATS = 128 * (FO_EDGE + FO_EDGE / 2) + 64;  // 128 rows of a 64 x 32 block
// how an operand's rows reach shared memory: one 2-D tensor copy (TMA) of
// the block's columns of kc rows (rows of a multiple of 4 floats on a
// 16-byte aligned base), or 4-byte cp.async pieces
constexpr int FS_TENSOR = 0, FS_PIECES = 1;
// shared memory: the barriers (128 bytes, so that the ring's tensor copies
// land on 128 bytes), then the ring or (after it) the groups' tiles
constexpr int FS_SMEM_MAX = 128 + std::max(FS_STAGES * FS_STAGE_FLOATS, FS_THREADS * 64) * 4;

// four consecutive floats of a row from device memory: one 16-byte load
// (V), or four 4-byte loads with zeros past ``left`` live columns
template <bool V>
__device__ __forceinline__ float4 fo_load(const float* p, int left) {
  if constexpr (V) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(left > 0 ? p[0] : 0.f, left > 1 ? p[1] : 0.f, left > 2 ? p[2] : 0.f, left > 3 ? p[3] : 0.f);
  }
}

// out[f, i, j] = sum_k a[f, k, i] * b[f, k, j];  a: (F, K, N), b: (F, K, NB).
// Block (x, y, f) owns rows [ei y, ei y + ei) and columns [ej x, ej x + ej)
// of G[f] and all of K: the host halves the tile (64 x 64 at most) until
// it holds at most FO_THREADS 4 x 4 tiles and the grid fills the card, so
// no sum is split across blocks.  Thread t
// holds a 4 x 4 register tile (rows 4 ti.., columns 4 tj..) and takes the
// K rows g, g + kg_n, ..., g = t / tiles, FO_ROWS at a time: the four
// floats of a's and of b's row it needs come straight from device memory
// (16-byte loads where VA / VB), all FO_ROWS rows in flight before the
// FMAs, so a block waits on memory about once per FO_ROWS kg_n rows (once
// in all at d = 2048).  No shared-memory staging, no barrier in the loop.
// Then every group's tile goes to shared memory (one barrier) and each
// output is summed over the groups by ``sub`` threads of a warp, each over
// kg_n / sub consecutive groups in order, combined by a fixed butterfly of
// shuffles: one fixed-order f32 sum per output, deterministic, no atomics.
template <bool VA, bool VB>
__global__ void __launch_bounds__(FO_THREADS) freq_outer_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int K, int N, int NB, int ei,
    int ej, int out_vec) {
  __shared__ float4 part[FO_THREADS * 4];  // every group's 4 x 4 tiles
  const int t = threadIdx.x;
  const int f = blockIdx.z;
  const int i0 = blockIdx.y * ei;
  const int j0 = blockIdx.x * ej;
  const int rows = min(ei, N - i0), cols = min(ej, NB - j0);
  const int tc = (cols + 3) / 4, tiles = (rows + 3) / 4 * tc;
  int kg_n = 1;
  while (2 * kg_n <= FO_KG && 2 * kg_n * tiles <= FO_THREADS) kg_n *= 2;
  const int g = t / tiles, ti = t % tiles / tc, tj = t % tiles % tc;
  const int la = rows - 4 * ti, lb = cols - 4 * tj;  // live columns of this thread's pieces
  const float* af = a + (long long)f * K * N + i0 + 4 * ti;
  const float* bf = b + (long long)f * K * NB + j0 + 4 * tj;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  if (g < kg_n) {
    for (int k = g; k < K; k += FO_ROWS * kg_n) {
      float4 x[FO_ROWS], y[FO_ROWS];
#pragma unroll
      for (int r = 0; r < FO_ROWS; ++r) {
        const int row = k + r * kg_n;
        x[r] = y[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < K) {
          x[r] = fo_load<VA>(af + (long long)row * N, la);
          y[r] = fo_load<VB>(bf + (long long)row * NB, lb);
        }
      }
#pragma unroll
      for (int r = 0; r < FO_ROWS; ++r) {
        const float xs[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(xs[i], y[r].x, acc[i][0]);
          acc[i][1] = fmaf(xs[i], y[r].y, acc[i][1]);
          acc[i][2] = fmaf(xs[i], y[r].z, acc[i][2]);
          acc[i][3] = fmaf(xs[i], y[r].w, acc[i][3]);
        }
      }
    }
  }

  // group g's tile goes to slab g (row-major, tc float4s a row of G)
  const int q_n = 4 * tiles;
  if (g < kg_n) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[g * q_n + (4 * ti + i) * tc + tj] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  int sub = 1;  // threads (lanes of one warp) that sum one float4 of G
  while (2 * sub <= kg_n && 2 * sub * q_n <= FO_THREADS && 2 * sub <= 32) sub *= 2;
  const int span = kg_n / sub;
  for (int base = 0; base < q_n * sub; base += FO_THREADS) {  // the same trip count in every warp
    const int q = (base + t) / sub, s = (base + t) % sub;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < q_n) {
      for (int h = s * span; h < (s + 1) * span; ++h) {
        const float4 w = part[h * q_n + q];
        v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
      }
    }
    for (int m = sub / 2; m >= 1; m /= 2) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, m);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, m);
    }
    const int i = q / tc, col = 4 * (q % tc);
    if (s != 0 || q >= q_n || i >= rows) continue;
    float* o = out + ((long long)f * N + i0 + i) * NB + j0 + col;
    if (out_vec && col + 4 <= cols) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && col + j < cols; ++j) o[j] = vs[j];
    }
  }
}

// the bytes of a chunk of x[f] that reach a stage by the copy engine: a
// tensor copy's full box of kc rows x e columns (rows and columns past the
// tensor are zero-filled and counted)
__device__ __forceinline__ unsigned fs_copy_bytes(int mode, int e, int kc) {
  return mode == FS_TENSOR ? 4u * kc * e : 0u;
}

// rows [k, k + n) of x[f] (rows of C floats), columns [c0, c0 + p), into a
// ring stage at pitch p: kc rows x p columns by one tensor copy (by thread
// 0), or 4-byte pieces by every thread (zeros past C)
__device__ __forceinline__ void fs_stage(int mode, float* s, int p, const float* xf, const CUtensorMap* map,
                                         int row0, int C, int c0, int k, int n, unsigned bar, int t) {
  if (mode == FS_TENSOR) {
    if (t == 0)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
          ::"r"(smem_addr(s)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(row0 + k)
          : "memory");
  } else {
    stage_rows<1>(s, p, xf, C, k, c0, n, p, k + n, C, t, FS_THREADS);
  }
}

// The same function where N and NB are at least FO_EDGE (d = 8192), and the
// FMAs, not the latency, set the time.  Block (x, y, f) owns rows [64 y,
// 64 y + 64) of G[f] and columns [ej x, ej x + ej), ej = 64, or 32 where
// 64 would leave most SMs idle (d = 8192: 130 blocks, one an SM).  All of
// K is in flight at once where it fits (four stages of up to 128 rows, 192
// KB): each operand's block columns of kc rows by one 2-D tensor copy, at
// pitch 64 (a) and ej (b).  Thread t holds an 8 x
// 8 register tile in two halves (rows 4 ti.. and 4 tr + 4 ti.., columns
// likewise), so a warp, one K group, reads contiguous 16-byte pieces: 4
// shared reads for 64 FMAs.  Group g takes rows g, g + kg_n, ... of every
// stage; the groups' tiles then overwrite the ring and are summed in the
// order of g.
__global__ void __launch_bounds__(FS_THREADS, 1) freq_outer_staged_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int K, int N, int NB, int ej,
    int kc, int stages, int mode_a, int mode_b, int out_vec, const __grid_constant__ CUtensorMap a_map,
    const __grid_constant__ CUtensorMap b_map) {
  extern __shared__ __align__(128) float4 fs_smem4[];
  float* smem = reinterpret_cast<float*>(fs_smem4);
  const int t = threadIdx.x;
  const int f = blockIdx.z;
  const int i0 = blockIdx.y * FO_EDGE;
  const int j0 = blockIdx.x * ej;
  const int pa = FO_EDGE, pb = ej;                // stage pitches
  const int a_floats = (kc * pa + 31) / 32 * 32;  // regions on 128 bytes
  const int stage_floats = a_floats + (kc * pb + 31) / 32 * 32;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  float* ring = smem + 32;
  float4* part = reinterpret_cast<float4*>(ring);
  const int rows = min(FO_EDGE, N - i0), cols = min(ej, NB - j0);
  const int tr = (rows + 7) / 8, tc = (cols + 7) / 8, tiles = tr * tc;
  int kg_n = 1;
  while (2 * kg_n <= FS_KG && 2 * kg_n * tiles <= FS_THREADS) kg_n *= 2;
  const int g = t / tiles, ti = t % tiles / tc, tj = t % tiles % tc;
  const int nch = (K + kc - 1) / kc;
  const bool all_tensor = mode_a == FS_TENSOR && mode_b == FS_TENSOR;
  const float* af = a + (long long)f * K * N;
  const float* bf = b + (long long)f * K * NB;
  auto bar = [&](int c) { return smem_addr(bars + c % stages); };
  auto rows_of = [&](int c) { return min(kc, K - c * kc); };
  auto bytes_of = [&](int c) {
    return fs_copy_bytes(mode_a, pa, kc) + fs_copy_bytes(mode_b, pb, kc);
  };
  // the copy-engine bytes of chunk c are announced before any of its copies is issued
  auto copy = [&](int c) {
    float* sa = ring + c % stages * stage_floats;
    fs_stage(mode_a, sa, pa, af, &a_map, f * K, N, i0, c * kc, rows_of(c), bar(c), t);
    fs_stage(mode_b, sa + a_floats, pb, bf, &b_map, f * K, NB, j0, c * kc, rows_of(c), bar(c), t);
    if (!all_tensor) cp_async_arrive(bar(c));
  };

  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_addr(bars + s), all_tensor ? 1 : FS_THREADS + 1);
    mbar_init_fence();
    for (int c = 0; c < min(nch, stages); ++c) mbar_arrive_expect_tx(bar(c), bytes_of(c));
  }
  __syncthreads();
  for (int c = 0; c < min(nch, stages); ++c) copy(c);

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  for (int c = 0; c < nch; ++c) {
    mbar_wait(bar(c), (c / stages) & 1);
    const float* sa = ring + c % stages * stage_floats + 4 * ti;
    const float* sb = ring + c % stages * stage_floats + a_floats + 4 * tj;
    const int live = rows_of(c);
    if (g < kg_n) {
#pragma unroll 2
      for (int kk = g; kk < live; kk += kg_n) {
        const float4 x0 = *reinterpret_cast<const float4*>(sa + kk * pa);
        const float4 x1 = *reinterpret_cast<const float4*>(sa + kk * pa + 4 * tr);
        const float4 y0 = *reinterpret_cast<const float4*>(sb + kk * pb);
        const float4 y1 = *reinterpret_cast<const float4*>(sb + kk * pb + 4 * tc);
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
      }
    }
    if (c + stages < nch) {  // refill stage c % stages once every thread is done with it
      if (t == 0) mbar_arrive_expect_tx(bar(c + stages), bytes_of(c + stages));
      __syncthreads();
      copy(c + stages);
    }
  }
  __syncthreads();  // every thread is done with the ring

  // group g's tile goes to slab g (row-major, 2 tc float4s a row of G)
  const int w = 2 * tc, q_n = 16 * tiles;
  if (g < kg_n) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i < 4 ? 4 * ti + i : 4 * tr + 4 * ti + i - 4;
      part[g * q_n + row * w + tj] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      part[g * q_n + row * w + tc + tj] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  for (int q = t; q < q_n; q += FS_THREADS) {
    const int i = q / w, col = 4 * (q % w);
    if (i >= rows) continue;
    float4 v = part[q];
    for (int h = 1; h < kg_n; ++h) {
      const float4 u = part[h * q_n + q];
      v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
    }
    float* o = out + ((long long)f * N + i0 + i) * NB + j0 + col;
    if (out_vec && col + 4 <= cols) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && col + j < cols; ++j) o[j] = vs[j];
    }
  }
}

// the driver's tensor-map encoder, asked of the runtime once (no link to
// the driver library); null where the driver lacks it
using fs_encode_fn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
fs_encode_fn fs_encode() {
  static const fs_encode_fn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<fs_encode_fn>(p);
  }();
  return fn;
}

cudaError_t run_freq_outer_staged(const float* a, const float* b, float* out, int F, int K, int N, int NB,
                                  cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(freq_outer_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FS_SMEM_MAX);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  // 64 columns a block, or 32 where 64 would leave most SMs idle
  const long long row_tiles = (long long)F * ((N + FO_EDGE - 1) / FO_EDGE);
  const int ej = row_tiles * ((NB + FO_EDGE - 1) / FO_EDGE) * 4 < 3LL * sm_count(dev) ? FO_EDGE / 2 : FO_EDGE;
  const int pa = FO_EDGE, pb = ej;
  // all of K in flight where FS_STAGES stages of it fit, else a ring of
  // FS_STAGES stages of kc rows (kc % 4 == 0 keeps the stages on 16 bytes)
  const int kc_max = (FS_STAGE_FLOATS - 64) / (pa + pb) / 4 * 4;  // each region rounded up to 32 floats
  const int kc = std::max(4, std::min(kc_max, (K + FS_STAGES - 1) / FS_STAGES + 3) / 4 * 4);
  const int stages = std::max(1, std::min(FS_STAGES, (K + kc - 1) / kc));
  const int tiles = FO_EDGE / 8 * (ej / 8);
  const int part = std::min(FS_KG * tiles, FS_THREADS) * 64;
  const int ring = stages * ((kc * pa + 31) / 32 * 32 + (kc * pb + 31) / 32 * 32);
  const int smem = 128 + std::max(ring, part) * 4;
  // a block's columns: one tensor copy, where
  // rows are 16-byte multiples on an aligned base; otherwise 4-byte pieces
  CUtensorMap maps[2] = {};
  bool encoded = true;
  auto mode = [&](int which, const float* x, int C, int e) {
    if (C % 4 != 0 || !aligned(x, 16)) return FS_PIECES;
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)F * K};
    const cuuint64_t stride[1] = {(cuuint64_t)C * 4};
    const cuuint32_t box[2] = {(cuuint32_t)e, (cuuint32_t)kc};
    const cuuint32_t elem[2] = {1, 1};
    encoded = encoded && fs_encode() &&
              fs_encode()(&maps[which], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, stride, box,
                          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    return FS_TENSOR;
  };
  const int mode_a = mode(0, a, N, pa), mode_b = mode(1, b, NB, pb);
  if (!encoded) return cudaErrorNotSupported;  // no tensor map: the wrapper raises
  const dim3 grid((NB + ej - 1) / ej, (N + FO_EDGE - 1) / FO_EDGE, F);
  const int out_vec = NB % 4 == 0 && aligned(out, 16);
  freq_outer_staged_kernel<<<grid, FS_THREADS, smem, stream>>>(a, b, out, K, N, NB, ej, kc, stages, mode_a, mode_b,
                                                               out_vec, maps[0], maps[1]);
  return cudaGetLastError();
}

template <bool VA, bool VB>
cudaError_t run_freq_outer(const float* a, const float* b, float* out, int F, int K, int N, int NB, int ei, int ej,
                           cudaStream_t stream) {
  const dim3 grid((NB + ej - 1) / ej, (N + ei - 1) / ei, F);
  const int out_vec = NB % 4 == 0 && ej % 4 == 0 && aligned(out, 16);
  freq_outer_kernel<VA, VB><<<grid, FO_THREADS, 0, stream>>>(a, b, out, K, N, NB, ei, ej, out_vec);
  return cudaGetLastError();
}

constexpr int FM_THREADS = 128;   // freq_mat: threads a block aims at, row slots x column lanes
constexpr int FM_MAX_ROWS = 128;  // rows of a[f] (and y[f]) a block owns at most
constexpr int FM_CS = 64;         // contraction depth staged at once
constexpr int FM_NT = 64;         // output columns a block owns at most (16 chunks of 4)
constexpr int FM_TR = 4;          // rows a thread owns where N2 <= 28
constexpr int FM_TR_WIDE = 4;     // ... and where N2 > 28, with 2 chunks of 4 columns
constexpr int FM_U_WIDE = 2;
// shared memory: a barrier, the a tile (rows at pitch FM_CS + 4), the m slab
constexpr int FM_SMEM_MAX = (4 + FM_MAX_ROWS * (FM_CS + 4) + FM_CS * FM_NT) * 4;

// y[f, k, j] = sum_c a[f, k, c] * m[f, c, j];  a: (F, K, N), m: (F, N, N2).
// Block (x, f, z) owns rows [x rb, x rb + rb) of y[f] and its columns
// [64 z, 64 z + 64): one wave of small blocks, all their loads in flight at
// once.  Where one slice holds the contraction (N <= FM_CS), the tile holds
// all N2 columns and every operand sits on 16 bytes (the main path's
// shapes), the block's rows of a (rb N contiguous floats) and m[f] (N N2)
// arrive by one bulk copy each, at pitch N and N2.  Otherwise, per
// contraction slice of up to FM_CS, every thread issues cp.async pieces of
// the a rows (pitch depth + 4) and of the m slab (pitch 4 x lanes x U), zeros
// outside the operands; one wait and one barrier.  Thread t is column lane
// t % lanes (chunks of 4 columns lane + lanes u, u < U) of rows t / lanes +
// slots i, i < TR: a TR x 4U register tile fed by 16-byte shared reads,
// FMAs in c order.  VEC (N, N2 % 4 == 0, every operand on 16 bytes): 16-byte
// pieces and stores; the scalar twin: 4-byte pieces and stores.
template <bool VEC, int TR, int U>
__global__ void __launch_bounds__(FM_THREADS) freq_mat_kernel(
    const float* __restrict__ a, const float* __restrict__ m, float* __restrict__ y, int K, int N, int N2, int rb) {
  extern __shared__ float4 fm_smem4[];
  float* smem = reinterpret_cast<float*>(fm_smem4);
  constexpr int W = VEC ? 4 : 1;
  const int f = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rb;
  const int j0 = blockIdx.z * FM_NT;
  const int cols = min(FM_NT, N2 - j0);
  const int lanes = ((cols + 3) / 4 + U - 1) / U;
  const int mp = 4 * lanes * U;  // pitch of the m slab
  const int slots = rb / TR;
  const bool bulk = VEC && N > 0 && N <= FM_CS && mp == N2;
  const int ap = bulk ? N : min(FM_CS, (N + 3) / 4 * 4) + 4;  // pitch of the a tile
  const unsigned bar = smem_addr(smem);
  float* sa = smem + 4;
  float* sm = sa + rb * ap;
  const int t = threadIdx.x;
  const int cl = t % lanes;
  const int slot = t / lanes;
  const float* af = a + (long long)f * K * N;
  const float* mf = m + (long long)f * N * N2;

  float acc[TR][U][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][u][j] = 0.f;

  auto consume = [&](int d4) {
    if (slot >= slots) return;
    for (int c4 = 0; c4 < d4 / 4; ++c4) {
      float4 av[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) av[i] = *reinterpret_cast<const float4*>(sa + (slot + slots * i) * ap + 4 * c4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 mv[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          mv[u] = *reinterpret_cast<const float4*>(sm + (4 * c4 + kk) * mp + 4 * (cl + lanes * u));
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            acc[i][u][0] = fmaf(x, mv[u].x, acc[i][u][0]);
            acc[i][u][1] = fmaf(x, mv[u].y, acc[i][u][1]);
            acc[i][u][2] = fmaf(x, mv[u].z, acc[i][u][2]);
            acc[i][u][3] = fmaf(x, mv[u].w, acc[i][u][3]);
          }
        }
      }
    }
  };

  if (bulk) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
      const unsigned bytes_a = (unsigned)(min((long long)rb, K - r0) * N * 4);
      const unsigned bytes_m = (unsigned)(N * N2 * 4);
      mbar_arrive_expect_tx(bar, bytes_a + bytes_m);
      bulk_copy(smem_addr(sa), af + r0 * N, bytes_a, bar);
      bulk_copy(smem_addr(sm), mf, bytes_m, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    mbar_wait(bar, 0);
    consume(N);
  } else {
    for (int c0 = 0; c0 < N; c0 += FM_CS) {
      const int d4 = (min(FM_CS, N - c0) + 3) / 4 * 4;
      stage_rows<W>(sa, ap, af, N, r0, c0, rb, d4, K, N, t, blockDim.x);
      stage_rows<W>(sm, mp, mf, N2, c0, j0, d4, mp, N, N2, t, blockDim.x);
      cp_async_wait_all();
      __syncthreads();
      consume(d4);
      __syncthreads();
    }
  }
  if (slot >= slots) return;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const long long row = r0 + slot + slots * i;
    if (row >= K) continue;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = 4 * (cl + lanes * u);
      if (col >= cols) continue;
      float* yr = y + ((long long)f * K + row) * N2 + j0 + col;
      if (VEC) {
        *reinterpret_cast<float4*>(yr) = make_float4(acc[i][u][0], acc[i][u][1], acc[i][u][2], acc[i][u][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < cols) yr[j] = acc[i][u][j];
      }
    }
  }
}

template <bool VEC, int TR, int U>
cudaError_t run_freq_mat(const float* a, const float* m, float* y, int F, int K, int N, int N2,
                         cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(freq_mat_kernel<VEC, TR, U>, cudaFuncAttributeMaxDynamicSharedMemorySize, FM_SMEM_MAX);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const int lanes = ((std::min(N2, FM_NT) + 3) / 4 + U - 1) / U;
  // row slots: FM_THREADS threads a block, at most FM_MAX_ROWS rows, no
  // more slots than K's rows need
  int slots = std::max(1, std::min(FM_THREADS / lanes, FM_MAX_ROWS / TR));
  slots = std::min(slots, (K + TR - 1) / TR);
  const int rb = slots * TR;
  const int depth = std::min(FM_CS, (N + 3) / 4 * 4);
  const int smem = (4 + rb * (depth + 4) + depth * 4 * lanes * U) * 4;
  const dim3 grid((K + rb - 1) / rb, F, (N2 + FM_NT - 1) / FM_NT);
  freq_mat_kernel<VEC, TR, U><<<grid, slots * lanes, smem, stream>>>(a, m, y, K, N, N2, rb);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t run_freq_mat_tile(const float* a, const float* m, float* y, int F, int K, int N, int N2,
                              cudaStream_t stream) {
  if (N2 > 28) return run_freq_mat<VEC, FM_TR_WIDE, FM_U_WIDE>(a, m, y, F, K, N, N2, stream);
  return run_freq_mat<VEC, FM_TR, 1>(a, m, y, F, K, N, N2, stream);
}

}  // namespace

extern "C" {

int grouped_sumvec_pmatmul(const float* a, const float* b, float* c, int M, int K, int N,
                           cudaStream_t stream) {
  // shared reads: A at pitch K where its panel stays resident, else PM_AP;
  // B at pitch N where N <= PM_BN, else PM_BN
  const int ar = resident_a(K) ? width(K) : 4;
  const int br = N <= PM_BN ? width(N) : 4;
  cudaError_t err;
  if (ar == 4) {
    err = run_pmatmul_b<4>(br, a, b, c, M, K, N, stream);
  } else if (ar == 2) {
    err = run_pmatmul_b<2>(br, a, b, c, M, K, N, stream);
  } else {
    err = run_pmatmul_b<1>(br, a, b, c, M, K, N, stream);
  }
  return (int)err;
}

int grouped_sumvec_freq_outer(const float* a, const float* b, float* out, int F, int K, int N,
                              int NB, cudaStream_t stream) {
  // K = 0 takes the register-fed kernel, which writes zeros (a tensor map
  // cannot span zero rows)
  if (N >= FO_EDGE && NB >= FO_EDGE && K > 0) return (int)run_freq_outer_staged(a, b, out, F, K, N, NB, stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the tile: halve its longer edge (rows first) while it holds more 4 x 4
  // register tiles than a block has threads, or while the grid has fewer
  // blocks than SMs and an edge is longer than FO_MIN_EDGE
  int ei = std::min(N, FO_EDGE), ej = std::min(NB, FO_EDGE);
  auto blocks = [&] { return (long long)F * ((N + ei - 1) / ei) * ((NB + ej - 1) / ej); };
  auto tiles = [&] { return (ei + 3) / 4 * ((ej + 3) / 4); };
  while (tiles() > FO_THREADS || (blocks() < sm_count(dev) && std::max(ei, ej) > FO_MIN_EDGE)) {
    if (ei >= ej) ei = (ei + 1) / 2;
    else ej = (ej + 1) / 2;
  }
  // 16-byte loads of an operand where every piece a thread reads starts on
  // 16 bytes: rows of a multiple of 4 floats, an aligned base, tile edges
  // of a multiple of 4
  const bool va = N % 4 == 0 && ei % 4 == 0 && aligned(a, 16);
  const bool vb = NB % 4 == 0 && ej % 4 == 0 && aligned(b, 16);
  if (va && vb) err = run_freq_outer<true, true>(a, b, out, F, K, N, NB, ei, ej, stream);
  else if (va) err = run_freq_outer<true, false>(a, b, out, F, K, N, NB, ei, ej, stream);
  else if (vb) err = run_freq_outer<false, true>(a, b, out, F, K, N, NB, ei, ej, stream);
  else err = run_freq_outer<false, false>(a, b, out, F, K, N, NB, ei, ej, stream);
  return (int)err;
}

int grouped_sumvec_freq_mat(const float* a, const float* m, float* y, int F, int K, int N, int N2,
                            cudaStream_t stream) {
  // 16-byte pieces and stores where every row of every operand starts on 16
  // bytes; 4-byte ones otherwise (N or N2 % 4 != 0, or a view at an offset)
  const bool vec = N % 4 == 0 && N2 % 4 == 0 && aligned(a, 16) && aligned(m, 16) && aligned(y, 16);
  return (int)(vec ? run_freq_mat_tile<true>(a, m, y, F, K, N, N2, stream)
                   : run_freq_mat_tile<false>(a, m, y, F, K, N, N2, stream));
}

const char* grouped_sumvec_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
