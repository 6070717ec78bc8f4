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
// Design.  cmatmul (redesigned): on the TPU the K grid axis carried the sum
// in the resident output block; here a block owns a strip of rows and all
// columns of a tile of up to 128 (N = 32 .. 128: every plan of the repo in
// one tile), so B's two planes stay resident in shared memory, brought once
// by the copy engine (one bulk copy a plane), and each strip of A arrives
// the same way into a 2-stage mbarrier ring filled by a producer warp.  The
// consumers are two groups of four warps, one a K half: a thread holds a
// 4 x 4 register tile of both planes (4 columns where the tile is narrow) and
// the two halves' sums are added in a fixed order at the strip's end, each
// group adding and storing half the tile.  What holds it on this card:
// a 16-byte shared read costs a warp four wavefronts whatever lanes share an
// address, so a 4 x 4 complex tile reads one float from shared memory per 4
// FMAs and the shared-memory pipe runs as busy as the FMA pipe; larger tiles
// cost registers and so warps (8 x 4 and 4 x 8 tiles, four K parts and
// 1-row strips all ran slower on an NVIDIA H100 80GB HBM3; PERF.md).
// Where the tile would leave SMs idle (the inverse's M = 32 .. 68, the LM
// probe's M = 384) narrow tiles of at most 64 columns, one chunk and one row
// a thread and strips as short as give every SM a block take over.  Where
// B and a ring of whole strips do not fit (K past ~200 at N = 128) the ring
// carries 32-deep K slices of A and B instead.  A null Ai folds the real
// input case (four-step stage 1) into half the FMAs, and a null Ci (the vjp
// of that stage needs Re dA = Re(g B^H) only) halves them again.  Ragged
// edges are zero filled in shared memory and masked at the store; operands
// off a 16-byte boundary or with K % 4 != 0 go by cp.async pieces instead
// of bulk copies, and N % 4 != 0 or an odd C by 4-byte stores.
// ctwiddle (redesigned): a 2-D grid of (column chunk, row group); a thread
// owns one float4 of columns (16-byte loads and stores) and 4 rows, loads its
// float4 of w once for all of them and issues all 8 row loads before any
// store; 32-bit offsets unless n d >= 2^31.  A scalar twin (one float a
// thread) takes d % 4 != 0 (the padded plan's dp = 121) and any operand not
// on a 16-byte boundary; the entry picks it from the sizes and pointers.
// The vjps (kernel.py) are these kernels on conjugated operands:
// dA = cmatmul(g, B^H), dx = ctwiddle(g, conj w).  Plain f32 FMA, no
// tensor cores.
//
// C interface: pointers to contiguous float32 device buffers, sizes as int,
// the CUDA stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "sm90_async.cuh"

namespace {

using namespace sm90;

constexpr int CM_GROUP = 128;                   // consumer threads that share a K half
constexpr int CM_KH = 2;                        // K halves: two consumer groups a strip
constexpr int CM_CONSUMERS = CM_GROUP * CM_KH;
static_assert(CM_KH == 2, "the epilogue trades halves of the tile between two groups");
constexpr int CM_CW = CM_CONSUMERS / 32;        // consumer warps
constexpr int CM_THREADS = CM_CONSUMERS + 32;   // + one producer warp
constexpr int CM_STAGES = 2;                    // ring stages of A strips (or K slices)
constexpr int CM_KC = 32;                       // K depth of a stage where B cannot stay resident
constexpr int CM_SMEM_MAX = 227 * 1024;
constexpr int CM_TM = 4;                        // strip rows a thread owns (wide tiles)
constexpr int CM_CL = 16;                       // column lanes a wide tile aims at
constexpr int CM_CL_NARROW = 16;                // ... and a narrow one
constexpr int CM_WIDE = 32;                     // chunks of 4 columns a wide tile holds at most
static_assert((CM_WIDE + CM_CL - 1) / CM_CL <= 2, "wide tiles own at most 2 chunks a thread");

// A block's geometry, fixed by the C entry from the sizes and pointers.
struct CmGeom {
  int cl;        // column lanes: a thread owns column chunks cl + CL u, u < U
  int rl;        // row lanes: a thread owns strip rows rl + RL i, i < TM
  int bm;        // rows of a strip (RL TM)
  int np;        // columns of the block's tile, B's in shared memory (4 CL U, zero padded)
  int kp;        // K rounded up to 4
  int kc;        // K depth of a stage: kp where B is resident, else CM_KC
  int ap;        // row pitch of an A stage (K for bulk strips, else kc + 4)
  int resident;  // B's two planes stay in shared memory for the whole block
  int bulk;      // A strips by bulk copies (resident, K % 4 == 0, A on 16 bytes)
  int bulk_b;    // B by one bulk copy a plane (resident, np == N, K % 4 == 0, B on 16 bytes)
  int wa, wb;    // piece width (floats) of A and B where copied by pieces
  int vstore;    // 16-byte stores (N % 4 == 0, C on 16 bytes)
  int nstrips;   // strips of bm rows
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void stage_rows_w(int w, float* s, int pitch, const float* g, long long ld, long long r0,
                                             int c0, int rows, int cols, long long R, int C, int tid, int nthreads) {
  if (w == 4) stage_rows<4>(s, pitch, g, ld, r0, c0, rows, cols, R, C, tid, nthreads);
  else stage_rows<1>(s, pitch, g, ld, r0, c0, rows, cols, R, C, tid, nthreads);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CM_CONSUMERS) : "memory");
}

// C = A @ B on re/im planes: A (M, K), B (K, N), C (M, N), row-major f32;
// HAS_AI false: A real; HAS_CI false: Re C only.  Block (x, y) owns the
// column tile [np y, np y + np) and strips x, x + gridDim.x, ... of bm rows
// (persistent: as many blocks as fit on the SMs at once).  Warp specialised:
//   * one producer warp brings B's tile by one bulk copy a plane where it is
//     B's contiguous whole (else the consumers copy it, zeros past K and N)
//     and fills a ring of CM_STAGES stages.  Where B stays resident a stage
//     is a whole strip of A, one bulk copy a plane where A's rows are
//     16-byte aligned (rows * K contiguous floats), else cp.async pieces at
//     pitch kp + 4 with zeros past K; otherwise a stage is a CM_KC-deep K
//     slice of the strip and of B, by pieces.
//   * two groups of four consumer warps: group h takes the h-th half of
//     every stage's k.  Thread (rl, cl) of a group holds a TM x 4U register
//     tile of both planes (rows rl + RL i, column chunks cl + CL u), fed by
//     16-byte shared reads (one of A a row and plane per 4 k, one of B a
//     chunk and plane per k), and adds in k order; at the strip's end the
//     groups trade halves of the tile, each adding group 0's sum and group
//     1's for its half.  So every output is two f32 FMA chains (re: +ar br,
//     -ai bi; im: +ar bi, +ai br) and one add, always in that order:
//     deterministic, no atomics.  16-byte stores straight from the registers.
// Two blocks an SM where a thread owns one chunk of columns.
template <int TM, int U, bool HAS_AI, bool HAS_CI>
__global__ void __launch_bounds__(CM_THREADS, U == 1 ? 2 : 1) cmatmul_kernel(
    const float* __restrict__ ar, const float* __restrict__ ai, const float* __restrict__ br,
    const float* __restrict__ bi, float* __restrict__ cr, float* __restrict__ ci, int M, int K, int N, CmGeom g) {
  extern __shared__ float4 cm_smem4[];
  float* smem = reinterpret_cast<float*>(cm_smem4);
  constexpr int PA = HAS_AI ? 2 : 1;                // planes of A
  constexpr int PC = HAS_CI ? 2 : 1;                // planes of C
  constexpr int RED = TM * U * 4 * PC;              // a thread's sums, the most it hands over
  const int n0 = blockIdx.y * g.np;
  const int a_plane = g.bm * g.ap;
  const int b_plane = g.resident ? g.kp * g.np : g.kc * g.np;
  float* bres = smem;
  float* ring = smem + (g.resident ? 2 * b_plane : 0);
  const int stage_floats = PA * a_plane + (g.resident ? 0 : 2 * b_plane);
  float* red = ring + CM_STAGES * stage_floats;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(red + RED * CM_GROUP);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = g.resident ? 1 : (K + g.kc - 1) / g.kc;
  auto full_bar = [&](int s) { return smem_addr(bars + s); };
  auto empty_bar = [&](int s) { return smem_addr(bars + CM_STAGES + s); };
  const unsigned b_bar = smem_addr(bars + 2 * CM_STAGES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < CM_STAGES; ++s) {
      mbar_init(full_bar(s), 33);
      mbar_init(empty_bar(s), CM_CW);
    }
    mbar_init(b_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CM_CW) {  // the producer
    if (g.bulk_b && lane == 0) {
      const unsigned bytes = (unsigned)K * N * 4;
      mbar_arrive_expect_tx(b_bar, 2 * bytes);
      bulk_copy(smem_addr(bres), br, bytes, b_bar);
      bulk_copy(smem_addr(bres + b_plane), bi, bytes, b_bar);
    }
    int it = 0;
    for (int s = blockIdx.x; s < g.nstrips; s += gridDim.x) {
      const long long m0 = (long long)s * g.bm;
      const int rows = (int)min((long long)g.bm, M - m0);
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int st = it % CM_STAGES;
        mbar_wait(empty_bar(st), ((it / CM_STAGES) & 1) ^ 1);
        float* sa = ring + st * stage_floats;
        const int k0 = kc * g.kc;
        if (g.bulk) {
          const unsigned bytes = (unsigned)rows * K * 4;
          if (lane == 0) {
            mbar_arrive_expect_tx(full_bar(st), PA * bytes);
            bulk_copy(smem_addr(sa), ar + m0 * K, bytes, full_bar(st));
            if (HAS_AI) bulk_copy(smem_addr(sa + a_plane), ai + m0 * K, bytes, full_bar(st));
          }
        } else {
          if (lane == 0) mbar_arrive_expect_tx(full_bar(st), 0);
          stage_rows_w(g.wa, sa, g.ap, ar, K, m0, k0, g.bm, g.kc, M, K, lane, 32);
          if (HAS_AI) stage_rows_w(g.wa, sa + a_plane, g.ap, ai, K, m0, k0, g.bm, g.kc, M, K, lane, 32);
          if (!g.resident) {
            float* sb = sa + PA * a_plane;
            stage_rows_w(g.wb, sb, g.np, br, N, k0, n0, g.kc, g.np, K, N, lane, 32);
            stage_rows_w(g.wb, sb + b_plane, g.np, bi, N, k0, n0, g.kc, g.np, K, N, lane, 32);
          }
        }
        cp_async_arrive(full_bar(st));
      }
    }
    cp_async_wait_all();
    return;
  }

  // the consumers
  const int t = threadIdx.x;
  if (g.bulk_b) {
    mbar_wait(b_bar, 0);
  } else if (g.resident) {
    stage_rows_w(g.wb, bres, g.np, br, N, 0, n0, g.kp, g.np, K, N, t, CM_CONSUMERS);
    stage_rows_w(g.wb, bres + b_plane, g.np, bi, N, 0, n0, g.kp, g.np, K, N, t, CM_CONSUMERS);
    cp_async_wait_all();
    consumers_sync();
  }
  const int h = t / CM_GROUP;
  const int tg = t % CM_GROUP;
  const int cl = tg % g.cl;
  const int rlane = tg / g.cl;
  const bool active = rlane < g.rl;
  int it = 0;
  for (int s = blockIdx.x; s < g.nstrips; s += gridDim.x) {
    float accr[TM][U][4], acci[TM][U][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accr[i][u][j] = 0.f;
          acci[i][u][j] = 0.f;
        }
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int st = it % CM_STAGES;
      mbar_wait(full_bar(st), (it / CM_STAGES) & 1);
      const float* sa = ring + st * stage_floats;
      const float* sbr = g.resident ? bres : sa + PA * a_plane;
      const int depth = g.resident ? g.kp : min(g.kc, (K - kc * g.kc + 3) / 4 * 4);
      const int half = (depth / 4 + 1) / 2;
      const int k4_end = h == 0 ? half : depth / 4;
      if (active) {
        const float* pa = sa + rlane * g.ap;
        const float* pb = 4 * cl + sbr;
#pragma unroll 2
        for (int k4 = h * half; k4 < k4_end; ++k4) {
          float4 xr[TM], xi[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            xr[i] = *reinterpret_cast<const float4*>(pa + i * g.rl * g.ap + 4 * k4);
            if (HAS_AI) xi[i] = *reinterpret_cast<const float4*>(pa + a_plane + i * g.rl * g.ap + 4 * k4);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float4 yr[U], yi[U];
            const float* row = pb + (4 * k4 + kk) * g.np;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              yr[u] = *reinterpret_cast<const float4*>(row + 4 * g.cl * u);
              yi[u] = *reinterpret_cast<const float4*>(row + b_plane + 4 * g.cl * u);
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float a_r = lane_of(xr[i], kk);
              const float a_i = HAS_AI ? lane_of(xi[i], kk) : 0.f;
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const float b_r[4] = {yr[u].x, yr[u].y, yr[u].z, yr[u].w};
                const float b_i[4] = {yi[u].x, yi[u].y, yi[u].z, yi[u].w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  accr[i][u][j] = fmaf(a_r, b_r[j], accr[i][u][j]);
                  if (HAS_AI) accr[i][u][j] = fmaf(-a_i, b_i[j], accr[i][u][j]);
                  if (HAS_CI) {
                    acci[i][u][j] = fmaf(a_r, b_i[j], acci[i][u][j]);
                    if (HAS_AI) acci[i][u][j] = fmaf(a_i, b_r[j], acci[i][u][j]);
                  }
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
    }
    // the two groups trade halves of the tile: chunk c (row i, chunk u;
    // c = i U + u) is added and stored by group c % 2 (by group 0 when the
    // tile is one chunk)
    constexpr int NCH = TM * U;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = i * U + u;
        if ((NCH >= 2 ? c % 2 : 0) == h) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          red[(c * 4 + j) * CM_GROUP + tg] = accr[i][u][j];
          if (HAS_CI) red[(NCH * 4 + c * 4 + j) * CM_GROUP + tg] = acci[i][u][j];
        }
      }
    consumers_sync();
    if (active) {
      const long long m0 = (long long)s * g.bm;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long row = m0 + rlane + g.rl * i;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = i * U + u;
          if ((NCH >= 2 ? c % 2 : 0) != h) continue;
          // group 0's sum first; a + b == b + a in IEEE f32, so either group
          // adds the same bits
          float vr[4], vi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            vr[j] = accr[i][u][j] + red[(c * 4 + j) * CM_GROUP + tg];
            vi[j] = HAS_CI ? acci[i][u][j] + red[(NCH * 4 + c * 4 + j) * CM_GROUP + tg] : 0.f;
          }
          const int col = n0 + 4 * (cl + g.cl * u);
          if (row >= M || col >= N) continue;
          float* pr = cr + row * N + col;
          float* pi = HAS_CI ? ci + row * N + col : nullptr;
          if (g.vstore) {
            *reinterpret_cast<float4*>(pr) = make_float4(vr[0], vr[1], vr[2], vr[3]);
            if (HAS_CI) *reinterpret_cast<float4*>(pi) = make_float4(vi[0], vi[1], vi[2], vi[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (col + j >= N) break;
              pr[j] = vr[j];
              if (HAS_CI) pi[j] = vi[j];
            }
          }
        }
      }
    }
    consumers_sync();  // the sums are read before the next strip's overwrite them
  }
}

template <int TM, int U, bool HAS_AI, bool HAS_CI>
cudaError_t run_cmatmul(const float* ar, const float* ai, const float* br, const float* bi, float* cr, float* ci,
                        int M, int K, int N, const CmGeom& g, int smem, int tiles, int dev, cudaStream_t stream) {
  auto kernel = cmatmul_kernel<TM, U, HAS_AI, HAS_CI>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device; blocks an SM at the last shared-memory size asked for, cached
  static std::atomic<unsigned long long> configured{0};
  static std::atomic<long long> occupancy{0};  // (smem << 8) | blocks per SM
  const unsigned long long bit = 1ULL << (dev & 63);
  cudaError_t err;
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CM_SMEM_MAX);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  long long occ = occupancy.load();
  if ((occ >> 8) != smem) {
    int per_sm = 1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CM_THREADS, smem);
    if (err != cudaSuccess) return err;
    occ = ((long long)smem << 8) | (per_sm > 0 ? std::min(per_sm, 255) : 1);
    occupancy.store(occ);
  }
  // persistent: the strips of a column tile over the blocks that fit at once
  const int per_tile = std::max(1, (int)(occ & 255) * sm_count(dev) / tiles);
  const dim3 grid(std::min(g.nstrips, per_tile), tiles);
  kernel<<<grid, CM_THREADS, smem, stream>>>(ar, ai, br, bi, cr, ci, M, K, N, g);
  return cudaGetLastError();
}

// the register tile: TM rows x U chunks of 4 columns a thread
template <int TM, int U>
cudaError_t run_cmatmul_tile(const float* ar, const float* ai, const float* br, const float* bi, float* cr,
                             float* ci, int M, int K, int N, const CmGeom& g, int smem, int tiles, int dev,
                             cudaStream_t stream) {
  if (ai != nullptr && ci != nullptr)
    return run_cmatmul<TM, U, true, true>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
  if (ai != nullptr) return run_cmatmul<TM, U, true, false>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
  if (ci != nullptr) return run_cmatmul<TM, U, false, true>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
  return run_cmatmul<TM, U, false, false>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
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

}  // namespace

extern "C" {

int sumvec_fft_cmatmul(const float* ar, const float* ai, const float* br, const float* bi,
                       float* cr, float* ci, int M, int K, int N, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // Wide tiles: up to CM_WIDE chunks of 4 columns over at most CM_CL column
  // lanes, U chunks and CM_TM rows a thread (N = 128: 16 lanes x 2 chunks,
  // 64: 16 x 1, 48: 12 x 1, 32: 8 x 1); row lanes fill a group of
  // CM_GROUP threads.  Where that leaves fewer blocks than SMs (the
  // inverse's M = 32 .. 68, the LM probe's M = 384): narrow tiles of at most
  // CM_CL_NARROW chunks, one chunk and one row a thread, and strips as
  // short as give every SM a block.
  CmGeom g;
  const int nc = (N + 3) / 4;
  int tiles = (nc + CM_WIDE - 1) / CM_WIDE;
  const int ncw = (nc + tiles - 1) / tiles;
  int u = (ncw + CM_CL - 1) / CM_CL;
  int tm = CM_TM;
  g.cl = (ncw + u - 1) / u;
  g.rl = CM_GROUP / g.cl;
  const int sms = sm_count(dev);
  if ((long long)(M + g.rl * tm - 1) / (g.rl * tm) * tiles < sms) {
    tiles = (nc + CM_CL_NARROW - 1) / CM_CL_NARROW;
    g.cl = (nc + tiles - 1) / tiles;
    // as few row lanes as give a block to every SM (idle lanes past them)
    const int per_tile = (sms + tiles - 1) / tiles;
    g.rl = std::max(1, std::min(CM_GROUP / g.cl, (M + per_tile - 1) / per_tile));
    u = 1;
    tm = 1;
  }
  g.bm = g.rl * tm;
  g.np = 4 * g.cl * u;
  g.kp = (K + 3) / 4 * 4;
  g.nstrips = (M + g.bm - 1) / g.bm;
  const bool a16 = aligned(ar, 16) && (ai == nullptr || aligned(ai, 16));
  const bool b16 = N % 4 == 0 && aligned(br, 16) && aligned(bi, 16);
  g.wa = K % 4 == 0 && a16 ? 4 : 1;
  g.wb = b16 ? 4 : 1;
  g.vstore = N % 4 == 0 && aligned(cr, 16) && (ci == nullptr || aligned(ci, 16));
  const int pa = ai != nullptr ? 2 : 1;
  // shared memory besides B and the ring: group 1's sums, the barriers
  const int extra = CM_GROUP * tm * u * 4 * (ci != nullptr ? 2 : 1) * 4 + (2 * CM_STAGES + 1) * 8;
  // B resident where its tile and a ring of whole strips fit
  g.bulk = K > 0 && g.wa == 4;
  g.ap = g.bulk ? K : g.kp + 4;
  int smem = (2 * g.kp * g.np + CM_STAGES * pa * g.bm * g.ap) * 4 + extra;
  g.resident = smem <= CM_SMEM_MAX;
  g.bulk_b = g.resident && K > 0 && K % 4 == 0 && b16 && g.np == N;
  g.kc = g.kp;
  if (!g.resident) {
    g.bulk = 0;
    g.kc = CM_KC;
    g.ap = CM_KC + 4;
    smem = CM_STAGES * (pa * g.bm * g.ap + 2 * CM_KC * g.np) * 4 + extra;
  }
  if (tm == 1) {
    err = run_cmatmul_tile<1, 1>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
  } else if (u == 1) {
    err = run_cmatmul_tile<CM_TM, 1>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
  } else {
    err = run_cmatmul_tile<CM_TM, 2>(ar, ai, br, bi, cr, ci, M, K, N, g, smem, tiles, dev, stream);
  }
  return (int)err;
}

int sumvec_fft_ctwiddle(const float* xr, const float* xi, const float* wr, const float* wi,
                        float* yr, float* yi, int n, int d, cudaStream_t stream) {
  // float4 where every row of every plane starts on 16 bytes; one float a
  // thread otherwise (d % 4 != 0, e.g. the padded plan's dp = 121, or a
  // contiguous view at an odd offset)
  const bool vec = d % 4 == 0 && aligned(xr, 16) && aligned(xi, 16) && aligned(wr, 16) && aligned(wi, 16) &&
                   aligned(yr, 16) && aligned(yi, 16);
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
