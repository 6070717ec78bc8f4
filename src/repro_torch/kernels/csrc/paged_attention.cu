// Paged decode attention: one decode step of GQA attention over block-table
// pages of a KV pool, with the logit softcap, the sliding window and the
// per-slot lengths mask, softmax accumulated online in IEEE f32.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention/kernel.py:
//   paged_attention <- paged_decode_kernel_call / _paged_decode_kernel
// No backward: inference only, as in the reference.
//
//   q       (B, H, hd) f32, H = KV * n_rep (query head h reads kv head h / n_rep)
//   k, v    (P, page, KV, hd) pages, f32 or bf16 (upcast per element on load)
//   tables  (B, NB) int32: logical block j of slot b -> physical page
//   lens    (B,) int32: valid rows per slot, global (see start)
//   start   int >= 0: the global row of a table's row 0.  0 for a whole cache
//           (then 1 <= len <= NB * page); a rank's block of a cache split by
//           sequence (rows [start, start + NB * page) of each slot) passes its
//           first row, and lens stay the slots' global lengths
//   out     (B, H, hd) f32
//   lse     (B, H) f32 or NULL: the log-sum-exp of the live rows' s
// Global row pos = start + t of slot b is live when pos < len and, with
// window > 0, pos >= len - window (and the table holds it: t < NB * page);
//   s = scale * q.k;  s = softcap * tanh(s / softcap) when softcap > 0;
//   out = sum_t softmax(s)_t v_t;  lse = log sum_t e^(s_t).
// A slot with no live row in the table gives out 0 and lse -inf, so the
// blocks of a split cache merge exactly (out = sum_k e^(lse_k - M) out_k /
// sum_k e^(lse_k - M), M = max lse_k; parallel/fsdp_tp.merge_partials).
//
// Bound on an H100: bytes = sum_b rows_b * KV * hd * 2 * sizeof(page dtype)
// (k and v of the live rows, rows_b = min(len_b, window) or len_b, cut to
// the table's rows) plus q, out and lse; operations = 4 * sum_b rows_b * H
// * hd.  Two FLOP per byte of bf16 cache at n_rep = 2: bound by bytes
// (3.35 TB/s), by ~100x.
//
// Design.  The TPU kernel walks a sequential (slot, block) grid with a
// scalar-prefetched block table and carries the online-softmax state in
// VMEM scratch across the block axis.  Hopper has neither the sequential
// grid nor scalar prefetch, so:
//   * the grid is (kv head g, slot b, split s): block s takes the live rows
//     [lo + s CH, min(lo + (s + 1) CH, hi)) of slot b (table rows: lo =
//     max(len - window - start, 0) or 0, hi = min(len - start, NB page)),
//     and holds the n_rep query rows of g (GQA needs no expansion of the
//     pool).  The split count S = ceil(min(NB page, window or NB page) / CH)
//     comes from host-known sizes only (the wrapper never reads the lengths),
//     so a long slot streams through S SMs instead of one; at the LM path's
//     main shape S = 1;
//   * its warps (16 where a thread's rows fit 128 registers, as gemma2's
//     n_rep = 2 at hd = 256 do; else 8) split the chunk's rows round-robin,
//     U rows per warp per loop trip; each lane holds VEC consecutive
//     elements of a head row (d = lane * VEC + i), read with 16-byte loads
//     when hd = 32 * VEC, so a warp reads a whole row (512 B of bf16 at
//     hd = 256) coalesced; a trip issues all its rows' k / v loads, then all
//     U x n_rep dot products and their warp sums interleaved, then ONE
//     online-softmax update per query row (running max m, normaliser l,
//     accumulator).  16 warps take the LM path's 44 rows in one trip.  A
//     row's page comes from its own block-table entry (tables[b, t / page]),
//     read through the read-only cache: staging a chunk's entries in shared
//     memory behind a block barrier, tried, cost the LM decode tick ~6 %;
//   * the warps' states are merged through shared memory, up to G query rows
//     at a time (all of gemma2's n_rep = 2), the weights e^(m_w - M) once per
//     (row, warp): M = max m_w, L = sum l_w e^(m_w - M), A = sum acc_w
//     e^(m_w - M), w in order.  With S = 1 the block writes
//     out = A / max(L, 1e-30); otherwise its partial state
//     (M, L, A) goes to the f32 scratch the wrapper allocates, and
//     paged_combine_kernel (same C entry; one output element a thread, the
//     partials' loads 8 splits at a time) merges the S partials of each
//     (slot, kv head) with the same formula, s in order: deterministic, no
//     atomics.  A chunk with no live row writes M = -1e30, L = 0, A = 0.
//     The LSE, where asked for, is M + log L of the final state: the
//     single split's (M, L) or the merged one, -inf where L = 0;
//   * a trip's rows past the chunk get the reference's -1e30 logit, whose
//     weight exp(-1e30 - m) is exactly 0.0, as is a neutral partial's: a
//     masked row carries exactly 0 probability mass (the paged == dense
//     bit-identity of the plain route rests on it).
// CH = 256: the design search (PERF.md) timed 128 and 512 too; 512 ran the
// 8192-row slots ~10 % faster and every slot of a few hundred rows ~1.6x
// slower.  At long context a warp's trip waits on its loads before it
// computes, so a block streams well below the card's rate (about a third of
// the bound); a ring of rows staged in shared memory is the next step.
// Any page size >= 1 works: rows are addressed one by one through
// tables[b, t / page] and t % page.  hd <= 256 (the wrapper checks); the
// register arrays are sized by the templates below for up to 8 query rows.
// A kv head with n_rep > 8 (nemotron-4-340b: 12) is split into NG groups of
// n_rep / NG <= 8 rows (NG the smallest divisor that fits), each a block of
// its own on the grid's x axis: the group reads its kv head's rows once
// more, and every other ratio of the port's archs (1 to 8) keeps NG = 1.
// A 16-row template instance, the other way, holds 2 x 16 x VEC registers
// of query rows and accumulators: 256 at hd = 192 (VEC = 8), past the 255 a
// thread may have, so it would spill.  No TPU
// tile padding (the reference's kv / n_rep / hd zero-pads to (8, 128) tiles).
// Pages must be 16-byte aligned (the wrapper checks).  Plain f32 FMA, no
// tensor cores.
//
// C interface: device pointers, sizes as int, scale and softcap as float,
// page dtype code (0 f32, 1 bf16), the CUDA stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int CH = 256;  // rows of a slot one block takes (kernel.py CHUNK)
constexpr float NEG_INF = -1e30f;

// the LSE of a state with no live row
__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }
// the LSE of a final state (m, l): m + log l, -inf where l = 0
__device__ __forceinline__ float state_lse(float m, float l) { return l > 0.f ? m + logf(l) : minus_inf(); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive elements of a head row from p (a lane's share), as f32.
// FULL (hd == 32 * VEC): 16-byte loads where VEC fills them; otherwise one
// element at a time, zero past hd.
template <typename T, int VEC, bool FULL>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int d0, int hd, float (&x)[VEC]) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
  if constexpr (FULL && VEC % PER == 0) {
#pragma unroll
    for (int c = 0; c < VEC / PER; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + d0) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) x[c * PER + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = (FULL || d0 + i < hd) ? to_f32(p[d0 + i]) : 0.f;
  }
}

// Offsets of one (slot, kv head, split)'s partial state in the scratch of
// B * KV * S * n_rep * (hd + 2) floats: the accumulators A (n_rep x hd),
// then, after all of them, (M, L) per query row.
__device__ __forceinline__ long long part_acc(long long bgs, int n_rep, int hd) { return bgs * n_rep * hd; }
__device__ __forceinline__ long long part_ml(long long bgs, long long all, int n_rep, int hd) {
  return all * n_rep * hd + bgs * n_rep * 2;
}

// VEC: elements of a head row per lane (hd <= 32 * VEC), lane l holding
// d = l * VEC + i; NREP: the largest n_rep this instance serves; U: rows per
// warp per loop trip; WARPS: warps a block; FULL: hd == 32 * VEC.
template <typename T, int VEC, int NREP, int U, int WARPS, bool FULL>
__global__ void __launch_bounds__(32 * WARPS) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ tables, const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ part, float* __restrict__ lse, int kv, int ng, int n_rep, int hd, int page, int nb,
    float scale, float softcap, int window, int start) {
  constexpr int TPB = 32 * WARPS;
  // query rows merged at a time (<= 32 KB of accumulators)
  constexpr int G = NREP < 256 / (WARPS * VEC) ? NREP : 256 / (WARPS * VEC);
  __shared__ float red_m[G][WARPS];
  __shared__ float red_l[G][WARPS];
  __shared__ float red_w[G][WARPS];
  __shared__ float red_big[G];
  __shared__ float red_acc[G][WARPS][32 * VEC];

  // g: a group of n_rep query rows of kv head g / ng; q, out and the
  // partials index by group (kvg = kv * ng groups of n_rep rows each)
  const int g = blockIdx.x;
  const int kvg = gridDim.x;
  const int b = blockIdx.y;  // slot
  const int s = blockIdx.z;  // split
  const int splits = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * VEC;
  const int h_all = kvg * n_rep;
  const int gk = g / ng;  // the kv head the pages hold
  const int* trow = tables + (long long)b * nb;

  // issued together: the length and the query rows
  const int len = __ldg(lens + b);
  float qv[NREP][VEC];
  float m[NREP], l[NREP], acc[NREP][VEC];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    const float* qr = q + ((long long)b * h_all + g * n_rep + r) * hd;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[r][i] = 0.f;
      qv[r][i] = (r < n_rep && d0 + i < hd) ? __ldg(qr + d0 + i) : 0.f;
    }
  }

  // the live rows of the table (rows of the block): [lo, hi)
  const int lo = window > 0 ? max(len - window - start, 0) : 0;
  const int hi = min(len - start, nb * page);
  const int r0 = lo + s * CH;
  const int r1 = min(r0 + CH, hi);
  const long long bgs = ((long long)b * kvg + g) * splits + s;
  if (r0 >= r1) {  // no live row (block-uniform): the neutral state
    for (int e = threadIdx.x; e < n_rep * hd; e += TPB) {
      if (splits == 1) {
        out[((long long)b * h_all + g * n_rep) * hd + e] = 0.f;
        if (lse != nullptr && e % hd == 0) lse[(long long)b * h_all + g * n_rep + e / hd] = minus_inf();
      } else {
        part[part_acc(bgs, n_rep, hd) + e] = 0.f;
        if (e % hd == 0) {
          const long long ml = part_ml(bgs, (long long)gridDim.y * kvg * splits, n_rep, hd) + 2 * (e / hd);
          part[ml] = NEG_INF;
          part[ml + 1] = 0.f;
        }
      }
    }
    return;
  }

  for (int t0 = r0 + warp * U; t0 < r1; t0 += WARPS * U) {
    // the trip's U rows: all loads first, then every dot product
    float kx[U][VEC], vx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < r1) {
        const long long phys = __ldg(trow + t / page);
        const long long base = ((phys * page + t % page) * kv + gk) * (long long)hd;
        load_row<T, VEC, FULL>(k_pages + base, d0, hd, kx[u]);
        load_row<T, VEC, FULL>(v_pages + base, d0, hd, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
    float sc[U][NREP];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[r][i], kx[u][i], dot);
        sc[u][r] = dot;
      }
    // U * NREP independent warp sums, interleaved
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < NREP; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
    // one online-softmax update per query row per trip; a row past the chunk
    // gets the reference's -1e30 logit, so its weight exp(-1e30 - m) is exactly 0
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (r >= n_rep) break;  // block-uniform
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = sc[u][r] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sc[u][r] = t0 + u < r1 ? x : NEG_INF;
        m_new = fmaxf(m_new, sc[u][r]);
      }
      const float corr = expf(m[r] - m_new);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = expf(sc[u][r] - m_new);
        psum += p[u];
      }
      l[r] = fmaf(l[r], corr, psum);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float a = acc[r][i] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vx[u][i], a);
        acc[r][i] = a;
      }
      m[r] = m_new;
    }
  }

  // merge the warps' states, G query rows behind one barrier; the block's
  // own result (S = 1) or its partial state (S > 1)
  const long long ml0 = part_ml(bgs, (long long)gridDim.y * kvg * splits, n_rep, hd);
#pragma unroll
  for (int rg = 0; rg < NREP; rg += G) {
    if (rg >= n_rep) break;  // block-uniform
    if (rg > 0) __syncthreads();  // the last group's reads are done
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (rg + j < n_rep) {
        if (lane == 0) {
          red_m[j][warp] = m[rg + j];
          red_l[j][warp] = l[rg + j];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) red_acc[j][warp][d0 + i] = acc[rg + j][i];
      }
    }
    __syncthreads();
    const int rows = min(G, n_rep - rg);
    // each warp's weight e^(m_w - M), once per (query row, warp)
    if (threadIdx.x < rows * WARPS) {
      const int j = threadIdx.x / WARPS;
      float big = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) big = fmaxf(big, red_m[j][w]);
      red_w[j][threadIdx.x % WARPS] = expf(red_m[j][threadIdx.x % WARPS] - big);
      if (threadIdx.x % WARPS == 0) red_big[j] = big;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * hd; e += TPB) {
      const int j = e / hd;
      const int d = e - j * hd;
      const float big = red_big[j];
      float total = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        total = fmaf(red_l[j][w], red_w[j][w], total);
        a = fmaf(red_acc[j][w][d], red_w[j][w], a);
      }
      const int r = rg + j;
      if (splits == 1) {
        out[((long long)b * h_all + g * n_rep + r) * hd + d] = a / fmaxf(total, 1e-30f);
        if (lse != nullptr && d == 0) lse[(long long)b * h_all + g * n_rep + r] = state_lse(big, total);
      } else {
        part[part_acc(bgs, n_rep, hd) + (long long)r * hd + d] = a;
        if (d == 0) {
          part[ml0 + 2 * r] = big;
          part[ml0 + 2 * r + 1] = total;
        }
      }
    }
  }
}

// One output element (slot b, kv head g, query row r, element d) a thread
// (grid (KV, B, ceil(n_rep hd / CT))) from the S partial states, s in order:
// M = max M_s, L = sum L_s e^(M_s - M), out = sum A_s e^(M_s - M) / max(L, 1e-30),
// and lse = M + log L (-inf where L = 0) where lse is not NULL.
// The partials' loads go out 8 splits at a time.
constexpr int CT = 128;
__global__ void __launch_bounds__(CT) paged_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                                                           float* __restrict__ lse, int kv, int n_rep, int hd,
                                                           int splits) {
  const int e = blockIdx.z * CT + threadIdx.x;  // r * hd + d
  if (e >= n_rep * hd) return;
  const int r = e / hd;
  const long long bg = (long long)blockIdx.y * kv + blockIdx.x;
  const float* acc = part + part_acc(bg * splits, n_rep, hd) + e;
  const float* ml = part + part_ml(bg * splits, (long long)gridDim.y * kv * splits, n_rep, hd) + 2 * r;
  float big = NEG_INF;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float mv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) mv[j] = s0 + j < splits ? ml[2 * (s0 + j) * n_rep] : NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) big = fmaxf(big, mv[j]);
  }
  float total = 0.f, a = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float mv[8], lv[8], av[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = s0 + j < splits;
      mv[j] = in ? ml[2 * (s0 + j) * n_rep] : 0.f;
      lv[j] = in ? ml[2 * (s0 + j) * n_rep + 1] : 0.f;
      av[j] = in ? acc[(long long)(s0 + j) * n_rep * hd] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (s0 + j < splits) {
        const float wt = expf(mv[j] - big);
        total = fmaf(lv[j], wt, total);
        a = fmaf(av[j], wt, a);
      }
    }
  }
  out[bg * n_rep * hd + e] = a / fmaxf(total, 1e-30f);
  if (lse != nullptr && e % hd == 0) lse[bg * n_rep + r] = state_lse(big, total);
}

template <typename T, int VEC, int NREP>
cudaError_t launch(const float* q, const void* k, const void* v, const int* tables, const int* lens,
                   float* out, float* part, float* lse, int b, int kv, int ng, int n_rep, int hd, int page,
                   int nb, int splits, float scale, float softcap, int window, int start, cudaStream_t stream) {
  // U rows per warp trip while the row registers stay small; 16 warps a
  // block where a thread's registers fit the 128 that 512 threads allow
  // (gemma2's n_rep = 2 at hd = 256), else 8
  constexpr int U = (NREP * VEC <= 32) ? 4 : (NREP * VEC <= 64 ? 2 : 1);
  constexpr int WARPS = NREP * VEC <= 16 ? 16 : 8;
  const dim3 grid(kv * ng, b, splits);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  if (hd == 32 * VEC)
    paged_decode_kernel<T, VEC, NREP, U, WARPS, true><<<grid, 32 * WARPS, 0, stream>>>(
        q, kp, vp, tables, lens, out, part, lse, kv, ng, n_rep, hd, page, nb, scale, softcap, window, start);
  else
    paged_decode_kernel<T, VEC, NREP, U, WARPS, false><<<grid, 32 * WARPS, 0, stream>>>(
        q, kp, vp, tables, lens, out, part, lse, kv, ng, n_rep, hd, page, nb, scale, softcap, window, start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_combine_kernel<<<dim3(kv * ng, b, (n_rep * hd + CT - 1) / CT), CT, 0, stream>>>(part, out, lse, kv * ng,
                                                                                        n_rep, hd, splits);
  return cudaGetLastError();
}

#define PA_ARGS \
  q, k, v, tables, lens, out, part, lse, b, kv, ng, n_rep, hd, page, nb, splits, scale, softcap, window, start, stream

template <typename T, int VEC>
cudaError_t by_nrep(const float* q, const void* k, const void* v, const int* tables, const int* lens,
                    float* out, float* part, float* lse, int b, int kv, int ng, int n_rep, int hd, int page,
                    int nb, int splits, float scale, float softcap, int window, int start, cudaStream_t stream) {
  // n_rep: the rows of one group (<= 8)
  if (n_rep <= 1) return launch<T, VEC, 1>(PA_ARGS);
  if (n_rep <= 2) return launch<T, VEC, 2>(PA_ARGS);
  if (n_rep <= 4) return launch<T, VEC, 4>(PA_ARGS);
  if (n_rep <= 8) return launch<T, VEC, 8>(PA_ARGS);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_vec(const float* q, const void* k, const void* v, const int* tables, const int* lens,
                   float* out, float* part, float* lse, int b, int kv, int ng, int n_rep, int hd, int page,
                   int nb, int splits, float scale, float softcap, int window, int start, cudaStream_t stream) {
  if (hd <= 32) return by_nrep<T, 1>(PA_ARGS);
  if (hd <= 64) return by_nrep<T, 2>(PA_ARGS);
  if (hd <= 128) return by_nrep<T, 4>(PA_ARGS);
  if (hd <= 256) return by_nrep<T, 8>(PA_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// k, v: the (P, page, KV, hd) page pools, of the dtype the code names;
// part: B * KV * splits * n_rep * (hd + 2) floats of scratch where splits > 1
// (may be NULL where splits == 1); splits * CH must cover every slot's live
// rows: min(nb * page, window or nb * page); start: the global row of a
// table's row 0 (0 for a whole cache); lse: (B, H) floats, or NULL
int paged_attention_decode(const float* q, const void* k, const void* v, const int* tables,
                           const int* lens, float* out, float* part, int b, int kv, int n_rep, int hd,
                           int page, int nb, int splits, float scale, float softcap, int window, int dtype,
                           int start, float* lse, cudaStream_t stream) {
  if (b <= 0 || kv <= 0 || n_rep <= 0 || hd <= 0 || page <= 0 || nb <= 0 || splits <= 0 || splits > 65535 ||
      start < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = window > 0 ? std::min((long long)nb * page, (long long)window) : (long long)nb * page;
  if ((long long)splits * CH < rows || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  // the query rows of a kv head in ng groups of at most 8 (any GQA ratio)
  int ng = 1;
  while (n_rep % ng || n_rep / ng > 8) ++ng;
  const int n_grp = n_rep / ng;
#define PA_GROUP_ARGS q, k, v, tables, lens, out, part, lse, b, kv, ng, n_grp, hd, page, nb, splits, scale, \
    softcap, window, start, stream
  cudaError_t err = dtype == 0   ? by_vec<float>(PA_GROUP_ARGS)
                    : dtype == 1 ? by_vec<__nv_bfloat16>(PA_GROUP_ARGS)
                                 : cudaErrorInvalidValue;
#undef PA_GROUP_ARGS
  return (int)err;
}
#undef PA_ARGS

const char* paged_attention_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
