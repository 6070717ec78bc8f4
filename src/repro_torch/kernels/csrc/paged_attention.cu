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
//   lens    (B,) int32: valid rows per slot (>= 1)
//   out     (B, H, hd) f32
// Row t of slot b is live when t < len and, with window > 0, t >= len - window;
//   s = scale * q.k;  s = softcap * tanh(s / softcap) when softcap > 0;
//   out = sum_t softmax(s)_t v_t.
//
// Bound on an H100: bytes = sum_b rows_b * KV * hd * 2 * sizeof(page dtype)
// (k and v of the live rows, rows_b = min(len_b, window) or len_b) plus q
// and out; operations = 4 * sum_b rows_b * H * hd.  Two FLOP per byte of
// bf16 cache at n_rep = 2: bound by bytes (3.35 TB/s), by ~100x.
//
// Design.  The TPU kernel walks a sequential (slot, block) grid with a
// scalar-prefetched block table and carries the online-softmax state in
// VMEM scratch across the block axis.  Hopper has neither the sequential
// grid nor scalar prefetch, so:
//   * one block per (kv head g, slot b) holds the n_rep query rows of g and
//     reads its own block-table entries; GQA needs no expansion of the pool;
//   * its 8 warps split the live rows [lo, len) round-robin, U rows per warp
//     per loop trip; each lane holds VEC consecutive elements of a head row
//     (d = lane * VEC + i), read with 16-byte loads when hd = 32 * VEC, so
//     a warp reads a whole row (512 B of bf16 at hd = 256) coalesced;
//   * a trip issues all its rows' k / v loads, then all U x n_rep dot
//     products and their warp sums interleaved, then ONE online-softmax
//     update per query row (running max m, normaliser l, accumulator):
//     independent work in flight instead of one serial chain per row;
//   * the 8 warps' partial states are merged through shared memory at the
//     end: M = max m_w, L = sum l_w e^(m_w - M),
//     out = sum acc_w e^(m_w - M) / max(L, 1e-30);
//   * the loop visits live rows only, from the first page the window leaves
//     unmasked to the page that holds row len - 1; a trip's rows past len
//     get the reference's -1e30 logit, whose weight exp(-1e30 - m) is
//     exactly 0.0 — a masked row carries exactly 0 probability mass (the
//     paged == dense bit-identity of the plain route rests on it).
// Any page size >= 1 works: rows are addressed one by one through
// tables[b, t / page] and t % page.  hd <= 256 and n_rep <= 8 (the wrapper
// checks): the register arrays are sized by the templates below.  No TPU
// tile padding (the reference's kv / n_rep / hd zero-pads to (8, 128) tiles).
// Pages must be 16-byte aligned (the wrapper checks).  Plain f32 FMA, no
// tensor cores; splitting long contexts over more blocks (32 blocks fill a
// quarter of the card at B = 8, KV = 4) is later work.
//
// C interface: device pointers, sizes as int, scale and softcap as float,
// page dtype code (0 f32, 1 bf16), the CUDA stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int TPB = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

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

// VEC: elements of a head row per lane (hd <= 32 * VEC), lane l holding
// d = l * VEC + i; NREP: the largest n_rep this instance serves; U: rows per
// warp per loop trip; FULL: hd == 32 * VEC.
template <typename T, int VEC, int NREP, int U, bool FULL>
__global__ void __launch_bounds__(TPB) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ tables, const int* __restrict__ lens, float* __restrict__ out,
    int kv, int n_rep, int hd, int page, int nb, float scale, float softcap, int window) {
  __shared__ float red_m[WARPS];
  __shared__ float red_l[WARPS];
  __shared__ float red_acc[WARPS][32 * VEC];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * VEC;
  const int h_all = kv * n_rep;
  const int len = lens[b];
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int* trow = tables + (long long)b * nb;

  float qv[NREP][VEC];
  float m[NREP], l[NREP], acc[NREP][VEC];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[r][i] = 0.f;
      const int d = d0 + i;
      qv[r][i] = (r < n_rep && d < hd) ? q[((long long)b * h_all + g * n_rep + r) * hd + d] : 0.f;
    }
  }

  for (int t0 = lo + warp * U; t0 < len; t0 += WARPS * U) {
    // the trip's U rows: all loads first, then every dot product
    float kx[U][VEC], vx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const long long phys = trow[t / page];
        const long long base = ((phys * page + t % page) * kv + g) * (long long)hd;
        load_row<T, VEC, FULL>(k_pages + base, d0, hd, kx[u]);
        load_row<T, VEC, FULL>(v_pages + base, d0, hd, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
    float s[U][NREP];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(qv[r][i], kx[u][i], part);
        s[u][r] = part;
      }
    // U * NREP independent warp sums, interleaved
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < NREP; ++r) s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], off);
    // one online-softmax update per query row per trip; a row past len gets
    // the reference's -1e30 logit, so its weight exp(-1e30 - m) is exactly 0
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (r >= n_rep) break;  // block-uniform
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = s[u][r] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][r] = t0 + u < len ? x : NEG_INF;
        m_new = fmaxf(m_new, s[u][r]);
      }
      const float corr = expf(m[r] - m_new);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = expf(s[u][r] - m_new);
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

  // merge the warps' partial softmax states, one query row at a time
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (r >= n_rep) break;
    if (lane == 0) {
      red_m[warp] = m[r];
      red_l[warp] = l[r];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) red_acc[warp][d0 + i] = acc[r][i];
    __syncthreads();
    float big = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) big = fmaxf(big, red_m[w]);
    float total = 0.f;
    float wt[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      wt[w] = expf(red_m[w] - big);
      total = fmaf(red_l[w], wt[w], total);
    }
    const float inv = 1.f / fmaxf(total, 1e-30f);
    float* orow = out + ((long long)b * h_all + g * n_rep + r) * hd;
    for (int d = threadIdx.x; d < hd; d += TPB) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a = fmaf(red_acc[w][d], wt[w], a);
      orow[d] = a * inv;
    }
    __syncthreads();
  }
}

template <typename T, int VEC, int NREP>
cudaError_t launch(const float* q, const void* k, const void* v, const int* tables, const int* lens,
                   float* out, int b, int kv, int n_rep, int hd, int page, int nb, float scale,
                   float softcap, int window, cudaStream_t stream) {
  // U rows per warp trip while the row registers stay small
  constexpr int U = (NREP * VEC <= 32) ? 4 : (NREP * VEC <= 64 ? 2 : 1);
  const dim3 grid(kv, b);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  if (hd == 32 * VEC)
    paged_decode_kernel<T, VEC, NREP, U, true><<<grid, TPB, 0, stream>>>(
        q, kp, vp, tables, lens, out, kv, n_rep, hd, page, nb, scale, softcap, window);
  else
    paged_decode_kernel<T, VEC, NREP, U, false><<<grid, TPB, 0, stream>>>(
        q, kp, vp, tables, lens, out, kv, n_rep, hd, page, nb, scale, softcap, window);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t by_nrep(const float* q, const void* k, const void* v, const int* tables, const int* lens,
                    float* out, int b, int kv, int n_rep, int hd, int page, int nb, float scale,
                    float softcap, int window, cudaStream_t stream) {
#define PA_ARGS q, k, v, tables, lens, out, b, kv, n_rep, hd, page, nb, scale, softcap, window, stream
  if (n_rep <= 1) return launch<T, VEC, 1>(PA_ARGS);
  if (n_rep <= 2) return launch<T, VEC, 2>(PA_ARGS);
  if (n_rep <= 4) return launch<T, VEC, 4>(PA_ARGS);
  if (n_rep <= 8) return launch<T, VEC, 8>(PA_ARGS);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_vec(const float* q, const void* k, const void* v, const int* tables, const int* lens,
                   float* out, int b, int kv, int n_rep, int hd, int page, int nb, float scale,
                   float softcap, int window, cudaStream_t stream) {
  if (hd <= 32) return by_nrep<T, 1>(PA_ARGS);
  if (hd <= 64) return by_nrep<T, 2>(PA_ARGS);
  if (hd <= 128) return by_nrep<T, 4>(PA_ARGS);
  if (hd <= 256) return by_nrep<T, 8>(PA_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// k, v: the (P, page, KV, hd) page pools, of the dtype the code names
int paged_attention_decode(const float* q, const void* k, const void* v, const int* tables,
                           const int* lens, float* out, int b, int kv, int n_rep, int hd, int page, int nb,
                           float scale, float softcap, int window, int dtype, cudaStream_t stream) {
  if (b <= 0 || kv <= 0 || n_rep <= 0 || hd <= 0 || page <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtype == 0   ? by_vec<float>(PA_ARGS)
                    : dtype == 1 ? by_vec<__nv_bfloat16>(PA_ARGS)
                                 : cudaErrorInvalidValue;
  return (int)err;
}
#undef PA_ARGS

const char* paged_attention_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
