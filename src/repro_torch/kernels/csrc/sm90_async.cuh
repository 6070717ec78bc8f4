// Hopper (sm_90a) asynchronous-copy helpers shared by the kernel sources:
// shared-memory mbarriers, bulk copies by the copy engine (cp.async.bulk)
// and per-thread cp.async pieces with zero fill.
//
// A ring stage is "full" when its mbarrier has its expected arrivals (one
// ``arrive.expect_tx`` of the producer's lane 0, one ``cp_async_arrive``
// of each producer lane) and the bulk bytes announced; consumers wait on
// the phase parity and arrive on the stage's "empty" barrier when done.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the copy engine and the other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one arrival on ``bar`` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }


// ``bytes`` (a multiple of 16, both ends 16-byte aligned) by the copy engine;
// completion is counted in ``bar``'s transaction bytes
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// W floats (4, 8 or 16 bytes) by one thread, asynchronously: the first
// ``bytes`` from ``src``, zeros for the rest
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src, unsigned bytes) {
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(4 * W),
                 "r"(bytes)
                 : "memory");
  }
}

// Rows [r0, r0 + rows) x columns [c0, c0 + cols) of a row-major (R, C)
// matrix with row stride ld into shared memory at row pitch ``pitch``, in
// pieces of W floats by threads ``tid`` (stride ``nthreads``), zeros outside
// the matrix.  W | C, W | c0 and W | cols, so a piece is wholly inside or
// outside it.
template <int W>
__device__ __forceinline__ void stage_rows(float* s, int pitch, const float* g, long long ld, long long r0, int c0,
                                           int rows, int cols, long long R, int C, int tid, int nthreads) {
  const int per_row = cols / W;
  for (int e = tid; e < rows * per_row; e += nthreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * W;
    const bool in = r0 + r < R && c0 + c < C;
    cp_async<W>(s + r * pitch + c, in ? g + (r0 + r) * ld + c0 + c : g, in ? 4 * W : 0);
  }
}

inline bool aligned(const void* p, unsigned bytes) { return reinterpret_cast<unsigned long long>(p) % bytes == 0; }

// the SM count of device ``dev``, asked once per device
inline int sm_count(int dev) {
  static std::atomic<int> counts[64];
  int n = counts[dev & 63].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) n = 1;
    counts[dev & 63].store(n);
  }
  return n;
}

}  // namespace sm90
