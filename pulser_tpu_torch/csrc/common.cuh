// Device helpers shared by the kernels of this directory: cp.async copies
// into shared memory, and the warp-wide search for the next step whose
// size is not zero (the start padding of a short segment has h = 0).

#pragma once

#include <cuda_runtime.h>

namespace pt {

constexpr unsigned kFull = 0xffffffffu;

// Starts an asynchronous 4-byte copy from device to shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Waits for this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dts[from + lane] for the calling lane, or 0 past `total`.
__device__ __forceinline__ float step_window(const float* __restrict__ dts,
                                             int from, int total) {
  const int i = from + (threadIdx.x & 31);
  return i < total ? __ldg(dts + i) : 0.0f;
}

// Warp-wide (every lane calls it): the first step index >= from whose
// size is not zero, or total. `win` is step_window(dts, from, total),
// loaded early so that its latency hides behind other work.
__device__ __forceinline__ int first_real(const float* __restrict__ dts,
                                          int from, int total, float win) {
  for (;;) {
    const unsigned hit = __ballot_sync(kFull, win != 0.0f);
    if (hit) return from + __ffs(hit) - 1;
    from += 32;
    if (from >= total) return total;
    win = step_window(dts, from, total);
  }
}

}  // namespace pt
