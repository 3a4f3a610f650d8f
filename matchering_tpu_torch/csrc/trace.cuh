// Per-tile phase stamps for tools_torch_scan_trace.py, compiled in only
// when the source is built with -DMTPU_TRACE (the tool's traced variants);
// otherwise every macro is empty and the kernel is unchanged.
//
// Each tile owns kTraceWords words: %globaltimer stamps 0-4 (the tile's
// start, its data in shared memory, its local scan done, its carry known,
// its store issued), the SM that ran it (5) and its look-back steps (6).
// mtpu_trace_copy copies them to the host.

#pragma once

#ifdef MTPU_TRACE

#include <cuda_runtime.h>

constexpr int kTraceWords = 8;
constexpr long long kTraceTiles = 1LL << 16;

__device__ unsigned long long g_trace[kTraceTiles * kTraceWords];

__device__ __forceinline__ void trace_word(long long tile, int k, unsigned long long value) {
  if (tile >= 0 && tile < kTraceTiles) g_trace[tile * kTraceWords + k] = value;
}

__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long trace_sm() {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  return sm;
}

// thread 0 of the block stamps phase k of `tile`
#define TRACE_STAMP(tile, k) \
  do {                                                      \
    if (threadIdx.x == 0) trace_word((tile), (k), trace_now()); \
  } while (0)
#define TRACE_WORD(tile, k, value) trace_word((tile), (k), (value))
#define TRACE_SM(tile) \
  do {                                                    \
    if (threadIdx.x == 0) trace_word((tile), 5, trace_sm()); \
  } while (0)

extern "C" int mtpu_trace_copy(void* dst, long long words) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, words * 8));
}

#else

#define TRACE_STAMP(tile, k) ((void)0)
#define TRACE_WORD(tile, k, value) ((void)0)
#define TRACE_SM(tile) ((void)0)

#endif
