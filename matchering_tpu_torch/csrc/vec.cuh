// 16-byte vector loads and stores of a contiguous range, shared by the
// port's kernels (csrc/envelope.cu, csrc/scan.cu).
//
// A block of Threads threads walks [0, count): a scalar head up to the
// first 16-byte boundary, then whole float4 / double2 vectors with
// consecutive threads on consecutive addresses, then a scalar tail.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

// fn(m, src[m]) for m in [0, count), 16 bytes a load where aligned
template <int Threads, typename T, typename F>
__device__ __forceinline__ void load_each(const T* __restrict__ src, int count, F fn) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec<T>::type;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % V);
  const int head = min(mis ? V - mis : 0, count);
  const int vecs = (count - head) / V;
  for (int m = threadIdx.x; m < head; m += Threads) fn(m, src[m]);
  const VT* body = reinterpret_cast<const VT*>(src + head);
  for (int v = threadIdx.x; v < vecs; v += Threads) {
    const VT val = __ldg(body + v);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int k = 0; k < V; ++k) fn(head + v * V + k, e[k]);
  }
  for (int m = head + vecs * V + threadIdx.x; m < count; m += Threads) fn(m, src[m]);
}

// dst[m] = fn(m) for m in [0, count), 16 bytes a store where aligned
template <int Threads, typename T, typename F>
__device__ __forceinline__ void store_each(T* __restrict__ dst, int count, F fn) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec<T>::type;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(dst) / sizeof(T)) % V);
  const int head = min(mis ? V - mis : 0, count);
  const int vecs = (count - head) / V;
  for (int m = threadIdx.x; m < head; m += Threads) dst[m] = fn(m);
  VT* body = reinterpret_cast<VT*>(dst + head);
  for (int v = threadIdx.x; v < vecs; v += Threads) {
    VT val;
    T* e = reinterpret_cast<T*>(&val);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = fn(head + v * V + k);
    body[v] = val;
  }
  for (int m = head + vecs * V + threadIdx.x; m < count; m += Threads) dst[m] = fn(m);
}
