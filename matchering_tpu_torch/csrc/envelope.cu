// K1: the limiter front end, a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel matchering_tpu/ops/pallas_envelope.py
// (`_envelope_kernel` and `limiter_front_end`).  For each row of a
// contiguous stereo batch x of shape (rows, n, 2) it computes, per sample,
//
//     peak   = max(|L|, |R|)
//     gain   = 1 - 1 / max(peak / threshold, 1)            (hard-clip gain)
//     slided = max(gain[i - half .. i + half])              (attack window)
//
// with window = 2*half + 1 = 2*make_odd(attack) - 1 and ndimage's 'reflect'
// edges (edge-duplicating: index -1 reads 0, index L reads L-1).  It is the
// fused form of `flip(1/rectify(x))` followed by `sliding_max_attack`, and
// is held to a max error of 0 against that composition: the gain is divided
// by the threshold exactly as the plain version does, the build uses no
// fast-math flags, and a maximum is exact in any order.
//
// Length mode (the bucket-padded batches of the farm and of
// Config(length_bucketing=N); the JAX package's masked rectify plus
// `sliding_max_attack_truncated`, matchering_tpu/limiter.py:124-130 and
// ops/sliding.py:73-95): `lengths`, when given, holds each row's true length
// L (window <= L <= n, checked on the host).  The row then ends at L: the
// mirrored edge reflects there (index j >= L reads 2L - j - 1), and gain and
// slided are 0 at i >= L.  A tile wholly past L reads nothing and writes
// only zeros.  Without `lengths` every row is full (L = n).
//
// What bounds it on an H100: bytes.  It reads the track once (8 bytes per
// sample in float32) and writes two float32 outputs (8 bytes per sample),
// 127 MB at n = 7,938,000, 37.9 us at 3.35 TB/s; over a padded batch it
// moves 16 bytes per padded sample less 8 per sample past a row's length.
//
// Design: the grid is (tiles, rows); a block owns a tile of
// kTile = kThreads * kRun = 8192 outputs of one row.
//   1. It computes the gains of its tile plus the (window - 1) halo straight
//      into shared memory, reading the stereo track with 16-byte vector
//      loads (float4: two stereo samples; double2: one), consecutive threads
//      on consecutive addresses; the mirrored edges are read by index
//      instead of building mirrored copies.  The halo is computed twice (by
//      two neighbouring blocks): (window - 1) / kTile = 1.1 % extra at the
//      default window of 89.
//   2. It stores `gain` for its own samples with 16-byte vector stores.
//   3. Each thread takes the window maxima of its own run of kRun = 32
//      consecutive outputs, van Herk / Gil-Werman style with the run as the
//      segment: the windows of the run share the middle span
//      [base + kRun - 1, base + window - 1], and output k adds the suffix
//      maximum of the left part from k and the prefix maximum of the right
//      part up to k.  That is window + kRun - 1 shared-memory reads for kRun
//      outputs, all in registers (a window narrower than the run takes the
//      plain loop of `window` reads per output instead).
//   4. The maxima go back through shared memory and out as 16-byte stores.
// Shared-memory reads per output at window 89: 1 (the gain copy) +
// (89 + 31) / 32 = 3.75 (the window) + 1 (the staged `slided`) = 5.75,
// against 89 + 1 for the plain loop this replaces.  The layout pads one
// element after every 32, so the 32 threads of a warp, each reading the same
// step of its own run, hit 32 different banks.

#include <cuda_runtime.h>

#include <cstdint>

#include "info.cuh"
#include "vec.cuh"

namespace {

constexpr int kRun = 32;                  // outputs per thread
constexpr int kThreads = 256;
constexpr int kTile = kRun * kThreads;    // 8192 outputs per block
constexpr int kMaxHalo = 2048;            // window - 1 must not exceed this
constexpr int kStaticSmem = 48 * 1024;    // dynamic shared memory without opting in

// shared-memory slot of span position j: one pad element after every 32
__device__ __forceinline__ int slot(int j) { return j + (j >> 5); }

int smem_bytes(int window, size_t itemsize) {
  const int span = kTile + window - 1;
  return static_cast<int>((span + (span - 1) / 32 + 1) * itemsize);
}

template <typename T>
__device__ __forceinline__ T hard_clip_gain(T left, T right, T threshold) {
  left = fabs(left);
  right = fabs(right);
  T peak = left > right ? left : right;
  T env = peak / threshold;
  env = env > T(1) ? env : T(1);
  return T(1) - T(1) / env;
}

template <typename T>
__device__ __forceinline__ T max_of(T a, T b) {
  return b > a ? b : a;
}

// gain of sample j of a row of length len with 'reflect' edges
// (j in [-half, len + half))
template <typename T>
__device__ __forceinline__ T edge_gain(const T* __restrict__ x, long long j, long long len,
                                       T threshold) {
  j = j < 0 ? -j - 1 : 2 * len - j - 1;
  return hard_clip_gain(x[2 * j], x[2 * j + 1], threshold);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    envelope_kernel(const T* __restrict__ x, T* __restrict__ gain, T* __restrict__ slided,
                    const long long* __restrict__ lengths, long long n, T threshold,
                    int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* g = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int half = window / 2;
  const int span = kTile + window - 1;
  const long long row = blockIdx.y;
  const long long len = lengths ? lengths[row] : n;  // the row ends here
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const long long first = start - half;  // sample of span position 0
  const int outputs = static_cast<int>(n - start < kTile ? n - start : kTile);
  x += 2 * row * n;
  gain += row * n;
  slided += row * n;
  if (start >= len) {  // wholly past the row's end
    store_each<kThreads>(gain + start, outputs, [](int) { return T(0); });
    store_each<kThreads>(slided + start, outputs, [](int) { return T(0); });
    return;
  }
  // outputs of this tile before the row's end; the rest are written as 0
  const int valid = static_cast<int>(len - start < outputs ? len - start : outputs);

  // 1. gains of the samples [first, first + span): those inside the row
  //    16 bytes a load, the mirrored edges by index, and zeros past the
  //    mirrored tail (they feed no output)
  const long long lo = first > 0 ? first : 0;
  const long long hi = first + span < len ? first + span : len;
  {
    constexpr int S = 8 / sizeof(T);  // stereo samples per 16-byte vector
    using VT = typename Vec<T>::type;
    const T* src = x + 2 * lo;
    const int count = static_cast<int>(hi - lo);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
    int head = count;  // a track not aligned to whole samples is read by scalars
    if (addr % (2 * sizeof(T)) == 0) {
      const int mis = static_cast<int>((addr / (2 * sizeof(T))) % S);
      head = min(mis ? S - mis : 0, count);
    }
    const int vecs = (count - head) / S;
    const int base = static_cast<int>(lo - first);
    for (int m = tid; m < head; m += kThreads) {
      g[slot(base + m)] = hard_clip_gain(src[2 * m], src[2 * m + 1], threshold);
    }
    const VT* body = reinterpret_cast<const VT*>(src + 2 * head);
    for (int v = tid; v < vecs; v += kThreads) {
      const VT val = __ldg(body + v);
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        g[slot(base + head + v * S + k)] = hard_clip_gain(e[2 * k], e[2 * k + 1], threshold);
      }
    }
    for (int m = head + vecs * S + tid; m < count; m += kThreads) {
      g[slot(base + m)] = hard_clip_gain(src[2 * m], src[2 * m + 1], threshold);
    }
    for (int t = tid; t < base; t += kThreads) {  // before sample 0
      g[slot(t)] = edge_gain(x, first + t, len, threshold);
    }
    for (int t = base + count + tid; t < span; t += kThreads) {  // past sample len - 1
      const long long j = first + t;
      g[slot(t)] = j < len + half ? edge_gain(x, j, len, threshold) : T(0);
    }
  }
  __syncthreads();

  // 2. the block's gains
  store_each<kThreads>(gain + start, outputs,
                       [&](int m) { return m < valid ? g[slot(m + half)] : T(0); });

  // 3. this thread's window maxima: output k of the run is the max of
  //    g[base + k .. base + k + window - 1]
  const int base = tid * kRun;
  T out[kRun];
  if (window >= kRun) {
    T middle = g[slot(base + kRun - 1)];
    for (int q = base + kRun; q < base + window; ++q) middle = max_of(middle, g[slot(q)]);
    T left = middle;
    out[kRun - 1] = middle;
#pragma unroll
    for (int k = kRun - 2; k >= 0; --k) {
      left = max_of(left, g[slot(base + k)]);
      out[k] = left;
    }
    T right = g[slot(base + window)];
    out[1] = max_of(out[1], right);
#pragma unroll
    for (int k = 2; k < kRun; ++k) {
      right = max_of(right, g[slot(base + window - 1 + k)]);
      out[k] = max_of(out[k], right);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      T m = g[slot(base + k)];
      for (int q = 1; q < window; ++q) m = max_of(m, g[slot(base + k + q)]);
      out[k] = m;
    }
  }
  __syncthreads();  // every read of the gains is done

  // 4. stage the maxima in shared memory, then store them 16 bytes at a time
#pragma unroll
  for (int k = 0; k < kRun; ++k) g[slot(base + k)] = out[k];
  __syncthreads();
  store_each<kThreads>(slided + start, outputs,
                       [&](int m) { return m < valid ? g[slot(m)] : T(0); });
}

template <typename T>
int launch(const T* x, T* gain, T* slided, const long long* lengths, long long rows,
           long long n, double threshold, int window, long long* launched, cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return 0;
  if (window < 1 || window - 1 > kMaxHalo || n < window || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n + kTile - 1) / kTile;
  const int smem = smem_bytes(window, sizeof(T));
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        envelope_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  envelope_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, gain, slided, lengths, n, static_cast<T>(threshold), window);
  *launched = static_cast<long long>(grid.x) * grid.y;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int window, long long* out) {
  const int smem = smem_bytes(window, sizeof(T));
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        envelope_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return kernel_info(envelope_kernel<T>, kThreads, smem, out);
}

}  // namespace

extern "C" {

int mtpu_envelope_max_halo() { return kMaxHalo; }

int mtpu_envelope_tile() { return kTile; }

// the launch at `window` (csrc/info.cuh): registers, shared memory, resident blocks
int mtpu_envelope_info(int f64, int window, long long* out) {
  return f64 ? info<double>(window, out) : info<float>(window, out);
}

// `lengths`: null, or a device array of `rows` int64 true lengths, each in
// [window, n] (the wrapper checks its host copy).  `launched`: a host
// int64 that receives the blocks of the launch (left as it is when there
// is none).
int mtpu_envelope_f32(const void* x, void* gain, void* slided, const void* lengths,
                      long long rows, long long n, double threshold, int window,
                      void* launched, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<float*>(gain),
                static_cast<float*>(slided), static_cast<const long long*>(lengths), rows,
                n, threshold, window, static_cast<long long*>(launched),
                static_cast<cudaStream_t>(stream));
}

int mtpu_envelope_f64(const void* x, void* gain, void* slided, const void* lengths,
                      long long rows, long long n, double threshold, int window,
                      void* launched, void* stream) {
  return launch(static_cast<const double*>(x), static_cast<double*>(gain),
                static_cast<double*>(slided), static_cast<const long long*>(lengths), rows,
                n, threshold, window, static_cast<long long*>(launched),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
