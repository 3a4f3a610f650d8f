// K4: the limiter back end, a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes this chain as XLA ops
// (matchering_tpu/limiter.py:138), which XLA fuses into one pass.  In the
// port it was seven full-track PyTorch passes after the limiter's last scan.
// For each row r of a contiguous stereo batch x of shape (rows, n, 2) and
// each sample i it computes
//
//     g   = 1 - max(hard_clip, attack, max(hold, release))   (torch.maximum:
//                                                             a NaN wins)
//     g   = g * (i < length[r] ? 1 : 0)                      (with lengths)
//     y   = pass[r] ? x[r, i, :] : x[r, i, :] * g            (both channels)
//     out = y * scale[r]                                      (with a scale)
//
// the composition `flip(max_mix(hard_clip, attack, maximum(hold, release)))`,
// the length mask, `torch.where(pass, x, x * g)` and the per-row scale of
// kernels/back_end.py's plain twin, operation for operation and in its
// order.  Each subtraction and product is an explicitly rounded intrinsic
// (no contraction into an FMA), the build uses no fast-math flags, and a
// maximum is exact, so the output equals the twin's bit for bit in float32
// and float64.  The mask is a product, as in the twin, so a NaN gain stays
// NaN past a row's length.
//
// What bounds it on an H100: bytes.  It reads four gains (16 bytes a sample
// in float32) and the stereo track (8 bytes) and writes the stereo output
// (8 bytes): 32 bytes a sample, 11.06 GB at the long form's 345.6 M samples,
// 3.30 ms at 3.35 TB/s.  A row's length, flag and scale are a few bytes a
// row.  The passes it replaces move about 104 bytes a sample (122 with
// lengths).
//
// Design: a pure stream, so the only aim is to keep the memory busy.
//   * One thread a sample over the flat index space of rows * n samples, so
//     no block idles at a short row and n need not be a multiple of
//     anything.  Consecutive threads read consecutive gains (4 or 8 bytes)
//     and consecutive stereo pairs (float2 / double2), so every warp's loads
//     and stores are whole 128-byte lines.
//   * The row of a sample is one float64 product by 1/n, corrected by one
//     step (exact for flat indices below 2^52).  A row's length, flag and
//     scale are read through the read-only cache, which serves a block from
//     one line.
//   * Each gain has its own row stride, so the views the scans hand over
//     are read where they lie: the static filtfilt's gain starts 6 samples
//     into its buffer, the length-aware one's rows are n + 6 apart.  A copy
//     to make them contiguous cost 1.1 ms at the farm's 16 x 18,350,080.
//   * Measured on an H100 80GB HBM3 at 1 x 345.6 M (PERF.md, section 6), this
//     runs at 93 % of the bound, as fast as four samples a thread with
//     16-byte loads, with or without evict-first loads and stores (3.533
//     against 3.542 and 3.539 ms): the stream is bound by DRAM either way,
//     and one sample a thread needs no alignment of any input.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "info.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T> struct Arith;
template <> struct Arith<float> {
  using Pair = float2;
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Arith<double> {
  using Pair = double2;
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
};

// torch.maximum: a NaN operand wins, else the larger
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// the four gains, each with its row stride in elements
template <typename T>
struct Gains {
  const T* p[4];
  long long stride[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    back_end_kernel(const T* __restrict__ x, Gains<T> gains, const unsigned char* __restrict__ pass,
                    const long long* __restrict__ lengths, const T* __restrict__ scale,
                    T* __restrict__ out, long long rows, long long n, double inv_n, bool pairs) {
  using A = Arith<T>;
  using P = typename A::Pair;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= rows * n) return;
  long long row = static_cast<long long>(static_cast<double>(j) * inv_n);
  if (row * n > j) {
    --row;
  } else if ((row + 1) * n <= j) {
    ++row;
  }
  const long long i = j - row * n;
  T g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = gains.p[k][row * gains.stride[k] + i];
  T left, right;
  if (pairs) {  // x 2 * sizeof(T)-aligned: the sample is one load
    const P v = reinterpret_cast<const P*>(x)[j];
    left = v.x;
    right = v.y;
  } else {
    left = x[2 * j];
    right = x[2 * j + 1];
  }

  T gain = A::sub(T(1), nan_max(nan_max(g[0], g[1]), nan_max(g[2], g[3])));
  if (lengths) gain = A::mul(gain, i < __ldg(lengths + row) ? T(1) : T(0));
  if (!__ldg(pass + row)) {
    left = A::mul(left, gain);
    right = A::mul(right, gain);
  }
  if (scale) {
    const T factor = __ldg(scale + row);
    left = A::mul(left, factor);
    right = A::mul(right, factor);
  }
  P o;
  o.x = left;
  o.y = right;
  reinterpret_cast<P*>(out)[j] = o;  // a fresh tensor: aligned
}

template <typename T>
int launch(const T* x, const Gains<T>& gains, const unsigned char* pass, const long long* lengths,
           const T* scale, T* out, long long rows, long long n, long long* launched,
           cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long blocks = (rows * n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool pairs = reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  back_end_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, gains, pass, lengths, scale, out, rows, n, 1.0 / static_cast<double>(n), pairs);
  *launched = blocks;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* hard_clip, const void* attack, const void* hold,
        const void* release, long long hard_clip_stride, long long attack_stride,
        long long hold_stride, long long release_stride, const void* pass, const void* lengths,
        const void* scale, void* out, long long rows, long long n, void* launched,
        void* stream) {
  const Gains<T> gains{{static_cast<const T*>(hard_clip), static_cast<const T*>(attack),
                        static_cast<const T*>(hold), static_cast<const T*>(release)},
                       {hard_clip_stride, attack_stride, hold_stride, release_stride}};
  return launch(static_cast<const T*>(x), gains, static_cast<const unsigned char*>(pass),
                static_cast<const long long*>(lengths), static_cast<const T*>(scale),
                static_cast<T*>(out), rows, n, static_cast<long long*>(launched),
                static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// the launch (csrc/info.cuh): registers, shared memory, resident blocks
int mtpu_back_end_info(int f64, long long* out) {
  return f64 ? kernel_info(back_end_kernel<double>, kThreads, 0, out)
             : kernel_info(back_end_kernel<float>, kThreads, 0, out);
}

// x: (rows, n, 2) contiguous; out: the same, fresh.  The four gains: row r's
// sample i at gain[r * stride + i].  `pass`: one byte a row, nonzero where
// the row passes unlimited.  `lengths`: null, or a device array of `rows`
// int64 true lengths in [0, n] (the wrapper checks its host copy).
// `scale`: null, or one value a row.  `launched`: a host int64 that
// receives the blocks of the launch (left as it is when there is none).
int mtpu_back_end_f32(const void* x, const void* hard_clip, const void* attack,
                      const void* hold, const void* release, long long hard_clip_stride,
                      long long attack_stride, long long hold_stride, long long release_stride,
                      const void* pass, const void* lengths, const void* scale, void* out,
                      long long rows, long long n, void* launched, void* stream) {
  return run<float>(x, hard_clip, attack, hold, release, hard_clip_stride, attack_stride,
                    hold_stride, release_stride, pass, lengths, scale, out, rows, n, launched,
                    stream);
}

int mtpu_back_end_f64(const void* x, const void* hard_clip, const void* attack,
                      const void* hold, const void* release, long long hard_clip_stride,
                      long long attack_stride, long long hold_stride, long long release_stride,
                      const void* pass, const void* lengths, const void* scale, void* out,
                      long long rows, long long n, void* launched, void* stream) {
  return run<double>(x, hard_clip, attack, hold, release, hard_clip_stride, attack_stride,
                     hold_stride, release_stride, pass, lengths, scale, out, rows, n, launched,
                     stream);
}

}  // extern "C"
