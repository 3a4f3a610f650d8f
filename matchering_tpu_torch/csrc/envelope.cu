// K1: the limiter front end, a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel matchering_tpu/ops/pallas_envelope.py
// (`_envelope_kernel` and `limiter_front_end`).  For a contiguous stereo
// track x of shape (n, 2) it computes, per sample,
//
//     peak   = max(|L|, |R|)
//     gain   = 1 - 1 / max(peak / threshold, 1)            (hard-clip gain)
//     slided = max(gain[i - half .. i + half])              (attack window)
//
// with window = 2*half + 1 = 2*make_odd(attack) - 1 and ndimage's 'reflect'
// edges (edge-duplicating: index -1 reads 0, index n reads n-1).  It is the
// fused form of `flip(1/rectify(x))` followed by `sliding_max_attack`, and
// is held to a max error of 0 against that composition: the gain is divided
// by the threshold exactly as the plain version does, and the build uses no
// fast-math flags.
//
// What bounds it on an H100: bytes.  It reads the track once (8 bytes per
// sample in float32) and writes two float32 outputs (8 bytes per sample),
// 127 MB at n = 7,938,000, about 38 us at 3.35 TB/s.  The design keeps the
// gains out of device memory between the stages: each block computes the
// gains of its tile plus the (window - 1) halo straight into shared memory,
// reading the mirrored edges by index instead of building mirrored copies,
// writes `gain` for its own samples, and takes the window max with a plain
// loop over shared memory.  Halo samples are computed twice (by two
// neighbouring blocks), which costs (window - 1) / TILE extra reads, 4 % at
// the default window of 89.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;     // output samples per block
constexpr int kThreads = 256;
constexpr int kMaxHalo = 2048;  // window - 1 must not exceed this

template <typename T>
__device__ __forceinline__ T hard_clip_gain(const T* __restrict__ x, long long j,
                                            long long n, T threshold) {
  if (j < 0) {
    j = -j - 1;
  } else if (j >= n) {
    j = 2 * n - j - 1;
  }
  T left = fabs(x[2 * j]);
  T right = fabs(x[2 * j + 1]);
  T peak = left > right ? left : right;
  T env = peak / threshold;
  env = env > T(1) ? env : T(1);
  return T(1) - T(1) / env;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    envelope_kernel(const T* __restrict__ x, T* __restrict__ gain,
                    T* __restrict__ slided, long long n, T threshold, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* g = reinterpret_cast<T*>(smem_raw);
  const int half = window / 2;
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const int span = kTile + window - 1;

  // gains of [start - half, start + kTile + half); positions past the
  // mirrored tail feed no output and are zero
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    long long j = start - half + t;
    g[t] = j < n + half ? hard_clip_gain(x, j, n, threshold) : T(0);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    long long i = start + t;
    if (i >= n) break;
    gain[i] = g[t + half];
    T m = g[t];
    for (int k = 1; k < window; ++k) {
      T v = g[t + k];
      m = v > m ? v : m;
    }
    slided[i] = m;
  }
}

template <typename T>
int launch(const T* x, T* gain, T* slided, long long n, double threshold,
           int window, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (window < 1 || window - 1 > kMaxHalo) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kTile - 1) / kTile;
  size_t smem = static_cast<size_t>(kTile + window - 1) * sizeof(T);
  envelope_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, gain, slided, n, static_cast<T>(threshold), window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mtpu_envelope_max_halo() { return kMaxHalo; }

int mtpu_envelope_f32(const void* x, void* gain, void* slided, long long n,
                      double threshold, int window, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<float*>(gain),
                static_cast<float*>(slided), n, threshold, window,
                static_cast<cudaStream_t>(stream));
}

int mtpu_envelope_f64(const void* x, void* gain, void* slided, long long n,
                      double threshold, int window, void* stream) {
  return launch(static_cast<const double*>(x), static_cast<double*>(gain),
                static_cast<double*>(slided), n, threshold, window,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
