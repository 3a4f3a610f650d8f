// K2: the first-order IIR scan, a hand-written CUDA kernel for Hopper (sm_90a).
//
// Computes scipy.signal.lfilter([b0, b1], [1, a1], x, zi=[zi]) along each
// row of a contiguous (rows, n) tensor:
//
//     y[i] = b0*x[i] + b1*x[i-1] - a1*y[i-1],   y[0] = b0*x[0] + zi
//
// optionally scanning from the end of the row (`reverse`), which is the
// backward pass of filtfilt without flipping the track.  It replaces the
// XLA scans of matchering_tpu/ops/iir.py (`scan_first_order`, the shift
// ladder, and the double-single `scan_first_order_ds` machinery, lines
// 105-822), which existed because the TPU has no float64: at the limiter's
// release pole 1 - p is about 3.8e-5, and a float32 state loses the output.
// Here the state, the pole and the coefficients are float64 whatever the
// input/output type, so no compensation is needed.
//
// What bounds it on an H100: bytes.  It reads x once and writes y once,
// 63.5 MB per call at n = 7.94 M in float32, about 19 us at 3.35 TB/s.  The
// recurrence is sequential, so the design is a chunked scan in three steps:
//   1. each thread scans one chunk of kChunk samples from a zero state and
//      writes the chunk's end state;
//   2. the chunk end states form the same kind of recurrence with the pole
//      p^kChunk (computed on the host in float64), scanned by this same
//      code recursively until one chunk holds a whole row;
//   3. each thread rescans its chunk from its carried-in state and writes y.
// x is read twice (steps 1 and 3); at this size the second read is served
// largely from the 50 MB L2.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 256;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// One thread per chunk of one row (blockIdx.y).  With `carry` null the
// chunk starts from a zero state, else from carry[c - 1]; `ends` (if not
// null) receives the chunk's end state, `y` (if not null) the outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_scan(const T* __restrict__ x, T* __restrict__ y,
               const double* __restrict__ zi, const double* __restrict__ carry,
               double* __restrict__ ends, long long n, long long chunks,
               double b0, double b1, double pole, int reverse) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const long long row = blockIdx.y;
  x += row * n;
  if (y) y += row * n;
  const long long k0 = c * kChunk;
  const long long k1 = k0 + kChunk < n ? k0 + kChunk : n;

  double s = (carry && c > 0) ? carry[row * chunks + c - 1] : 0.0;
  // the sample before this chunk in scan order feeds the b1 term
  double prev = 0.0;
  if (k0 > 0) prev = static_cast<double>(x[reverse ? n - k0 : k0 - 1]);
  for (long long k = k0; k < k1; ++k) {
    const long long i = reverse ? n - 1 - k : k;
    const double xi = static_cast<double>(x[i]);
    double drive = b0 * xi + b1 * prev;
    if (k == 0 && zi) drive += zi[row];
    s = drive + pole * s;
    prev = xi;
    if (y) y[i] = static_cast<T>(s);
  }
  if (ends) ends[row * chunks + c] = s;
}

template <typename T>
int scan(const T* x, T* y, const double* zi, long long rows, long long n,
         double b0, double b1, double pole, int reverse, double* scratch,
         cudaStream_t stream) {
  const long long chunks = ceil_div(n, kChunk);
  const dim3 grid(static_cast<unsigned>(ceil_div(chunks, kThreads)),
                  static_cast<unsigned>(rows));
  if (chunks == 1) {
    chunk_scan<T><<<grid, kThreads, 0, stream>>>(x, y, zi, nullptr, nullptr, n,
                                                 chunks, b0, b1, pole, reverse);
    return static_cast<int>(cudaGetLastError());
  }
  double* ends = scratch;
  double* carried = scratch + rows * chunks;
  double* rest = carried + rows * chunks;
  chunk_scan<T><<<grid, kThreads, 0, stream>>>(x, nullptr, zi, nullptr, ends, n,
                                               chunks, b0, b1, pole, reverse);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // carried[c] = ends[c] + p^kChunk * carried[c - 1]: the state at the end
  // of chunk c, the same recurrence one level up
  err = scan<double>(ends, carried, nullptr, rows, chunks, 1.0, 0.0,
                     std::pow(pole, kChunk), 0, rest, stream);
  if (err) return err;
  chunk_scan<T><<<grid, kThreads, 0, stream>>>(x, y, zi, carried, nullptr, n,
                                               chunks, b0, b1, pole, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float64 scratch elements a call over (rows, n) needs
long long mtpu_scan_scratch(long long rows, long long n) {
  long long total = 0;
  for (long long m = n; m > kChunk; m = ceil_div(m, kChunk)) {
    total += 2 * rows * ceil_div(m, kChunk);
  }
  return total;
}

int mtpu_scan_f32(const void* x, void* y, const void* zi, long long rows,
                  long long n, double b0, double b1, double a1, int reverse,
                  void* scratch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return scan(static_cast<const float*>(x), static_cast<float*>(y),
              static_cast<const double*>(zi), rows, n, b0, b1, -a1, reverse,
              static_cast<double*>(scratch), static_cast<cudaStream_t>(stream));
}

int mtpu_scan_f64(const void* x, void* y, const void* zi, long long rows,
                  long long n, double b0, double b1, double a1, int reverse,
                  void* scratch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return scan(static_cast<const double*>(x), static_cast<double*>(y),
              static_cast<const double*>(zi), rows, n, b0, b1, -a1, reverse,
              static_cast<double*>(scratch), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
