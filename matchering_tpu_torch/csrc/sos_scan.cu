// K3: the second-order-section scan, a hand-written CUDA kernel for Hopper (sm_90a).
//
// Computes scipy.signal.sosfilt([[b0, b1, b2, 1, a1, a2]], x) with zero
// initial state along each row of a contiguous (rows, n) tensor, in the
// transposed direct form II of scipy:
//
//     y[i]  = b0*x[i] + z1[i-1]
//     z1[i] = b1*x[i] - a1*y[i] + z2[i-1]
//     z2[i] = b2*x[i] - a2*y[i]
//
// i.e. the state s = (z1, z2) obeys s[i] = A s[i-1] + B x[i] with
// A = [[-a1, 1], [-a2, 0]] and B = (b1 - a1*b0, b2 - a2*b0).  It replaces the
// 2x2 `associative_scan` of matchering_tpu/ops/iir.py (`lfilter`, lines
// 992-1049) that `butter_lowpass` runs for every section of a Butterworth
// order above 1 (lines 970-989).  The state, A, B and every power of A are
// float64 whatever the input/output type: at the limiter's release cutoff
// the poles lie about 2.7e-5 inside the unit circle.
//
// What bounds it on an H100: bytes.  It reads x once and writes y once,
// 63.5 MB per call at n = 7,938,000 in float32, 19.0 us at 3.35 TB/s; its
// ~20 float64 operations a sample (two passes) take 4.7 us at 34 TFLOP/s.
//
// Design: K2's (csrc/scan.cu) with the state grown from a scalar to a
// 2-vector.  One launch per call, a single-pass scan with decoupled
// look-back (Merrill & Garland, NVIDIA NVR-2016-002).
//   * A block owns a tile of kTile = kThreads * kRun consecutive samples
//     (256 threads x 16 = 4096), loaded with 16-byte vector loads into
//     shared memory padded one element after every run.
//   * Each thread scans its run of kRun samples from a zero state.
//   * A span of L samples composes as s <- s_span + A^L s_before: a warp
//     shuffle scan combines the threads' end states with A^(kRun*2^k), warp
//     0 combines the warps' with A^(kRun*32*2^k), and look-back combines the
//     tiles with A^(kTile*2^k), one factor for each bit of the distance.
//     The matrices A^(kRun*2^k), k < kPowers, come from the host
//     (kernels/sos.py: squared out at 50 decimal digits, each passed as a
//     float64 pair hi + lo) as a kernel parameter.
//   * Look-back: warp 0 reads the status of the 32 tiles before its own,
//     sums their aggregates up to the nearest inclusive prefix, and steps
//     32 tiles further back where there is none.
//   * Each thread rescans its run from its carried-in state and writes y
//     into shared memory; the block stores the tile with 16-byte stores.
// Launches per call: 1, after the wrapper's zeroing of the status array.
//
// Trouble spots:
//   * Conditioning.  At the release cutoff the poles are a complex pair
//     about 2.7e-5 inside the unit circle at an angle theta of about
//     2.7e-5.  A^L then has entries up to ~1/theta ~ 4e4 that cancel when
//     applied to a state (z1 ~ -z2), and an error put into the state grows
//     by up to as much again before it decays.  A combine rounded term by
//     term puts eps * |A^L| * |s| into the state, which that growth
//     amplifies (a blocked scan combined that way is ~1.6e-8 off at
//     200,000 samples, sosfilt's sequential steps 6.5e-10).  So every
//     combine, `affine`, takes A^L as hi + lo, forms the products with fma
//     and the sums with Knuth's two-sum (through __dmul_rn/__dadd_rn, which
//     the compiler never fuses), and rounds once: its error is one
//     rounding of the result.  No matrix is multiplied by another on the
//     card; a power that is a product of table entries is applied to the
//     state one factor at a time.  The host's 50-digit squaring keeps the
//     powers themselves exact to about 32 digits (a closed form through
//     the eigenvalues divides by lambda - conj(lambda) and loses 4-5).
//   * Forward progress: the tile index comes from an atomicAdd on a zeroed
//     counter, so a block only waits on tiles handed out before its own.
//   * Publishing a 2-vector: each state word is a float64's bits XOR
//     kPublished (a NaN payload no float64 operation returns), so a
//     published word is never zero.  A tile publishes its aggregate as two
//     words and later its inclusive prefix as two more, each with one
//     relaxed 64-bit atomic store.  A reader takes a pair only when both
//     of its words are non-zero; every word is written once, from zero to
//     its final value, so no pair can be read torn and no fence is needed.
//   * Results are not bit-stable across runs: which predecessors a tile
//     combines before it meets an inclusive prefix depends on timing.
//   * Rows: tile indices run row-major over (row, tile); tile 0 of a row
//     publishes its prefix at once, so look-back never leaves the row.
//   * No `lengths`: the filter is causal with zero state, so a zero-padded
//     row is right on [0, L), and the limiter masks past L.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "vec.cuh"

namespace {

constexpr int kRun = 16;                    // consecutive samples per thread
constexpr int kTileLog = 8;                 // 2^kTileLog threads per block
constexpr int kThreads = 1 << kTileLog;
constexpr int kWarpsLog = kTileLog - 5;
constexpr int kWarps = 1 << kWarpsLog;
constexpr int kTile = kRun * kThreads;      // 4096 samples per block
constexpr int kDistanceBits = 31;           // a tile index is below 2^31
// A^(kRun * 2^k) for k < kPowers: shuffles (k < 5), warps (k < kTileLog) and
// look-back distances of 2^(k - kTileLog) tiles (kTileLog <= k)
constexpr int kPowers = kTileLog + kDistanceBits;
constexpr unsigned long long kPublished = 0x7ff0000000000001ULL;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarpsLog >= 0 && kWarps <= 32, "warp 0 combines the warps");
static_assert((kTile + kThreads) * sizeof(double) <= 48 * 1024, "a tile fits static shared memory");

// Resident blocks per SM that the registers must allow.  K2 asks for 8
// (32 registers a thread); the compensated 2x2 combines need more, so K3
// asks for 4 (64 registers a thread).
constexpr int kMinBlocks = 4;

struct State {
  double z1, z2;
};

struct Power {     // a 2x2 matrix as hi + lo, each row-major
  double hi[4];
  double lo[4];
};

struct Powers {
  Power p[kPowers];  // p[k] = A^(kRun * 2^k)
};
static_assert(sizeof(Powers) <= 4000, "the powers fit the kernel's parameter space");

using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ int slot(int j) { return j + j / kRun; }

__device__ __forceinline__ State operator+(State a, State b) { return {a.z1 + b.z1, a.z2 + b.z2}; }

__device__ __forceinline__ State shfl_up(State s, int delta) {
  return {__shfl_up_sync(kFull, s.z1, delta), __shfl_up_sync(kFull, s.z2, delta)};
}

__device__ __forceinline__ State shfl(State s, int lane) {
  return {__shfl_sync(kFull, s.z1, lane), __shfl_sync(kFull, s.z2, lane)};
}

// row i of add + (hi + lo) v, rounded once: exact products (fma) and sums
// (Knuth's two-sum), their errors and the lo terms summed, then one rounding
__device__ __forceinline__ double affine_row(const double* hi, const double* lo, State v,
                                             double add) {
  const double p0 = __dmul_rn(hi[0], v.z1);
  const double e0 = fma(hi[0], v.z1, -p0);
  const double p1 = __dmul_rn(hi[1], v.z2);
  const double e1 = fma(hi[1], v.z2, -p1);
  const double s = __dadd_rn(p0, p1);
  const double sb = __dsub_rn(s, p0);
  const double e2 = __dadd_rn(__dsub_rn(p0, __dsub_rn(s, sb)), __dsub_rn(p1, sb));
  const double u = __dadd_rn(s, add);
  const double ub = __dsub_rn(u, s);
  const double e3 = __dadd_rn(__dsub_rn(s, __dsub_rn(u, ub)), __dsub_rn(add, ub));
  const double rest = lo[0] * v.z1 + lo[1] * v.z2;
  return u + (((e0 + e1) + (e2 + e3)) + rest);
}

// add + M v for M = A^(kRun * 2^k), off by about one rounding of the result
__device__ __forceinline__ State affine(const Power& m, State v, State add) {
  return {affine_row(m.hi, m.lo, v, add.z1), affine_row(m.hi + 2, m.lo + 2, v, add.z2)};
}

// A^(kRun * e * 2^First) v for 0 <= e < 2^Bits, one factor at a time
// (powers of one matrix commute, so the order of the factors is free)
template <int First, int Bits>
__device__ __forceinline__ State apply_power(const Powers& pw, unsigned e, State v) {
#pragma unroll
  for (int k = 0; k < Bits; ++k) {
    if ((e >> k) & 1) v = affine(pw.p[First + k], v, State{0.0, 0.0});
  }
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* words, State value) {
  Word(words[0]).store(static_cast<unsigned long long>(__double_as_longlong(value.z1)) ^ kPublished,
                       cuda::memory_order_relaxed);
  Word(words[1]).store(static_cast<unsigned long long>(__double_as_longlong(value.z2)) ^ kPublished,
                       cuda::memory_order_relaxed);
}

__device__ __forceinline__ double decode(unsigned long long word) {
  return __longlong_as_double(static_cast<long long>(word ^ kPublished));
}

// Warp 0: the state entering tile `b` of a row, from the tiles before it.
// Lane l reads the status pairs of tile last - l, waiting until one of its
// pairs is whole; the lanes up to the nearest inclusive prefix contribute
// A^(kTile * d) times their value, d = b - 1 - (last - l) being the tile's
// distance, applied one bit of d at a time.
__device__ __forceinline__ State look_back(unsigned long long* aggregates,
                                           unsigned long long* prefixes, long long row_base,
                                           long long b, const Powers& pw, int lane) {
  State carry = {0.0, 0.0};
  for (long long last = b - 1;; last -= 32) {
    const long long j = row_base + last - lane;
    // before tile 0: a prefix of zero
    unsigned long long p0 = kPublished, p1 = kPublished, a0 = 0, a1 = 0;
    if (j >= row_base) {
      do {
        p0 = Word(prefixes[2 * j]).load(cuda::memory_order_relaxed);
        p1 = Word(prefixes[2 * j + 1]).load(cuda::memory_order_relaxed);
        a0 = Word(aggregates[2 * j]).load(cuda::memory_order_relaxed);
        a1 = Word(aggregates[2 * j + 1]).load(cuda::memory_order_relaxed);
      } while (!((p0 && p1) || (a0 && a1)));
    }
    const bool is_prefix = p0 && p1;
    const unsigned stops = __ballot_sync(kFull, is_prefix);
    const int stop = stops ? __ffs(stops) - 1 : 31;  // the nearest prefix
    State term = {0.0, 0.0};
    if (lane <= stop && j >= row_base) {
      const State value = is_prefix ? State{decode(p0), decode(p1)} : State{decode(a0), decode(a1)};
      const unsigned distance = static_cast<unsigned>(b - 1 - last + lane);
      term = apply_power<kTileLog, kDistanceBits>(pw, distance, value);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      term.z1 += __shfl_xor_sync(kFull, term.z1, d);
      term.z2 += __shfl_xor_sync(kFull, term.z2, d);
    }
    carry = carry + term;
    if (stops) return carry;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sos_scan_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, long long tiles,
                    double b0, double c1, double c2, double a1, double a2, Powers pw,
                    unsigned long long* aggregates, unsigned long long* prefixes,
                    unsigned long long* counter) {
  __shared__ T buf[kTile + kThreads];
  __shared__ State warp_state[kWarps];
  __shared__ long long tile_id;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) tile_id = static_cast<long long>(atomicAdd(counter, 1ULL));
  __syncthreads();
  const long long row = tile_id / tiles;
  const long long b = tile_id % tiles;
  const long long k0 = b * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - k0));
  load_each<kThreads>(x + row * n + k0, len, [&](int m, T v) { buf[slot(m)] = v; });
  __syncthreads();

  // this thread's run, scanned from a zero state: s <- A s + (c1, c2) x
  const int j0 = tid * kRun;
  const int count = max(0, min(kRun, len - j0));
  State s = {0.0, 0.0};
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (r < count) {
      const double xi = static_cast<double>(buf[slot(j0 + r)]);
      s = {s.z2 - a1 * s.z1 + c1 * xi, c2 * xi - a2 * s.z1};
    }
  }

  // combine the runs within the warp, then the warps within the tile
  State inclusive = s;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const State other = shfl_up(inclusive, 1 << k);
    if (lane >= (1 << k)) inclusive = affine(pw.p[k], other, inclusive);
  }
  State exclusive = shfl_up(inclusive, 1);
  if (lane == 0) exclusive = {0.0, 0.0};
  if (lane == 31) warp_state[warp] = inclusive;
  __syncthreads();

  if (warp == 0) {
    State w = lane < kWarps ? warp_state[lane] : State{0.0, 0.0};
#pragma unroll
    for (int k = 0; k < kWarpsLog; ++k) {
      const State other = shfl_up(w, 1 << k);
      if (lane >= (1 << k)) w = affine(pw.p[5 + k], other, w);
    }
    const State aggregate = shfl(w, kWarps - 1);  // the tile from zero
    State before = shfl_up(w, 1);
    if (lane == 0) before = {0.0, 0.0};
    const long long row_base = row * tiles;
    State carry = {0.0, 0.0};
    if (b == 0) {
      if (lane == 0) publish(prefixes + 2 * row_base, aggregate);
    } else {
      if (lane == 0) publish(aggregates + 2 * (row_base + b), aggregate);
      carry = look_back(aggregates, prefixes, row_base, b, pw, lane);
      if (lane == 0) publish(prefixes + 2 * (row_base + b), affine(pw.p[kTileLog], carry, aggregate));
    }
    __syncwarp();
    // the state entering each warp
    if (lane < kWarps) warp_state[lane] = before + apply_power<5, kWarpsLog>(pw, lane, carry);
  }
  __syncthreads();

  // rescan the run from its carried-in state, writing y over x in place
  s = exclusive + apply_power<0, 5>(pw, lane, warp_state[warp]);
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (r < count) {
      const double xi = static_cast<double>(buf[slot(j0 + r)]);
      buf[slot(j0 + r)] = static_cast<T>(b0 * xi + s.z1);
      s = {s.z2 - a1 * s.z1 + c1 * xi, c2 * xi - a2 * s.z1};
    }
  }
  __syncthreads();
  store_each<kThreads>(y + row * n + k0, len, [&](int m) { return buf[slot(m)]; });
}

template <typename T>
int sos_scan(const T* x, T* y, long long rows, long long n, double b0, double b1, double b2,
             double a1, double a2, const double* powers, void* scratch, cudaStream_t stream) {
  const long long tiles = ceil_div(n, kTile);
  const long long total = rows * tiles;
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Powers pw;
  static_assert(sizeof pw == kPowers * 8 * sizeof(double), "packed powers");
  std::memcpy(&pw, powers, sizeof pw);
  auto* aggregates = static_cast<unsigned long long*>(scratch);
  unsigned long long* prefixes = aggregates + 2 * total;
  unsigned long long* counter = prefixes + 2 * total;
  sos_scan_kernel<T><<<static_cast<unsigned>(total), kThreads, 0, stream>>>(
      x, y, n, tiles, b0, b1 - a1 * b0, b2 - a2 * b0, a1, a2, pw, aggregates, prefixes,
      counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mtpu_sos_run() { return kRun; }

int mtpu_sos_tile() { return kTile; }

int mtpu_sos_powers() { return kPowers; }

// `powers`: host array of kPowers matrices A^(kRun * 2^k), each as 8
// float64: the row-major entries rounded (hi), then what they leave (lo).
// `scratch`: 4 * rows * ceil(n / kTile) + 1 zeroed 8-byte words (aggregate
// pairs, inclusive-prefix pairs, tile counter).
int mtpu_sos_f32(const void* x, void* y, long long rows, long long n, double b0, double b1,
                 double b2, double a1, double a2, const void* powers, void* scratch,
                 void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return sos_scan(static_cast<const float*>(x), static_cast<float*>(y), rows, n, b0, b1, b2, a1,
                  a2, static_cast<const double*>(powers), scratch,
                  static_cast<cudaStream_t>(stream));
}

int mtpu_sos_f64(const void* x, void* y, long long rows, long long n, double b0, double b1,
                 double b2, double a1, double a2, const void* powers, void* scratch,
                 void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return sos_scan(static_cast<const double*>(x), static_cast<double*>(y), rows, n, b0, b1, b2,
                  a1, a2, static_cast<const double*>(powers), scratch,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
