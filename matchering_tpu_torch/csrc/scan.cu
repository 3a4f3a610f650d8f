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
// 63.5 MB per call at n = 7,938,000 in float32, 19.0 us at 3.35 TB/s.
//
// Design: one launch per call, a single-pass scan with decoupled look-back
// (Merrill & Garland, NVIDIA NVR-2016-002).
//   * A block owns a tile of kTile = kThreads * kRun consecutive scan
//     positions (256 threads x 16 = 4096; 1,938 tiles at n = 7,938,000).  It
//     loads the tile with 16-byte vector loads (float4 / double2,
//     consecutive threads on consecutive addresses) into shared memory,
//     mirrored in place for `reverse`.
//   * Each thread scans its own run of kRun consecutive positions out of
//     shared memory from a zero state.  The layout pads one element after
//     every run, so the 32 threads of a warp, reading the same step of
//     their runs, hit 32 different banks.
//   * A span of L samples composes as s <- s_span + p^L * s_before, so only
//     the state travels: a warp-shuffle scan combines the threads' end
//     states with p^(kRun*2^k), a second one in warp 0 combines the warps'
//     with p^(kRun*32*2^k), and look-back combines the tiles with p^kTile.
//     The powers p^(kRun*2^k), k < kPowers, are computed on the host in
//     float64 (each one pow() call, not repeated squaring) and passed in.
//   * Look-back: warp 0 reads the status of the 32 tiles before its own,
//     sums their aggregates up to the nearest inclusive prefix, and steps
//     32 tiles further back where there is none.
//   * Each thread then rescans its run from its carried-in state and
//     writes y into shared memory, and the block stores the tile with
//     16-byte vector stores.  x is read from device memory once, y written
//     once; the only other traffic is 2 x 8 bytes of status per tile.
// Launches per call: 1, after the wrapper's zeroing of the status array.
//
// What holds it above its bound: tools_torch_scan_trace.py stamps every
// tile's phases and times variants of this file (numbers in PERF.md).  A
// block spends the longest part of its life loading its tile; some block
// loads or stores nearly all the time, yet the bytes move at about half the
// memory's rate, so each block's serial load -> scan -> store keeps too few
// bytes in flight.  The look-back's wait is the smaller part: a copy with
// no carry between tiles (and so a wrong output) is about a sixth faster.
// Smaller tiles (8 per thread) and larger ones (512 threads) are slower.
//
// Trouble spots:
//   * Forward progress.  Blocks are scheduled in no order, so a block that
//     waited on a tile whose block was never scheduled would hang the card.
//     The tile index is therefore taken from an atomicAdd on a zeroed
//     counter, not from blockIdx.x: a block only ever waits on tiles whose
//     indices were handed out before its own, to blocks already running,
//     which themselves wait only on earlier indices.
//   * Memory order.  A float64 value and a flag do not fit in one 64-bit
//     word, so the value is its own flag: a status word holds the value's
//     bits XOR kPublished, a NaN payload that no float64 operation returns,
//     so a published word is never zero and an unpublished one always is.
//     Each tile has two such words (aggregate, inclusive prefix), each
//     stored and loaded whole with one relaxed 64-bit atomic
//     (cuda::atomic_ref at device scope): no read can be torn, and no
//     release or acquire fence is needed (with a flag word and a release
//     store, each publication cost a device-scope fence on the block's
//     critical path).
//   * Results are not bit-stable across runs.  Which predecessors a tile
//     combines before it meets an inclusive prefix depends on timing, so
//     the float64 carry can differ in its last bits from run to run.  The
//     float32 output stays within one float32 ulp of the plain twin; no
//     bit-identical output is promised.
//   * Rows.  Tile indices run row-major over (row, tile); tile 0 of a row
//     publishes its prefix at once (its carry-in is zero, zi enters at its
//     first sample), so look-back never crosses into the previous row.
//   * Ragged edges.  The last tile of a row may be short, and its last
//     thread's run too; the threads past the end scan nothing, and as no
//     tile follows the last one, the factors that assume full runs only
//     reach states that are never used.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "vec.cuh"

namespace {

constexpr int kRun = 16;                    // consecutive scan positions per thread
constexpr int kTileLog = 8;                 // 2^kTileLog threads per block
constexpr int kThreads = 1 << kTileLog;
constexpr int kWarpsLog = kTileLog - 5;
constexpr int kWarps = 1 << kWarpsLog;
constexpr int kTile = kRun * kThreads;      // 4096 scan positions per block
// p^(kRun * 2^k) for k < kPowers: shuffles (k < 5), warps (k < kTileLog), tiles
// (kTileLog <= k < kTileLog + 5) and a look-back step of 32 tiles (the last)
constexpr int kPowers = kTileLog + 6;
// A status word is a float64's bits XOR kPublished: zero until published.
// kPublished is a NaN with a payload that no float64 operation returns (the
// card's arithmetic returns the canonical NaN), so no published value is zero.
constexpr unsigned long long kPublished = 0x7ff0000000000001ULL;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarpsLog >= 0 && kWarps <= 32, "warp 0 combines the warps");
static_assert((kTile + kThreads) * sizeof(double) <= 48 * 1024, "a tile fits static shared memory");

// Resident blocks per SM that the registers must allow: as many as the SM's
// 2048 threads and its shared memory (228 KB, 1 KB of it reserved per block)
// let in.  That is 8 for float32 I/O and 6 for float64, whose tile buffer is
// twice as large; asking for 8 there would cap the registers for nothing.
constexpr int min_blocks(size_t itemsize) {
  const size_t smem = (kTile + kThreads) * itemsize + kWarps * sizeof(double) + 1024;
  const int by_smem = static_cast<int>(228 * 1024 / smem);
  return by_smem < 2048 / kThreads ? by_smem : 2048 / kThreads;
}
static_assert(min_blocks(sizeof(float)) == 8 && min_blocks(sizeof(double)) == 6,
              "resident blocks per SM");

struct Powers {
  double p[kPowers];  // p[k] = pole^(kRun * 2^k)
};

using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// shared-memory slot of tile position j: one pad element after every run
__device__ __forceinline__ int slot(int j) { return j + j / kRun; }

// pole^(kRun * e * 2^First) for 0 <= e < 2^Bits, from the table
template <int First, int Bits>
__device__ __forceinline__ double power(const Powers& pw, int e) {
  double r = 1.0;
#pragma unroll
  for (int k = 0; k < Bits; ++k) {
    if ((e >> k) & 1) r *= pw.p[First + k];
  }
  return r;
}

__device__ __forceinline__ void publish(unsigned long long* word, double value) {
  Word(*word).store(static_cast<unsigned long long>(__double_as_longlong(value)) ^ kPublished,
                    cuda::memory_order_relaxed);
}

__device__ __forceinline__ double decode(unsigned long long word) {
  return __longlong_as_double(static_cast<long long>(word ^ kPublished));
}

// Warp 0: the state entering tile `b` of a row, from the tiles before it.
// Each step reads the status of the 32 tiles before `last` (lane l: tile
// last - l), waiting where a tile has published nothing yet, and sums the
// tiles up to the nearest inclusive prefix or, where there is none, all 32
// aggregates and steps back.
__device__ __forceinline__ double look_back(unsigned long long* aggregates,
                                            unsigned long long* prefixes, long long row_base,
                                            long long b, const Powers& pw, int lane) {
  const double weight = power<kTileLog, 5>(pw, lane);  // p^(kTile * lane)
  double carry = 0.0;
  double scale = 1.0;  // p^(kTile * (b - 1 - last))
  for (long long last = b - 1;; last -= 32) {
    const long long j = row_base + last - lane;
    unsigned long long prefix = kPublished;  // before tile 0: a prefix of zero
    unsigned long long aggregate = 0;
    if (j >= row_base) {
      do {
        prefix = Word(prefixes[j]).load(cuda::memory_order_relaxed);
        aggregate = Word(aggregates[j]).load(cuda::memory_order_relaxed);
      } while ((prefix | aggregate) == 0);
    }
    const unsigned stops = __ballot_sync(kFull, prefix != 0);
    const int stop = stops ? __ffs(stops) - 1 : 31;  // the nearest prefix
    double term = lane <= stop ? weight * decode(prefix ? prefix : aggregate) : 0.0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) term += __shfl_xor_sync(kFull, term, d);
    carry += scale * term;
    if (stops) return carry;
    scale *= pw.p[kTileLog + 5];  // p^(32 kTile)
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks(sizeof(T)))
    scan_kernel(const T* __restrict__ x, T* __restrict__ y, const double* __restrict__ zi,
                long long n, long long tiles, double b0, double b1, double pole, Powers pw,
                int reverse, unsigned long long* aggregates, unsigned long long* prefixes,
                unsigned long long* counter) {
  __shared__ T buf[kTile + kThreads];
  __shared__ double warp_state[kWarps];
  __shared__ long long tile_id;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) tile_id = static_cast<long long>(atomicAdd(counter, 1ULL));
  __syncthreads();
  const long long row = tile_id / tiles;
  const long long b = tile_id % tiles;
  const long long k0 = b * kTile;  // first scan position of the tile
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - k0));
  const long long lo = reverse ? n - k0 - len : k0;  // first sample in memory order
  const T* xr = x + row * n;
  // thread 0's inputs from outside the tile, fetched beside the tile itself:
  // x at the scan position before the tile, or zi at the row's first sample
  double prev = 0.0;  // x at the scan position before the thread's run
  double head = 0.0;  // added to the run's first drive
  if (tid == 0) {
    if (k0 > 0) {
      prev = static_cast<double>(xr[reverse ? n - k0 : k0 - 1]);
    } else if (zi) {
      head = zi[row];
    }
  }
  load_each<kThreads>(xr + lo, len, [&](int m, T v) { buf[slot(reverse ? len - 1 - m : m)] = v; });
  __syncthreads();

  // this thread's run, scanned from a zero state
  const int j0 = tid * kRun;
  const int count = max(0, min(kRun, len - j0));
  if (tid > 0 && count > 0) prev = static_cast<double>(buf[slot(j0 - 1)]);
  double s = 0.0;
  {
    double p = prev;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (r < count) {
        const double xi = static_cast<double>(buf[slot(j0 + r)]);
        double drive = b0 * xi + b1 * p;
        if (r == 0) drive += head;
        s = drive + pole * s;
        p = xi;
      }
    }
  }

  // combine the runs within the warp, then the warps within the tile
  double inclusive = s;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double other = __shfl_up_sync(kFull, inclusive, 1 << k);
    if (lane >= (1 << k)) inclusive += pw.p[k] * other;
  }
  double exclusive = __shfl_up_sync(kFull, inclusive, 1);
  if (lane == 0) exclusive = 0.0;
  if (lane == 31) warp_state[warp] = inclusive;
  __syncthreads();

  if (warp == 0) {
    double w = lane < kWarps ? warp_state[lane] : 0.0;
#pragma unroll
    for (int k = 0; k < kWarpsLog; ++k) {
      const double other = __shfl_up_sync(kFull, w, 1 << k);
      if (lane >= (1 << k)) w += pw.p[5 + k] * other;
    }
    const double aggregate = __shfl_sync(kFull, w, kWarps - 1);  // the tile from zero
    double before = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) before = 0.0;
    const long long row_base = row * tiles;
    double carry = 0.0;
    if (b == 0) {
      if (lane == 0) publish(prefixes + row_base, aggregate);
    } else {
      if (lane == 0) publish(aggregates + row_base + b, aggregate);
      carry = look_back(aggregates, prefixes, row_base, b, pw, lane);
      if (lane == 0) publish(prefixes + row_base + b, aggregate + pw.p[kTileLog] * carry);
    }
    __syncwarp();
    // the state entering each warp
    if (lane < kWarps) warp_state[lane] = before + power<5, kWarpsLog>(pw, lane) * carry;
  }
  __syncthreads();

  // rescan the run from its carried-in state, writing y over x in place
  {
    s = exclusive + power<0, 5>(pw, lane) * warp_state[warp];
    double p = prev;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (r < count) {
        const double xi = static_cast<double>(buf[slot(j0 + r)]);
        double drive = b0 * xi + b1 * p;
        if (r == 0) drive += head;
        s = drive + pole * s;
        p = xi;
        buf[slot(j0 + r)] = static_cast<T>(s);
      }
    }
  }
  __syncthreads();
  store_each<kThreads>(y + row * n + lo, len,
                       [&](int m) { return buf[slot(reverse ? len - 1 - m : m)]; });
}

template <typename T>
int scan(const T* x, T* y, const double* zi, long long rows, long long n, double b0,
         double b1, double pole, const double* powers, int reverse, void* scratch,
         cudaStream_t stream) {
  const long long tiles = ceil_div(n, kTile);
  const long long total = rows * tiles;
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Powers pw;
  std::memcpy(pw.p, powers, sizeof pw.p);
  auto* aggregates = static_cast<unsigned long long*>(scratch);
  unsigned long long* prefixes = aggregates + total;
  unsigned long long* counter = prefixes + total;
  scan_kernel<T><<<static_cast<unsigned>(total), kThreads, 0, stream>>>(
      x, y, zi, n, tiles, b0, b1, pole, pw, reverse, aggregates, prefixes, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mtpu_scan_run() { return kRun; }

int mtpu_scan_tile() { return kTile; }

int mtpu_scan_powers() { return kPowers; }

// `powers`: host array of kPowers float64, pole^(kRun * 2^k).  `scratch`:
// 2 * rows * ceil(n / kTile) + 1 zeroed 8-byte words (aggregates, inclusive
// prefixes, tile counter).
int mtpu_scan_f32(const void* x, void* y, const void* zi, long long rows, long long n,
                  double b0, double b1, double a1, int reverse, const void* powers,
                  void* scratch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return scan(static_cast<const float*>(x), static_cast<float*>(y),
              static_cast<const double*>(zi), rows, n, b0, b1, -a1,
              static_cast<const double*>(powers), reverse, scratch,
              static_cast<cudaStream_t>(stream));
}

int mtpu_scan_f64(const void* x, void* y, const void* zi, long long rows, long long n,
                  double b0, double b1, double a1, int reverse, const void* powers,
                  void* scratch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return scan(static_cast<const double*>(x), static_cast<double*>(y),
              static_cast<const double*>(zi), rows, n, b0, b1, -a1,
              static_cast<const double*>(powers), reverse, scratch,
              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
