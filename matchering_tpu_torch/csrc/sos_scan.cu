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
// 63.5 MB per call at n = 7,938,000 in float32, 19.0 us at 3.35 TB/s.  Its
// float64 instructions, counted per sample (a compensated combine, `affine`,
// is 46 of them, issued by a whole warp):
//   * the run from a zero state, for the tile's aggregate: 4 fma;
//   * the run again from its carried-in state, with y: 4 fma + 1 mul;
//   * warp 0's 12 combines a tile (3 + 5 + 1 + 3, below): 12 * 46 * 32 /
//     4096 = 4.3;
//   * look-back, one step a tile (below), whose reads reach gridDim.x
//     tiles back: in float32 on an H100 (528 blocks) each thread 4 or 5
//     combines, so 17 warp-combines, and a 32-lane sum (10 adds) in each
//     of the 4 warps, (17 * 46 + 40) * 32 / 4096 = 6.4; in float64 (264
//     blocks) 2 or 3 combines, 9 warp-combines, (9 * 46 + 40) * 32 / 4096
//     = 3.5;
// about 19.7 a sample in float32 (16.9 in float64), 157 M per float32
// call of n = 7,938,000: 9.4 us at the FP64 pipe's ~16.7 T
// instructions/s (132 SMs x 64 lanes x ~1.98 GHz), plus 3 float32 <->
// float64 conversions a sample (16 a clock per SM): ~5.7 us.  Both lie
// under the byte bound; what the design spends instructions on is latency:
// a tile's carry waits on every tile before it, so the kernel keeps a
// tile's aggregate ahead of the tiles that wait on it.
//
// Design: one launch per call, a single-pass scan with decoupled look-back
// (Merrill & Garland, NVIDIA NVR-2016-002), in a persistent, pipelined loop.
//   * The grid holds as many blocks as are resident at once (the wrapper
//     sizes it from the occupancy query `mtpu_sos_info`; the launch is
//     cooperative, so the card runs them all at once or refuses it).  Each
//     block stages the host's power tables into shared memory once, then
//     loops over tiles of kTile = kThreads * kRun = 128 x 32 samples, tile
//     blockIdx.x and every gridDim.x-th after it, through a ring of 2 tile
//     buffers in dynamic shared memory that 16-byte cp.async copies fill
//     an iteration ahead of the scan.  Tiles are not taken
//     from an atomic counter: a block would then hold prefetched tiles
//     taken before other blocks' current ones, whose aggregates wait on its
//     own look-back (tools_torch_scan_trace.py measured a median look-back
//     of 28 us a tile that way).
//   * A tile's 16-byte chunks sit in shared memory XOR-swizzled within each
//     thread's run, so the threads of a quarter-warp, each reading the same
//     chunk of its own run, hit 8 different bank groups.
//   * An iteration on tile i first takes the aggregate of the block's next
//     tile, i + gridDim.x: each thread scans its run of kRun samples from a
//     zero state, and warp 0 combines the runs: lane l chains the end
//     states of threads 4l..4l+3 (3 combines with A^kRun), the lanes scan
//     their chunks of 128 samples (5 combines, Kogge-Stone with
//     A^(128 * 2^k)), lane 31 publishes the aggregate, and each lane keeps
//     its chain in shared memory for the next iteration.  So when tile i
//     looks back, the tiles between it and the block's own previous tile
//     published their aggregates an iteration ago, and the look-back does
//     not wait on their blocks' look-backs (a median of 5-6 us a tile when
//     each tile took its own aggregate first).
//   * Then tile i looks back for its carry (below), each lane of warp 0
//     forms the state at the end of its chunk (1 combine with
//     A^(128 (l + 1)); lane 31's is the tile's inclusive prefix, published)
//     and the states entering its 4 threads (3 combines with A^(kRun k)),
//     and each thread rescans its run from its entering state, writing y
//     over x in the buffer, which the block stores with 16-byte stores.
//     Every power comes from a host table indexed by the lane or the
//     distance, one combine each.
//   * Look-back, by all 4 warps, kWindow = 640 tiles a step: thread t reads
//     the status of tiles last - t - 128 k, k < 5, sums those up to the
//     nearest inclusive prefix Horner-wise with A^(128 kTile), and applies
//     A^(kTile t); the block sums the threads, and where there is no
//     prefix it steps 640 tiles back (that step's sum then takes
//     A^(640 kTile) once per step).  A block's own previous tile lies
//     gridDim.x (528 in float32, 264 in float64) tiles back and published
//     its prefix before the block took its next, so one step always
//     reaches a prefix (walks of 32 and 128 tiles a step took 3 and 1-2
//     steps), and the tiles beyond it are not read.
// Launches per call: 1 (cooperative), after the wrapper's zeroing of the
// status array.
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
//     card: the host multiplies the powers out at 50 decimal digits
//     (kernels/sos.py), exact to about 32.
//   * Forward progress: a tile only waits on tiles before it, and a block
//     processes its tiles in increasing order, so the earliest unfinished
//     tile is always the one its block is processing; every block is
//     resident (the cooperative launch), so that tile progresses.
//   * Publishing a 2-vector: each state word is a float64's bits XOR
//     kPublished (a NaN payload no float64 operation returns), so a
//     published word is never zero.  A tile publishes its aggregate as two
//     words and later its inclusive prefix as two more, in one 32-byte
//     sector, each with one relaxed 64-bit atomic store.  A reader takes a pair only when both
//     of its words are non-zero; every word is written once, from zero to
//     its final value, so no pair can be read torn and no fence is needed.
//   * Alignment: x and y start on a 16-byte boundary (the wrapper copies
//     an input that does not).  A row whose start is not aligned (n not a
//     multiple of 4 in float32, of 2 in float64) is scanned from the
//     aligned address before it: its first tile begins that many samples
//     early, and they read as zero, which leaves the zero state unchanged.
//     A 16-byte chunk that reaches outside the row is loaded and stored one
//     sample at a time.  Each row then has ceil((n + V - 1) / kTile)
//     tiles (V samples in 16 bytes; ceil(n / kTile) where n is a multiple
//     of V); a row's last tile may hold no sample, and then does nothing
//     (no tile after it waits on it).
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

#include "info.cuh"
#include "trace.cuh"
#include "vec.cuh"

namespace {

constexpr int kRun = 32;                      // consecutive samples per thread
constexpr int kThreads = 128;
constexpr int kTile = kRun * kThreads;        // 4096 samples per tile
constexpr int kLaneStates = kThreads / 32;    // threads' end states per lane of warp 0
constexpr int kChunk = kRun * kLaneStates;    // samples per lane of warp 0
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 5;                     // tiles a thread reads in a look-back step
constexpr int kWindow = kDepth * kThreads;    // tiles a look-back step covers
// Tile buffers in a block's ring: this tile, and the next, whose aggregate
// is taken an iteration early from copies issued at the end of the
// iteration before.  (A third buffer, to issue them earlier, was no faster
// and costs float32 a resident block.)
constexpr int kStages = 2;
// Resident blocks per SM that the registers must allow: shared memory lets
// 4 in for float32 (2 for float64).
constexpr int kMinBlocks = 4;
constexpr unsigned long long kPublished = 0x7ff0000000000001ULL;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kLaneStates == 4 && kChunk * 32 == kTile, "warp 0's lanes cover the tile");

struct State {
  double z1, z2;
};

struct Power {     // a 2x2 matrix as hi + lo, each row-major
  double hi[4];
  double lo[4];
};

// The host's tables (kernels/sos.py: `section_tables`), in this order.
struct Tables {
  Power thread[kLaneStates - 1];  // A^(kRun k), k = 1..3
  Power lane[32];                 // A^(kChunk (l + 1)); the lane scan's A^(kChunk 2^k) is lane[2^k - 1]
  Power distance[kThreads];       // A^(kTile d), the identity first
  Power hop;                      // A^(kThreads kTile)
  Power step;                     // A^(kWindow kTile)
};
constexpr int kTableDoubles = sizeof(Tables) / sizeof(double);
static_assert(kTableDoubles == (kLaneStates - 1 + 32 + kThreads + 2) * 8, "packed tables");

struct Shared {
  Tables tables;
  State states[kThreads];   // each thread's run from a zero state
  State entry[kThreads];    // the state entering each thread's run
  State chains[2][kThreads];  // warp 0's chains of this tile and the next
  State terms[kWarps];      // look-back: each warp's sum
  int stop[kWarps];         // look-back: each warp's nearest inclusive prefix
};
constexpr int kRingOffset = (sizeof(Shared) + 127) / 128 * 128;

template <typename T>
constexpr int shared_bytes() {
  return kRingOffset + kStages * kTile * static_cast<int>(sizeof(T));
}

using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// the 16-byte chunk of shared memory that holds chunk q of a tile: chunk
// j of thread t's run sits at j XOR (t mod 8) within the run
template <typename T>
__device__ __forceinline__ int chunk_slot(int q) {
  constexpr int kChunks = kRun * static_cast<int>(sizeof(T)) / 16;  // per run: 8 or 16
  static_assert(kChunks >= 8, "the swizzle spans 8 chunks");
  const int t = q / kChunks;
  return t * kChunks + ((q % kChunks) ^ (t & 7));
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ State operator+(State a, State b) { return {a.z1 + b.z1, a.z2 + b.z2}; }

__device__ __forceinline__ State shfl_up(State s, int delta) {
  return {__shfl_up_sync(kFull, s.z1, delta), __shfl_up_sync(kFull, s.z2, delta)};
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

// add + M v, off by about one rounding of the result
__device__ __forceinline__ State affine(const Power& m, State v, State add) {
  return {affine_row(m.hi, m.lo, v, add.z1), affine_row(m.hi + 2, m.lo + 2, v, add.z2)};
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

// The whole block: the state entering tile `b` of a row, from the tiles
// before it.  A step reads the kWindow tiles before `last`: thread t the
// status pairs of tiles last - t - kThreads k, k < kDepth, waiting until one
// pair of each is whole.  The tiles up to the nearest inclusive prefix
// count: thread t sums its own Horner-wise with A^(kThreads kTile) and
// applies A^(kTile t) (the state leaving tile last - t enters tile b after
// t more tiles, within the step), the block sums the threads, and a step
// further back takes A^(kWindow kTile) once more.  Every thread returns
// the carry.
__device__ __forceinline__ State look_back(unsigned long long* status, long long row_base,
                                           long long b, Shared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr unsigned kAll = (1u << kDepth) - 1;
  State carry = {0.0, 0.0};
  for (long long last = b - 1, steps = 0;; last -= kWindow, ++steps) {
    State value[kDepth];
    unsigned whole = 0, prefix = 0;  // bit k: tile k's pair read whole; an inclusive prefix
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      value[k] = State{0.0, 0.0};
      if (last - tid - k * kThreads < 0) {  // before tile 0: a prefix of zero
        whole |= 1u << k;
        prefix |= 1u << k;
      } else if (tid + k * kThreads >= gridDim.x) {
        whole |= 1u << k;  // never reached: the block's own previous tile is nearer
      }
    }
    while (whole != kAll) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (!((whole >> k) & 1)) {
          const long long j = row_base + last - tid - k * kThreads;
          const unsigned long long a0 = Word(status[4 * j]).load(cuda::memory_order_relaxed);
          const unsigned long long a1 = Word(status[4 * j + 1]).load(cuda::memory_order_relaxed);
          const unsigned long long p0 = Word(status[4 * j + 2]).load(cuda::memory_order_relaxed);
          const unsigned long long p1 = Word(status[4 * j + 3]).load(cuda::memory_order_relaxed);
          if (p0 && p1) {
            value[k] = State{decode(p0), decode(p1)};
            whole |= 1u << k;
            prefix |= 1u << k;
          } else if (a0 && a1) {
            value[k] = State{decode(a0), decode(a1)};
            whole |= 1u << k;
          }
        }
      }
    }
    // the nearest inclusive prefix: position kThreads k + t of the step
    const int mine = prefix ? (__ffs(prefix) - 1) * kThreads + tid : kWindow;
    const int nearest = __reduce_min_sync(kFull, mine);
    if (lane == 0) sh.stop[warp] = nearest;
    __syncthreads();
    int stop = kWindow;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) stop = min(stop, sh.stop[w]);
    State term = {0.0, 0.0};
    bool any = false;
#pragma unroll
    for (int k = kDepth - 1; k >= 0; --k) {
      if (k * kThreads + tid <= stop) {
        term = any ? affine(sh.tables.hop, term, value[k]) : value[k];
        any = true;
      }
    }
    if (any) term = affine(sh.tables.distance[tid], term, State{0.0, 0.0});
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      term.z1 += __shfl_xor_sync(kFull, term.z1, d);
      term.z2 += __shfl_xor_sync(kFull, term.z2, d);
    }
    if (lane == 0) sh.terms[warp] = term;
    __syncthreads();
    State sum = sh.terms[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = sum + sh.terms[w];
    for (long long k = 0; k < steps; ++k) sum = affine(sh.tables.step, sum, State{0.0, 0.0});
    carry = carry + sum;
    if (stop < kWindow) {
      if (tid == 0) TRACE_WORD(row_base + b, 6, steps + 1);
      return carry;
    }
  }
}

// A tile of a row: the offset in x and y of its first position, `start`
// (16-byte aligned; before the row by the row's misalignment in its first
// tile), and its samples of the row, [first, end) counted from `start`.
struct Span {
  long long start;
  int first, end;
};

template <typename T>
__device__ __forceinline__ Span tile_span(long long row, long long b, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long origin = b * kTile - (row * n) % V;  // the tile's first position in the row
  return {row * n + origin, static_cast<int>(max(0LL, -origin)),
          static_cast<int>(min(static_cast<long long>(kTile), n - origin))};
}

// Issue the copies of a tile into `buf`: whole 16-byte chunks of the row
// asynchronously, the chunks that reach outside it one sample at a time
// (zero outside the row).  Every thread commits one group, copies or not.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, long long id, long long tiles,
                                          long long total, long long n, T* buf) {
  constexpr int V = 16 / sizeof(T);
  if (id < total) {
    const Span span = tile_span<T>(id / tiles, id % tiles, n);
    for (int q = threadIdx.x; q < kTile / V; q += kThreads) {
      const int p = q * V;
      T* dst = buf + chunk_slot<T>(q) * V;
      if (p >= span.first && p + V <= span.end) {
        copy_async16(dst, x + span.start + p);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          dst[e] = p + e >= span.first && p + e < span.end ? x[span.start + p + e] : T(0);
        }
      }
    }
  }
  commit_copies();
}

// Thread t's run of the tile in `chunks` from the state `s`: the run's end
// state, and with kOutputs each y = b0 x + z1 written over its x.
template <typename T, bool kOutputs>
__device__ __forceinline__ State scan_run(typename Vec<T>::type* chunks, State s, double b0,
                                          double c1, double c2, double a1, double a2) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = kRun / V;  // 16-byte chunks per run
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    VT v = chunks[t * kChunks + (j ^ (t & 7))];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const double xi = static_cast<double>(e[k]);
      if constexpr (kOutputs) e[k] = static_cast<T>(fma(b0, xi, s.z1));
      const double z1 = fma(c1, xi, s.z2);
      s.z2 = fma(-a2, s.z1, c2 * xi);
      s.z1 = fma(-a1, s.z1, z1);
    }
    if constexpr (kOutputs) chunks[t * kChunks + (j ^ (t & 7))] = v;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sos_scan_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, long long tiles,
                    long long total, double b0, double c1, double c2, double a1, double a2,
                    const double* __restrict__ table, unsigned long long* status) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  T* ring = reinterpret_cast<T*>(smem + kRingOffset);
  const Tables& tb = sh.tables;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long grid = gridDim.x;

  // A tile's aggregate, one iteration before its look-back: its runs from
  // a zero state, then warp 0's chains (lane l: threads kLaneStates l + k)
  // and lane scan; lane 31 publishes the tile from zero (a row's first
  // tile: its prefix), and lane l keeps its chain in `chain`.
  auto aggregate = [&](long long id, T* buf, State* chain) {
    if (id >= total) return;
    const Span span = tile_span<T>(id / tiles, id % tiles, n);
    if (span.first >= span.end) return;
    sh.states[tid] = scan_run<T, false>(reinterpret_cast<VT*>(buf), State{0.0, 0.0}, b0, c1, c2,
                                        a1, a2);
    __syncthreads();
    if (warp == 0) {
      State c[kLaneStates];
      c[0] = sh.states[kLaneStates * lane];
#pragma unroll
      for (int k = 1; k < kLaneStates; ++k) {
        c[k] = affine(tb.thread[0], c[k - 1], sh.states[kLaneStates * lane + k]);
      }
      State g = c[kLaneStates - 1];  // the tile from zero to the end of the lane's chunk
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const State other = shfl_up(g, 1 << k);
        if (lane >= (1 << k)) g = affine(tb.lane[(1 << k) - 1], other, g);
      }
      if (lane == 31) publish(status + 4 * id + (id % tiles == 0 ? 2 : 0), g);
#pragma unroll
      for (int k = 0; k < kLaneStates - 1; ++k) chain[kLaneStates * lane + k] = c[k];
      chain[kLaneStates * lane + kLaneStates - 1] = g;
    }
  };

  for (int i = tid; i < kTableDoubles; i += kThreads) {
    reinterpret_cast<double*>(&sh.tables)[i] = table[i];
  }
  // the block's tiles: blockIdx.x, then every gridDim.x-th after it
  for (int s = 0; s < kStages; ++s) {
    load_tile(x, blockIdx.x + s * grid, tiles, total, n, ring + s * kTile);
  }
  wait_copies<kStages - 1>();
  __syncthreads();
  aggregate(blockIdx.x, ring, sh.chains[0]);

  int stage = 0;
  int parity = 0;
  for (long long id = blockIdx.x; id < total; id += grid) {
    T* buf = ring + stage * kTile;
    VT* chunks = reinterpret_cast<VT*>(buf);
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    TRACE_STAMP(id, 0);
    TRACE_SM(id);
    wait_copies<kStages - 2>();  // this thread's copies of the next tile
    __syncthreads();       // everyone's
    TRACE_STAMP(id, 1);
    aggregate(id + grid, ring + next * kTile, sh.chains[parity ^ 1]);
    TRACE_STAMP(id, 2);
    const long long row = id / tiles;
    const long long b = id % tiles;
    const Span span = tile_span<T>(row, b, n);

    if (span.first < span.end) {
      State carry = {0.0, 0.0};
      if (b > 0) carry = look_back(status, row * tiles, b, sh);
      if (warp == 0) {
        const State* chain = sh.chains[parity];
        const State g = chain[kLaneStates * lane + kLaneStates - 1];
        State f = g;  // the state at the end of the lane's chunk
        if (b > 0) {
          f = affine(tb.lane[lane], carry, g);
          if (lane == 31) publish(status + 4 * id + 2, f);
        }
        State enter = shfl_up(f, 1);
        if (lane == 0) enter = carry;
        sh.entry[kLaneStates * lane] = enter;
#pragma unroll
        for (int k = 1; k < kLaneStates; ++k) {
          sh.entry[kLaneStates * lane + k] =
              affine(tb.thread[k - 1], enter, chain[kLaneStates * lane + k - 1]);
        }
      }
      __syncthreads();
      TRACE_STAMP(id, 3);

      // the run rescanned from the state entering it, y written over x
      scan_run<T, true>(chunks, sh.entry[tid], b0, c1, c2, a1, a2);
      __syncthreads();
      for (int q = tid; q < kTile / V; q += kThreads) {
        const int p = q * V;
        const int slot = chunk_slot<T>(q);
        if (p >= span.first && p + V <= span.end) {
          *reinterpret_cast<VT*>(y + span.start + p) = chunks[slot];
        } else {
          for (int e = 0; e < V; ++e) {
            if (p + e >= span.first && p + e < span.end) y[span.start + p + e] = buf[slot * V + e];
          }
        }
      }
      TRACE_STAMP(id, 4);
    }
    __syncthreads();  // the buffer is free
    load_tile(x, id + kStages * grid, tiles, total, n, buf);
    stage = next;
    parity ^= 1;
  }
}

template <typename T>
int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      sos_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes<T>()));
}

template <typename T>
int info(long long* out) {
  const int err = prepare<T>();
  return err ? err : kernel_info(sos_scan_kernel<T>, kThreads, shared_bytes<T>(), out);
}

template <typename T>
int sos_scan(const T* x, T* y, long long rows, long long n, double b0, double b1, double b2,
             double a1, double a2, const double* table, long long grid, void* scratch,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 || grid <= 0 ||
      grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long tiles = ceil_div(n + (n % V ? V - 1 : 0), kTile);  // sos.tiles_per_row
  long long total = rows * tiles;
  const int err = prepare<T>();
  if (err) return err;
  auto* status = static_cast<unsigned long long*>(scratch);
  double c1 = b1 - a1 * b0;
  double c2 = b2 - a2 * b0;
  // a cooperative launch: every block resident at once, or a refused launch
  void* args[] = {&x, &y, &n, &tiles, &total, &b0, &c1, &c2, &a1, &a2, &table, &status};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sos_scan_kernel<T>), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, shared_bytes<T>(), stream);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mtpu_sos_run() { return kRun; }

int mtpu_sos_tile() { return kTile; }

int mtpu_sos_stages() { return kStages; }

int mtpu_sos_table_doubles() { return kTableDoubles; }

int mtpu_sos_shared_head() { return kRingOffset; }

// the launch (csrc/info.cuh): registers, shared memory, resident blocks
int mtpu_sos_info(int f64, long long* out) { return f64 ? info<double>(out) : info<float>(out); }

// `table`: the device copy of the host's kTableDoubles float64 (kernels/sos.py,
// `section_tables`).  `grid`: blocks, at most those resident at once.
// `scratch`: 4 * rows * sos.tiles_per_row(n) zeroed 8-byte words, a
// tile's status in 32 bytes (its aggregate pair, then its inclusive-prefix
// pair).  x and y start on 16-byte boundaries.
int mtpu_sos_f32(const void* x, void* y, long long rows, long long n, double b0, double b1,
                 double b2, double a1, double a2, const void* table, long long grid, void* scratch,
                 void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return sos_scan(static_cast<const float*>(x), static_cast<float*>(y), rows, n, b0, b1, b2, a1,
                  a2, static_cast<const double*>(table), grid, scratch,
                  static_cast<cudaStream_t>(stream));
}

int mtpu_sos_f64(const void* x, void* y, long long rows, long long n, double b0, double b1,
                 double b2, double a1, double a2, const void* table, long long grid, void* scratch,
                 void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  return sos_scan(static_cast<const double*>(x), static_cast<double*>(y), rows, n, b0, b1, b2,
                  a1, a2, static_cast<const double*>(table), grid, scratch,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
