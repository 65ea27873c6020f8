// A segmented sum in one fixed order, for NVIDIA Hopper (sm_90a): K3,
// the backward of the port's many-to-one row gathers
// (ops/gather.py gather_rows: the winner's shade rows, the texels).
// Not a TPU kernel: it replaces index_add_, whose float atomics add a
// row's cotangents in whatever order the lanes arrive, so that a train
// step's gradients are the same from run to run.
//
// Contract: out[r, :] = the sum of src[i, :] over the lanes i with
// idx[i] == r, for src [n, f] float32; 0 where no lane has r.  The
// order of the additions, which ops/gather.py segment_sum_plain performs
// too, so that the two agree bit for bit:
//   1. the lanes sorted by row, stably: position p holds lane order[p],
//      whose row is rows[p]; row r's lanes take the positions
//      [S_r, S_r + m_r), in lane order;
//   2. a pairwise tree over the positions, aligned at position 0: for
//      h = 1, 2, 4, ..., every node [a, a + 2h) with a a multiple of 2h
//      whose middle a + h falls inside a row (positions a + h - 1 and
//      a + h both of row r) adds the partial sum of r's lanes in the
//      right half, held at position a + h, to the partial sum of r's
//      lanes in the left half, held at position max(a, S_r): one
//      __fadd_rn;
//   3. out[r] is then the value held at S_r.
// The order depends only on the rows, not on the scheduling: every
// addition has one writer, and nothing adds in float atomics.
//
// What bounds it on this card: bytes.  It adds each cotangent once (one
// FP32 addition an element), so the least time is the cotangent rows
// read once, the gradient written once and the lanes' rows read once:
// chip_smoke.py's bound.
//
// The design, four launches: the wrapper's fill of `zeroed` (a ticket
// and arrival counters), then three kernels.  Measured in turns with the
// first design (torch.sort, then each chunk's pieces and each row's
// chunk sums added in order; chip_smoke.py phase 15 with --parent, PERF.md
// §6), each part below paid on the gathers of a train step.
// - sort_lanes: a stable LSD counting sort of the lanes by row, over
//   only the bits the rows need, in passes of at most kMaxBits (one pass
//   up to kMaxBins rows, the digit being the row itself).  Its blocks
//   take tickets in the order they start, and each pass is three phases:
//   count (a block per tile of kTileLanes lanes: each warp counts its
//   digits in 16-bit shared counters, a round of 32 lanes at a time by
//   __match_any_sync; pass 0 also checks the rows and zeroes `out`),
//   scan (a warp per digit: its count in the tiles before each tile, and
//   its total) and scatter (a block per tile: each lane's rank among the
//   tile's lanes of its digit, in lane order, from the warps before, the
//   rounds before and the lower lanes of its round; the words staged in
//   shared memory in the tile's sorted order, then written along each
//   digit's run of positions).  A block waits until every block of the
//   phase before has finished: those took earlier tickets, so they are
//   running or done, and the wait cannot deadlock.  A lane's sorted
//   position is a sum of integer counts, so the order is exact however
//   the blocks run.  The sorted lanes are 64-bit words, row << 32 | lane.
//   A warp's 8 rounds of keys are loaded at once; loading a round at a
//   time, and a decoupled look-back between tiles that all start
//   together, made the first drafts slower on the card.
// - reduce_rows: one block per chunk of kChunk positions.  Each thread
//   takes one column of a block of 8 positions (its 8 gathers in flight,
//   every thread's together) and runs the tree's steps h = 1, 2, 4 in
//   registers, from a word per block of 8 that says which nodes add and
//   where their left halves are held; steps 8..kChunk/2 run in shared
//   memory, a (node, column) a thread.  Cotangent rows come in column
//   slices of at most kSlice floats, at an odd shared-memory stride.  A
//   row that lies inside the chunk is complete and goes to out; the
//   chunk's first row, if it goes on past an edge of the chunk, leaves
//   its partial in the level's `first` slots, and its last row (if
//   another one) in `last`.
// - combine_levels: the steps above kChunk, in levels of kFanOut units.
//   Block b takes the chunks of level-1 unit b; the last block to finish
//   a unit's units (an integer arrival count) takes the unit above.  A
//   unit's rows that cross an edge between its units, or go on past its
//   own edges, are found a lane each, their partials staged in shared
//   memory with one load each, and each (row, column) is summed by one
//   thread, the tree's steps over up to kFanOut partials unrolled in
//   registers.  A long row (`random`'s ground sphere takes about half of
//   a bounce's 720,000 lanes) is thus summed by ~1,300 chunk blocks in
//   parallel, then 32 partials at a time per level, never by one block
//   alone.
// Waits spin on volatile loads with __nanosleep and trap after ~2^26
// rounds, so a fault ends the kernel instead of hanging the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a reduce block
constexpr int kWarps = kThreads / 32;
constexpr int kSortThreads = 1024;  // a sort block
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kTileLanes = 8192;  // lanes a sort block counts or scatters
constexpr int kWarpLanes = kTileLanes / kSortWarps;
constexpr int kRounds = kWarpLanes / 32;
constexpr int kScanRounds = 8;  // 256 tiles a scanning warp loads at once
constexpr int kMaxBits = 11;  // digit bits of a pass
constexpr int kMaxBins = 1 << kMaxBits;  // ops/gather.py ONE_PASS_ROWS
constexpr int kPer = kMaxBins / kSortThreads;  // digits a sort thread scans
constexpr int kChunk = 256;    // ops/gather.py CHUNK
constexpr int kFanOut = 32;    // ops/gather.py FAN_OUT
constexpr int kSlice = 31;     // columns a reduce block stages at once
constexpr int kBlocks = kChunk / 8;  // blocks of 8 positions a chunk has
// Blocks of 8 a reduce thread takes: kBlocks over kThreads / kSlice.
constexpr int kItems = (kBlocks + kThreads / kSlice - 1) / (kThreads / kSlice);
constexpr int kMaxLevels = 8;  // 2^31 positions: 2^23 chunks, 5 levels up
constexpr long long kSpins = 1ll << 26;
static_assert(kChunk == kThreads, "reduce_rows stages a position a thread");
static_assert(kFanOut == 32, "a level's units are found a lane each");

__device__ __forceinline__ void wait_count(const int* p, int target) {
  const volatile int* q = p;
  unsigned ns = 32;  // backing off, so that waiting blocks do not crowd
                     // the counter's L2 slice
  for (long long i = 0; *q < target; ++i) {
    if (i > kSpins) __trap();
    __nanosleep(ns);
    if (ns < 256) ns *= 2;
  }
  __threadfence();
}

struct SortArgs {
  const void* idx;  // [n] int64 (idx64) or int32, each in [0, n_rows)
  int idx64, n, n_rows, f;
  int passes, bits, bins, n_tiles, n_scans;
  int* ticket;      // zeroed
  int* done;        // [3 * passes] zeroed: blocks of each phase finished
  int* ghist;       // [passes, bins]: each digit's lanes
  int* offsets;     // [n_tiles, bins]: a tile's count of each digit, then
                    // the count of the digit in the tiles before
  // [n] (row << 32 | lane) by position: pass p writes words[p & 1], so
  // the last pass's are the sorted lanes
  unsigned long long* words[2];
  float* out;       // [n_rows, f], zeroed here
};

__device__ __forceinline__ int digit_of(const SortArgs& a, int key, int p) {
  return a.passes == 1 ? key : (key >> (p * a.bits)) & (a.bins - 1);
}

// A warp's share of a tile, kRounds rounds of 32 lanes, into registers:
// pass p's keys (and lanes), all loads in flight at once.
struct WarpLanes {
  int key[kRounds], lane[kRounds];
};

__device__ __forceinline__ void load_lanes(const SortArgs& a, int p, int wlo,
                                           int whi, WarpLanes& w) {
  const int lane = threadIdx.x & 31;
  if (p) {
    const unsigned long long* words = a.words[(p + 1) & 1];
    unsigned long long x[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = wlo + r * 32 + lane;
      x[r] = i < whi ? __ldcg(words + i) : ~0ull;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      w.key[r] = x[r] == ~0ull ? -1 : static_cast<int>(x[r] >> 32);
      w.lane[r] = static_cast<int>(x[r]);
    }
    return;
  }
  long long k[kRounds];
  if (a.idx64) {
    const long long* idx = static_cast<const long long*>(a.idx);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = wlo + r * 32 + lane;
      k[r] = i < whi ? idx[i] : -1;
    }
  } else {
    const int* idx = static_cast<const int*>(a.idx);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = wlo + r * 32 + lane;
      k[r] = i < whi ? idx[i] : -1;
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = wlo + r * 32 + lane;
    w.key[r] = i >= whi ? -1 : k[r] < 0 || k[r] >= a.n_rows
                                   ? -2
                                   : static_cast<int>(k[r]);
    w.lane[r] = i;
  }
}

// The warp's count of each digit of pass p into its row of `wh`
// (16-bit: a warp holds kWarpLanes lanes), in rounds of 32 lanes: the
// lanes of a round with the same digit (`peers`), the lowest of them
// adding their number.  The rounds' matches are independent, so all of
// them go out before any count is added.  One pass matches with
// __match_any_sync; several match by one ballot a bit of the digit, a
// fixed cost where __match_any_sync's grows with the distinct digits in
// the warp (most, on a texel gather's low bits; few on a winner
// gather's rows, where it is the faster).
__device__ __forceinline__ void warp_counts(const SortArgs& a, int p,
                                            const WarpLanes& w,
                                            unsigned short* mine,
                                            unsigned (&peers)[kRounds]) {
  const int lane = threadIdx.x & 31;
  int d[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    d[r] = w.key[r] >= 0 ? digit_of(a, w.key[r], p) : -1;
  if (a.passes == 1) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      peers[r] = __match_any_sync(0xffffffffu, d[r]);
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      peers[r] = __ballot_sync(0xffffffffu, d[r] >= 0);
    for (int b = 0; b < a.bits; ++b) {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const bool on = (d[r] >> b) & 1;
        const unsigned set = __ballot_sync(0xffffffffu, on);
        peers[r] &= on ? set : ~set;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (d[r] >= 0 && lane == __ffs(peers[r]) - 1)
      mine[d[r]] += __popc(peers[r]);
}

// Count phase of pass p: the tile's count of each digit, into offsets
// (every digit written).  Pass 0 also checks the rows and zeroes a share
// of out.
__device__ void count_tile(const SortArgs& a, int p, int tile,
                           unsigned short* wh) {
  const int tid = threadIdx.x, warp = tid >> 5, bins = a.bins;
  for (int i = tid; i < kSortWarps * bins; i += kSortThreads) wh[i] = 0;
  if (p == 0) {
    const long long n_out = static_cast<long long>(a.n_rows) * a.f;
    for (long long i = static_cast<long long>(tile) * kSortThreads + tid;
         i < n_out; i += static_cast<long long>(a.n_tiles) * kSortThreads)
      a.out[i] = 0.0f;
  }
  const int wlo = tile * kTileLanes + warp * kWarpLanes;
  WarpLanes w;
  load_lanes(a, p, wlo, min(wlo + kWarpLanes, a.n), w);
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (w.key[r] == -2) __trap();  // a row out of range
  __syncthreads();
  unsigned peers[kRounds];
  warp_counts(a, p, w, wh + warp * bins, peers);
  __syncthreads();
  int* mine = a.offsets + static_cast<long long>(tile) * bins;
  for (int d = tid; d < bins; d += kSortThreads) {
    int c = 0;
    for (int v = 0; v < kSortWarps; ++v) c += wh[v * bins + d];
    mine[d] = c;
  }
}

// start[d] = the sum of c over the digits before d, where thread t holds
// c for the digits t * kPer .. t * kPer + kPer - 1.
__device__ void exclusive_scan(const int (&c)[kPer], int bins, int* start,
                               int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) mine += c[k];
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - mine;
  for (int v = 0; v < warp; ++v) run += warp_sums[v];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (tid * kPer + k < bins) start[tid * kPer + k] = run;
    run += c[k];
  }
  __syncthreads();
}

// Scan phase of pass p: for kSortWarps digits, a warp each, every tile's
// count of the digit in the tiles before it, and the digit's total.  A
// warp loads kScanRounds rounds of 32 tiles at once.
__device__ void scan_digits(const SortArgs& a, int p, int block) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = block * kSortWarps + warp;
  if (d >= a.bins) return;
  int run = 0;
  for (int t0 = 0; t0 < a.n_tiles; t0 += 32 * kScanRounds) {
    int c[kScanRounds];
#pragma unroll
    for (int r = 0; r < kScanRounds; ++r) {
      const int t = t0 + r * 32 + lane;
      c[r] = t < a.n_tiles
                 ? __ldcg(a.offsets + static_cast<long long>(t) * a.bins + d)
                 : 0;
    }
#pragma unroll
    for (int r = 0; r < kScanRounds; ++r) {
      const int t = t0 + r * 32 + lane;
      int incl = c[r];
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (t < a.n_tiles)
        a.offsets[static_cast<long long>(t) * a.bins + d] = run + incl - c[r];
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  if (lane == 0) a.ghist[p * a.bins + d] = run;
}

// Scatter phase of pass p: the tile's lanes to their sorted positions,
// stably: the digit's start, its count in the tiles before, in the warps
// before, in the rounds before, and the lower lanes of the round with
// the same digit.  The words go through shared memory in the tile's own
// sorted order first, so that the writes to the output run along each
// digit's positions.
__device__ void scatter_tile(const SortArgs& a, int p, int tile,
                             unsigned short* wh, int* base, int* local,
                             unsigned long long* stage, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bins = a.bins;
  for (int i = tid; i < kSortWarps * bins; i += kSortThreads) wh[i] = 0;
  const int wlo = tile * kTileLanes + warp * kWarpLanes;
  WarpLanes w;
  load_lanes(a, p, wlo, min(wlo + kWarpLanes, a.n), w);
  // Each digit's total and its count in the tiles before, loaded with
  // the keys.
  const int* total = a.ghist + p * bins;
  const int* before = a.offsets + static_cast<long long>(tile) * bins;
  int c[kPer], b[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int d = tid * kPer + k;
    c[k] = d < bins ? __ldcg(total + d) : 0;
    b[k] = d < bins ? __ldcg(before + d) : 0;
  }
  exclusive_scan(c, bins, base, warp_sums);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (tid * kPer + k < bins) base[tid * kPer + k] += b[k];
  unsigned short* mine = wh + warp * bins;
  unsigned peers[kRounds];
  warp_counts(a, p, w, mine, peers);
  __syncthreads();
  // Each digit's count in the warps before, and in the tile.
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int d = tid * kPer + k;
    unsigned short run = 0;
    if (d < bins)
      for (int v = 0; v < kSortWarps; ++v) {
        const unsigned short n = wh[v * bins + d];
        wh[v * bins + d] = run;
        run += n;
      }
    c[k] = run;
  }
  exclusive_scan(c, bins, local, warp_sums);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool live = w.key[r] >= 0;
    const int d = live ? digit_of(a, w.key[r], p) : -1;
    const int at =
        live ? local[d] + mine[d] + __popc(peers[r] & ((1u << lane) - 1)) : 0;
    __syncwarp();
    if (live) {
      stage[at] = static_cast<unsigned long long>(w.key[r]) << 32 |
                  static_cast<unsigned>(w.lane[r]);
      if (lane == __ffs(peers[r]) - 1) mine[d] += __popc(peers[r]);
    }
    __syncwarp();
  }
  __syncthreads();
  unsigned long long* out = a.words[p & 1];
  const int len = min(kTileLanes, a.n - tile * kTileLanes);
  for (int i = tid; i < len; i += kSortThreads) {
    const unsigned long long x = stage[i];
    const int d = digit_of(a, static_cast<int>(x >> 32), p);
    out[base[d] + i - local[d]] = x;
  }
}

__global__ void __launch_bounds__(kSortThreads, 1) sort_lanes(SortArgs a) {
  // kSortWarps * bins 16-bit counters, 2 * bins ints, kTileLanes words
  extern __shared__ __align__(16) unsigned short smem[];
  __shared__ int ticket;
  __shared__ int warp_sums[kSortWarps];
  if (threadIdx.x == 0) ticket = atomicAdd(a.ticket, 1);
  __syncthreads();
  // Phases in ticket order, for each pass: count, scan, scatter.
  const int per_pass = 2 * a.n_tiles + a.n_scans;
  const int p = ticket / per_pass;
  int i = ticket - p * per_pass, step = 0;
  if (i >= a.n_tiles) {
    i -= a.n_tiles;
    step = 1;
    if (i >= a.n_scans) {
      i -= a.n_scans;
      step = 2;
    }
  }
  const int phase = 3 * p + step;
  if (phase > 0 && threadIdx.x == 0)
    wait_count(a.done + phase - 1,
               step == 1 ? a.n_tiles : step == 2 ? a.n_scans : a.n_tiles);
  __syncthreads();
  if (step == 0)
    count_tile(a, p, i, smem);
  else if (step == 1)
    scan_digits(a, p, i);
  else
    scatter_tile(a, p, i, smem,
                 reinterpret_cast<int*>(smem + kSortWarps * a.bins),
                 reinterpret_cast<int*>(smem + kSortWarps * a.bins) + a.bins,
                 reinterpret_cast<unsigned long long*>(
                     smem + (kSortWarps + 4) * a.bins),
                 warp_sums);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(a.done + phase, 1);
}

// One level of reduce_rows' units: level 0 the chunks, level l + 1
// units of kFanOut level-l units.
struct Level {
  long long size;  // positions a unit spans
  int units;
  float* first;    // [units, f]: the partial of a unit's first row, if open
  float* last;     // [units, f]: of its last row, if open and not the first
  int* arrived;    // [units] zeroed (levels 2 up): units below finished
};

struct ReduceArgs {
  const unsigned long long* words;  // [n] (row << 32 | lane), sorted
  const float* src;
  int n, f;
  float* out;
  Level level[kMaxLevels];  // up to the first with one unit
};

__device__ __forceinline__ int row_at(const ReduceArgs& a, long long p) {
  return static_cast<int>(a.words[p] >> 32);
}

// The rows at the edges of the units below the unit `up` of level l + 1:
// lane k's first and last (distinct non-rows past the end), and the rows
// just outside the unit.
struct UnitRows {
  int fr, lr, before, after;
};

__device__ __forceinline__ UnitRows unit_rows(const ReduceArgs& a, int l,
                                              int up, int subunits) {
  const int k = threadIdx.x & 31;
  const Level& lo = a.level[l];
  const long long us = static_cast<long long>(up) * kFanOut * lo.size;
  const long long ue = min(us + kFanOut * lo.size, static_cast<long long>(a.n));
  UnitRows u{-2 - k, -2 - k, -1, -1};
  if (k < subunits) {
    const long long ks = us + k * lo.size;
    u.fr = row_at(a, ks);
    u.lr = row_at(a, min(ks + lo.size, static_cast<long long>(a.n)) - 1);
  }
  if (us > 0) u.before = row_at(a, us - 1);
  if (ue < a.n) u.after = row_at(a, ue);
  return u;
}

// A row that combine sums: its first and last unit below (k0, k1), which
// slot of unit k0 holds its partial, and where its sum goes.
struct Candidate {
  int k0, k1, last_slot;
  float* dst;
};

// The unit `up` of level l + 1, once its `subunits` units of level l are
// done: each row that crosses an edge between them, or is open at the
// unit's own edges, combined from its partials by the tree's steps above
// level l's unit size.  Warp 0 finds the rows, a lane each; the block
// stages every unit's two partials (a slice of columns at a time, all
// loads in flight); then a thread takes a (row, column), the tree's
// steps over the row's units unrolled in registers.
__device__ void combine(const ReduceArgs& a, int l, int up, int subunits,
                        float* stage, Candidate* cands, int* n_cands) {
  const int tid = threadIdx.x, k = tid & 31;
  const Level& lo = a.level[l];
  const Level& hi = a.level[l + 1];
  const UnitRows ur = unit_rows(a, l, up, subunits);
  if (tid < 32) {
    const bool live = k < subunits;
    const int fr = ur.fr, lr = ur.lr, before = ur.before, after = ur.after;
    const int unit_first = __shfl_sync(0xffffffffu, fr, 0);
    const int unit_last = __shfl_sync(0xffffffffu, lr, subunits - 1);
    const int prev_lr = __shfl_up_sync(0xffffffffu, lr, 1);
    const int next_fr = __shfl_down_sync(0xffffffffu, fr, 1);
    // Lane k's last row goes on into unit k + 1; lane k heads that row
    // unless it came in from unit k - 1.
    const bool cont = live && k + 1 < subunits && next_fr == lr;
    const bool head = live && !(fr == lr && k > 0 && prev_lr == fr);
    const bool open = (lr == unit_first && before == lr) ||
                      (lr == unit_last && after == lr);
    const unsigned heads = __ballot_sync(0xffffffffu, head && (cont || open));
    // Units a row passes through whole: its last unit is the first after
    // its head that does not.
    const unsigned through = __ballot_sync(0xffffffffu,
                                           live && fr == lr && cont);
    if (head && (cont || open)) {
      const int k1 = cont ? __ffs(~through & (0xfffffffeu << k)) - 1 : k;
      cands[__popc(heads & ((1u << k) - 1))] = Candidate{
          k, k1, fr != lr,
          !open ? a.out + static_cast<long long>(lr) * a.f
                : (lr == unit_first ? hi.first : hi.last) +
                      static_cast<long long>(up) * a.f};
    }
    // The unit's first row, when it ends inside unit 0 but came from
    // before the unit.
    const int lr0 = __shfl_sync(0xffffffffu, lr, 0);
    if (k == 0) {
      const bool extra = unit_first != lr0 && before == unit_first;
      if (extra)
        cands[__popc(heads)] =
            Candidate{0, 0, 0, hi.first + static_cast<long long>(up) * a.f};
      *n_cands = __popc(heads) + extra;
    }
  }
  float* sf = stage;                     // [kFanOut][kSlice]: first slots
  float* sl = stage + kFanOut * kSlice;  // last slots
  for (int j0 = 0; j0 < a.f; j0 += kSlice) {
    const int fs = min(kSlice, a.f - j0);
    const int pstep = kThreads / fs, p0 = tid / fs, j = tid - p0 * fs;
    if (p0 < pstep)
      for (int u = p0; u < subunits; u += pstep) {
        const long long o =
            static_cast<long long>(up * kFanOut + u) * a.f + j0 + j;
        sf[u * kSlice + j] = __ldcg(lo.first + o);
        sl[u * kSlice + j] = __ldcg(lo.last + o);
      }
    __syncthreads();
    for (int item = tid; item < *n_cands * fs; item += kThreads) {
      const int q = item / fs, jj = item - q * fs;
      const Candidate c = cands[q];
      float x[kFanOut];
#pragma unroll
      for (int u = 0; u < kFanOut; ++u)
        x[u] = u < c.k0 || u > c.k1
                   ? 0.0f
                   : (u == c.k0 && c.last_slot ? sl : sf)[u * kSlice + jj];
      // Node [a0, a0 + 2h) adds its right half (held at its middle) to
      // its left half (held at max(a0, k0)) when both hold the row.
#pragma unroll
      for (int h = 1; h < kFanOut; h <<= 1) {
#pragma unroll
        for (int a0 = 0; a0 < kFanOut; a0 += 2 * h) {
          const int mid = a0 + h;
          if (mid > c.k0 && mid <= c.k1) {
#pragma unroll
            for (int t = a0; t < mid; ++t)
              if (t == max(a0, c.k0)) x[t] = __fadd_rn(x[t], x[mid]);
          }
        }
      }
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kFanOut; ++u)
        if (u == c.k0) sum = x[u];
      c.dst[j0 + jj] = sum;
    }
    __syncthreads();
  }
}

// The levels above the chunks: block b combines the chunks of level-1
// unit b; the last block to finish a unit's units takes the unit above
// (an integer arrival count), up to the level with one unit.
__global__ void __launch_bounds__(kThreads) combine_levels(ReduceArgs a) {
  __shared__ float stage[2 * kFanOut * kSlice];
  __shared__ Candidate cands[kFanOut + 1];
  __shared__ int n_cands, is_last;
  int u = blockIdx.x;
  for (int l = 0;; ++l) {
    combine(a, l, u, min(kFanOut, a.level[l].units - u * kFanOut), stage,
            cands, &n_cands);
    if (a.level[l + 1].units == 1) return;
    const int up = u / kFanOut;
    const int units = min(kFanOut, a.level[l + 1].units - up * kFanOut);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      is_last = atomicAdd(a.level[l + 2].arrived + up, 1) == units - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    u = up;
  }
}

__global__ void __launch_bounds__(kThreads) reduce_rows(ReduceArgs a) {
  __shared__ int srow[kChunk], slane[kChunk], sstart[kChunk], runs[kChunk];
  __shared__ int warp_max[kWarps], warp_heads[kWarps];
  __shared__ unsigned desc[kBlocks];
  __shared__ float tile[kChunk * kSlice];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, cs = c * kChunk, m = min(kChunk, a.n - cs);
  if (tid < m) {
    const unsigned long long w = a.words[cs + tid];
    srow[tid] = static_cast<int>(w >> 32);
    slane[tid] = static_cast<int>(w);
  } else {
    srow[tid] = -1 - tid;  // not a row, and unlike its neighbours
  }
  const int before = cs > 0 ? row_at(a, cs - 1) : -1;
  const int after = cs + m < a.n ? row_at(a, cs + m) : -1;
  __syncthreads();
  // sstart[p]: the first position in the chunk of p's row (a max-scan
  // of the rows' first positions); runs: those first positions, in order.
  const bool head = tid == 0 || srow[tid] != srow[tid - 1];
  int v = head ? tid : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  const unsigned heads = __ballot_sync(0xffffffffu, head && tid < m);
  if (lane == 31) warp_max[warp] = v;
  if (lane == 0) warp_heads[warp] = __popc(heads);
  __syncthreads();
  int n_runs = 0, rank = __popc(heads & ((1u << lane) - 1));
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      v = max(v, warp_max[w]);
      rank += warp_heads[w];
    }
    n_runs += warp_heads[w];
  }
  sstart[tid] = v;
  if (head && tid < m) runs[rank] = tid;
  __syncthreads();
  // Steps h = 1, 2, 4 inside each block of 8 positions: which of its 7
  // nodes add (bits 0-6: mids 1, 3, 5, 7, then 2, 6, then 4) and where a
  // node's left partial is held when it can be more than one place
  // (bit 7: 1 + the node at 0 of h = 2; bit 8: 5 + the node at 4; bits
  // 9-10: the node at 0 of h = 4).
  if (tid < kBlocks) {
    const int b = tid * 8;
    unsigned d = 0;
    const int mids[7] = {1, 3, 5, 7, 2, 6, 4};
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int mid = b + mids[k];
      if (mid < m && srow[mid - 1] == srow[mid]) d |= 1u << k;
    }
    d |= static_cast<unsigned>(sstart[b + 2] > b) << 7;
    d |= static_cast<unsigned>(sstart[b + 6] > b + 4) << 8;
    d |= static_cast<unsigned>(max(sstart[b + 4] - b, 0)) << 9;
    desc[tid] = d;
  }
  __syncthreads();
  const int last_row = srow[m - 1];
  const Level& l0 = a.level[0];
  // Column slices of fs <= kSlice: thread (p0, j) takes column j of the
  // blocks of 8 (then nodes, then runs) p0, p0 + pstep, ...
  for (int j0 = 0; j0 < a.f; j0 += kSlice) {
    const int fs = min(kSlice, a.f - j0), s = fs | 1;
    const int pstep = kThreads / fs, p0 = tid / fs, j = tid - p0 * fs;
    const bool on = p0 < pstep;
    if (on) {
      // Every load of this thread's blocks in flight at once.
      const float* col = a.src + j0 + j;
      float x[kItems][8];
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int b = (p0 + it * pstep) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          x[it][i] = b + i < m ? col[static_cast<long long>(slane[b + i]) * a.f]
                               : 0.0f;
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int q = p0 + it * pstep, b = q * 8;
        if (b >= m) break;
        const unsigned d = desc[q];
        float* y = x[it];
        if (d & 1) y[0] = __fadd_rn(y[0], y[1]);
        if (d & 2) y[2] = __fadd_rn(y[2], y[3]);
        if (d & 4) y[4] = __fadd_rn(y[4], y[5]);
        if (d & 8) y[6] = __fadd_rn(y[6], y[7]);
        if (d & 16) {
          if (d & 128) y[1] = __fadd_rn(y[1], y[2]);
          else y[0] = __fadd_rn(y[0], y[2]);
        }
        if (d & 32) {
          if (d & 256) y[5] = __fadd_rn(y[5], y[6]);
          else y[4] = __fadd_rn(y[4], y[6]);
        }
        if (d & 64) {
          const unsigned hd = (d >> 9) & 3;
          if (hd == 0) y[0] = __fadd_rn(y[0], y[4]);
          if (hd == 1) y[1] = __fadd_rn(y[1], y[4]);
          if (hd == 2) y[2] = __fadd_rn(y[2], y[4]);
          if (hd == 3) y[3] = __fadd_rn(y[3], y[4]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (b + i < m) tile[(b + i) * s + j] = y[i];
      }
    }
    __syncthreads();
    for (int h = 8; h < kChunk; h <<= 1) {
      if (on) {
        for (int node = p0; node < kChunk / (2 * h); node += pstep) {
          const int mid = node * 2 * h + h;
          if (mid < m && srow[mid - 1] == srow[mid]) {
            const int left = max(mid - h, sstart[mid]);
            tile[left * s + j] =
                __fadd_rn(tile[left * s + j], tile[mid * s + j]);
          }
        }
      }
      __syncthreads();
    }
    if (on) {
      for (int k = p0; k < n_runs; k += pstep) {
        const int p = runs[k], r = srow[p];
        const bool open =
            (p == 0 && before == r) || (r == last_row && after == r);
        const float x = tile[p * s + j];
        const long long col = j0 + j;
        if (!open)
          a.out[static_cast<long long>(r) * a.f + col] = x;
        else
          (p == 0 ? l0.first : l0.last)[static_cast<long long>(c) * a.f +
                                        col] = x;
      }
    }
    __syncthreads();
  }
}

// Where everything lives, from (n, f, n_rows): byte offsets into the
// caller's two buffers, `zeroed` (zero-filled) and `work` (not).
struct Plan {
  int passes, bits, bins, n_tiles, n_scans, levels;
  long long units[kMaxLevels], size[kMaxLevels];
  long long z_done, z_arrived[kMaxLevels], z_bytes;
  long long w_words[2], w_ghist, w_offsets, w_first[kMaxLevels],
      w_last[kMaxLevels], w_bytes;
};

Plan make_plan(int n, int f, int n_rows) {
  Plan p{};
  if (n_rows <= kMaxBins) {
    p.passes = 1;
    p.bits = 0;
    p.bins = n_rows;
  } else {
    int total = 0;  // bits a row can have set
    while ((1ll << total) < n_rows) ++total;
    p.passes = (total + kMaxBits - 1) / kMaxBits;
    p.bits = (total + p.passes - 1) / p.passes;
    p.bins = 1 << p.bits;
  }
  p.n_tiles = (n + kTileLanes - 1) / kTileLanes;
  p.n_scans = (p.bins + kSortWarps - 1) / kSortWarps;
  p.units[0] = (n + kChunk - 1) / kChunk;
  p.size[0] = kChunk;
  p.levels = 1;
  while (p.units[p.levels - 1] > 1) {
    p.units[p.levels] = (p.units[p.levels - 1] + kFanOut - 1) / kFanOut;
    p.size[p.levels] = p.size[p.levels - 1] * kFanOut;
    ++p.levels;
  }
  long long z = sizeof(int);  // the ticket
  p.z_done = z;
  z += sizeof(int) * 3 * p.passes;
  for (int l = 2; l < p.levels; ++l) {
    p.z_arrived[l] = z;
    z += sizeof(int) * p.units[l];
  }
  p.z_bytes = z;
  long long w = 0;
  for (int i = 0; i < 2; ++i) {  // pass p writes words[p & 1]
    p.w_words[i] = w;
    if (p.passes > i) w += 8ll * n;
  }
  p.w_ghist = w;
  w += 4ll * p.passes * p.bins;
  p.w_offsets = w;
  w += 4ll * p.n_tiles * p.bins;
  for (int l = 0; l + 1 < p.levels; ++l) {
    p.w_first[l] = w;
    w += 4ll * p.units[l] * f;
    p.w_last[l] = w;
    w += 4ll * p.units[l] * f;
  }
  p.w_bytes = w;
  return p;
}

}  // namespace

// The two buffers hrt_segment_sum needs for (n, f, n_rows), in bytes:
// bytes[0] for `zeroed`, which the caller fills with zeros, and bytes[1]
// for `work`.  Returns 0, or cudaErrorInvalidValue for sizes it does not
// take.
extern "C" int hrt_segment_sum_workspace(int n, int f, int n_rows,
                                         long long* bytes) {
  if (n <= 0 || f <= 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n, f, n_rows);
  bytes[0] = p.z_bytes;
  bytes[1] = p.w_bytes;
  return 0;
}

// C entry point, bound with ctypes.  Device pointers, all contiguous:
// idx [n] int64 (idx64 != 0) or int32, every value in [0, n_rows) (the
// kernel traps on one outside); src [n, f] float32; zeroed and work as
// hrt_segment_sum_workspace sizes them, zeroed filled with zeros by the
// caller on `stream` before this call; out [n_rows, f] float32.
// Launches the two kernels on `stream` and returns cudaGetLastError()
// after each; does not synchronise.  n, f and n_rows must be positive
// and n * f below 2^31.
extern "C" int hrt_segment_sum(const void* idx, int idx64, const float* src,
                               int n, int f, int n_rows, void* zeroed,
                               void* work, float* out, void* stream) {
  if (n <= 0 || f <= 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(n, f, n_rows);
  char* z = static_cast<char*>(zeroed);
  char* w = static_cast<char*>(work);
  SortArgs sa{};
  sa.idx = idx;
  sa.idx64 = idx64 != 0;
  sa.n = n;
  sa.n_rows = n_rows;
  sa.f = f;
  sa.passes = p.passes;
  sa.bits = p.bits;
  sa.bins = p.bins;
  sa.n_tiles = p.n_tiles;
  sa.n_scans = p.n_scans;
  sa.ticket = reinterpret_cast<int*>(z);
  sa.done = reinterpret_cast<int*>(z + p.z_done);
  sa.ghist = reinterpret_cast<int*>(w + p.w_ghist);
  sa.offsets = reinterpret_cast<int*>(w + p.w_offsets);
  for (int i = 0; i < 2; ++i)
    sa.words[i] = reinterpret_cast<unsigned long long*>(w + p.w_words[i]);
  sa.out = out;
  // 16-bit counters for each warp and two ints a digit, then a tile's
  // words (8-aligned: (kSortWarps + 4) * 2 bytes a digit)
  const int smem = static_cast<int>(
      sizeof(unsigned short) * (kSortWarps + 4) * p.bins +
      sizeof(unsigned long long) * kTileLanes);
  cudaError_t err = cudaFuncSetAttribute(
      sort_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_lanes<<<p.passes * (2 * p.n_tiles + p.n_scans), kSortThreads, smem,
               s>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ReduceArgs ra{};
  ra.words = sa.words[(p.passes - 1) & 1];
  ra.src = src;
  ra.n = n;
  ra.f = f;
  ra.out = out;
  for (int l = 0; l < p.levels; ++l) {
    Level& lv = ra.level[l];
    lv.size = p.size[l];
    lv.units = static_cast<int>(p.units[l]);
    if (l + 1 < p.levels) {
      lv.first = reinterpret_cast<float*>(w + p.w_first[l]);
      lv.last = reinterpret_cast<float*>(w + p.w_last[l]);
    }
    if (l > 1) lv.arrived = reinterpret_cast<int*>(z + p.z_arrived[l]);
  }
  reduce_rows<<<static_cast<int>(p.units[0]), kThreads, 0, s>>>(ra);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.levels == 1) return static_cast<int>(err);
  combine_levels<<<static_cast<int>(p.units[1]), kThreads, 0, s>>>(ra);
  return static_cast<int>(cudaGetLastError());
}
