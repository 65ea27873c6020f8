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
//   1. the lanes sorted by row, stably (torch.sort(stable=True) in the
//      wrapper; `rows` the sorted rows, `order` the lane at each sorted
//      position);
//   2. the sorted positions cut into chunks of kChunk; a row's positions
//      in one chunk form a piece, summed left to right, starting from
//      its first value (x0 + x1, then + x2, ...);
//   3. each row's pieces summed left to right in chunk order, starting
//      from its first piece.
// Every addition is one __fadd_rn.  No float atomics: each piece, row
// bound and output element has one writer.
//
// What bounds it on this card: bytes.  It adds each cotangent once (one
// FP32 addition an element), so the least time is the cotangent rows
// read once, the gradient written once and the lanes' rows read once
// (8 bytes a lane, int64): chip_smoke.py's bound.  The sort is torch's.
//
// The design.  A thread that walks its data alone waits on its loads,
// and a walk that must add left to right cannot be split, so each kernel
// stages what a walk reads into shared memory with every thread of the
// block (coalesced loads, all in flight at once), and then the walks,
// one thread per column, read it from there.
// - Kernel 1 (chunk_pieces): one block per chunk.  It stages the chunk's
//   sorted rows and lanes, writes each row's first and last sorted
//   position + 1 where they fall in the chunk (bounds; the wrapper zeroes
//   them, so a row no lane took has an empty range), and then stages the
//   cotangent rows in tiles of kTile floats; thread `col` adds its column
//   down each tile.  A piece that starts at the chunk's first position
//   goes to heads[chunk] (a row spread over many chunks has all but its
//   first piece there, in chunk order, contiguous); a piece that starts
//   inside the chunk is the first of its row and goes to out[row].
// - Kernel 2 (row_totals): a block takes kThreads / f rows, a thread
//   each (row, column).  A row with at most kLong heads after its first
//   piece is added up by its own threads; a longer one (`random`'s
//   ground sphere takes about half of a bounce's 720,000 lanes, ~1,400
//   chunks) goes on the block's list, and the whole block stages its
//   heads, contiguous in memory, in tiles while `f` threads add them.
// The one atomic is an integer count of the block's long rows in shared
// memory; the order of that list changes no sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;    // ops/gather.py CHUNK
constexpr int kThreads = 256;  // a block; the widest row it takes
constexpr int kTile = 4096;    // floats a block stages at once (16 KB)
constexpr int kLong = 16;      // heads a row's own threads add up
static_assert(kThreads >= kChunk, "kernel 1 stages a chunk a thread each");

// Where a piece's sum goes: heads[chunk] if it starts the chunk, else
// out[row] (it is then its row's first piece).
__device__ __forceinline__ float* piece(float* heads, float* out, int f,
                                        bool at_head, int chunk, int row,
                                        int col) {
  return at_head ? heads + static_cast<long long>(chunk) * f + col
                 : out + static_cast<long long>(row) * f + col;
}

__global__ void __launch_bounds__(kThreads)
chunk_pieces(const long long* __restrict__ order,
             const int* __restrict__ rows, const float* __restrict__ src,
             int n, int f, float* __restrict__ heads,
             int* __restrict__ start, int* __restrict__ end,
             float* __restrict__ out) {
  __shared__ int srow[kChunk];
  __shared__ long long slane[kChunk];
  __shared__ float tile[kTile];
  const int c = blockIdx.x, t = threadIdx.x;
  const int lo = c * kChunk, m = min(kChunk, n - lo);
  if (t < m) {
    srow[t] = rows[lo + t];
    slane[t] = order[lo + t];
  }
  __syncthreads();
  if (t < m) {  // a row's first and last position each have one writer
    const int j = lo + t, r = srow[t];
    if (j == 0 || (t > 0 ? srow[t - 1] : rows[j - 1]) != r) start[r] = j;
    if (j == n - 1 || (t + 1 < m ? srow[t + 1] : rows[j + 1]) != r)
      end[r] = j + 1;
  }
  const int span = kTile / f;  // positions a tile holds
  int cur = srow[0], first = 0;
  float acc = 0.0f;
  for (int s0 = 0; s0 < m; s0 += span) {
    const int len = min(span, m - s0);
    for (int e = t; e < len * f; e += kThreads) {
      const int j = e / f;
      tile[e] = src[slane[s0 + j] * f + (e - j * f)];
    }
    __syncthreads();
    if (t < f) {
      for (int j = 0; j < len; ++j) {
        const int p = s0 + j, r = srow[p];
        const float v = tile[j * f + t];
        if (p == 0) {
          acc = v;
        } else if (r == cur) {
          acc = __fadd_rn(acc, v);
        } else {  // row cur ends at p, row r starts there
          *piece(heads, out, f, first == 0, c, cur, t) = acc;
          cur = r;
          first = p;
          acc = v;
        }
      }
    }
    __syncthreads();  // the next tile overwrites this one
  }
  if (t < f) *piece(heads, out, f, first == 0, c, cur, t) = acc;
}

__global__ void __launch_bounds__(kThreads)
row_totals(const float* __restrict__ heads, const int* __restrict__ start,
           const int* __restrict__ end, int n_rows, int f,
           float* __restrict__ out) {
  __shared__ int longs[kThreads];
  __shared__ int n_long;
  __shared__ float tile[kTile];
  const int t = threadIdx.x, per_block = kThreads / f;
  if (t == 0) n_long = 0;
  __syncthreads();
  const int r = blockIdx.x * per_block + t / f, col = t % f;
  if (t < per_block * f && r < n_rows) {
    const long long o = static_cast<long long>(r) * f + col;
    const int s = start[r], e = end[r];
    if (s == e) {
      out[o] = 0.0f;
    } else {
      const int c0 = s / kChunk, c1 = (e - 1) / kChunk;
      if (c1 - c0 <= kLong) {
        float acc = s % kChunk == 0 ? heads[static_cast<long long>(c0) * f +
                                            col]
                                    : out[o];
        for (int c = c0 + 1; c <= c1; ++c)
          acc = __fadd_rn(acc, heads[static_cast<long long>(c) * f + col]);
        out[o] = acc;
      } else if (col == 0) {
        longs[atomicAdd(&n_long, 1)] = r;
      }
    }
  }
  __syncthreads();
  const int span = kTile / f;  // heads a tile holds
  for (int k = 0; k < n_long; ++k) {
    const int row = longs[k], s = start[row], e = end[row];
    const int c0 = s / kChunk, c1 = (e - 1) / kChunk;
    const long long o = static_cast<long long>(row) * f + t;
    float acc = 0.0f;
    if (t < f)
      acc = s % kChunk == 0 ? heads[static_cast<long long>(c0) * f + t]
                            : out[o];
    for (int b = c0 + 1; b <= c1; b += span) {
      const int len = min(span, c1 - b + 1);
      const float* src = heads + static_cast<long long>(b) * f;
      for (int i = t; i < len * f; i += kThreads) tile[i] = src[i];
      __syncthreads();
      if (t < f)
        for (int j = 0; j < len; ++j) acc = __fadd_rn(acc, tile[j * f + t]);
      __syncthreads();
    }
    if (t < f) out[o] = acc;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Device pointers, all contiguous:
// order [n] int64 and rows [n] int32 (the stable sort of the lanes'
// rows), src [n, f] float32, heads [ceil(n / kChunk), f] float32
// scratch, bounds [2, n_rows] int32 zeroed by the caller (each row's
// first sorted position, then its last + 1), out [n_rows, f] float32.
// Launches the two kernels on `stream` and returns cudaGetLastError();
// does not synchronise.  n, f and n_rows must be positive, f at most
// kThreads.
extern "C" int hrt_segment_sum(const long long* order, const int* rows,
                               const float* src, int n, int f, int n_rows,
                               float* heads, int* bounds, float* out,
                               void* stream) {
  if (n <= 0 || f <= 0 || f > kThreads || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  chunk_pieces<<<n_chunks, kThreads, 0, s>>>(order, rows, src, n, f, heads,
                                             bounds, bounds + n_rows, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kThreads / f;
  row_totals<<<(n_rows + per_block - 1) / per_block, kThreads, 0, s>>>(
      heads, bounds, bounds + n_rows, n_rows, f, out);
  return static_cast<int>(cudaGetLastError());
}
