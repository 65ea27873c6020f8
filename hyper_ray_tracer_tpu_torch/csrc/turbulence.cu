// The noise texture's branch of texture_value in one launch, for NVIDIA
// Hopper (sm_90a): per lane, the marble value (7-octave Perlin
// turbulence) where the texture type is noise, the incoming texture
// value elsewhere.
//
// Replaces the TPU kernel tools/prof_tex.py::make_pallas_turb (defined
// at :69, body :77-89, pallas_call :102) and the eager operations around
// it.  Contract, unchanged: for every lane whose ttype is TT_NOISE,
//   out[i, :] = 0.5 * (1 + sin(z + 10 * turbulence(x, y, z)))
// with (x, y, z) = scale * point (the pre-scaled point, a reference
// quirk), turbulence = |sum_{k<7} 0.5^k noise(2^k p)| and noise the
// reference's gradient noise (perlin_noise.rs: three axis permutations
// XORed into the lattice hash, cube-corner-biased unit gradients, the
// smoothed fraction in both the lerp weights and the weight vector);
// out[i, :] = value[i, :] on every other lane.
//
// Rounding: every floating-point step is one IEEE round-to-nearest
// operation (__fmul_rn, __fadd_rn, __fsub_rn) in the order of the plain
// version (ops/turbulence.py:noise_texture_plain, through
// ops/perlin.py:_noise_xyz and turbulence_xyz), so nvcc cannot contract
// a*b+c into an FMA.  floorf and the int cast come before & 255, so
// negative lattice coordinates wrap as two's complement.  sinf is the
// CUDA math library's (not __sinf), the function torch's CUDA sin
// calls.  The permutations and gradients come from the scene's own
// tables (SceneArrays.perlin), which equal the plain version's per-lane
// hashes entry for entry (tests/test_torch_perlin.py), so the two agree
// bit for bit.
//
// What bounds it on this card.  The contract needs ~680 FP32 operations
// per noise lane once the permutations and gradients are table lookups
// (96 an octave: the scaled point, floor, fraction and smoothing per
// axis, eight corners of a 3-term dot and their lerp weights, the sums;
// chip_smoke.py TURB_OCTAVE_OPS), and a lane that is not noise needs
// only its flag and its copy.  On a sparse mask (`final`: ~2% of lanes
// are noise) that makes the kernel bound by bytes: every lane's 4-byte
// texture type and the 24-byte copy of the others' value.  The type and
// the value are columns of the gathered rows (28 and 76 bytes a row on
// `final`), which device memory serves in whole sectors, so in practice
// the sparse case moves several times the bytes it uses: torch's own
// copy of the value column takes two thirds of this kernel's time
// (chip_smoke.py phase 6).  On a dense mask (`two-perlin-spheres`:
// nearly all) it is bound by FP32 issue, at half the card's FMA-counted
// rate since exact arithmetic cannot contract, and by the shared-memory
// lookups, ~40 wavefronts a warp and octave.
//
// What the design does about those bounds:
// - Tables, not hashes.  Each block stages the three 256-entry
//   permutations and the 256 gradients into shared memory once.  An
//   octave then costs 3 permutation and 8 gradient lookups in place of
//   6 8-bit permutations, 24 ARX mixes and 8 normalisations (~465
//   integer instructions, the design this replaces).  Gradients are
//   random 16-byte lookups, which may conflict on the banks; the table
//   is held in kCopies copies and lane l reads copy l % kCopies (with 8,
//   the eight lanes of a 128-byte wavefront never meet in a bank).  1, 4
//   and 8 copies time within a few percent of each other on the card:
//   the banks are not what bounds it.  A permutation entry holds the
//   pair perm[i], perm[i + 1] already scaled to byte offsets of gradient
//   rows, so a corner's lookup address is one 3-way XOR: the lattice
//   hash h = px ^ py ^ pz scales by a power of two as its terms do.
// - Noise lanes compacted in the block.  A block takes a tile of kTile
//   lanes, reads their texture types coalesced (the strided column of
//   the gathered int rows, no copy), copies the value of every lane that
//   is not noise, ballots the flags per warp and writes the tile's noise
//   lanes into a shared-memory list in launch order.  Then all its
//   threads work through that list, so the warps that run the
//   turbulence are full on a sparse mask, and each thread takes several
//   lanes on a dense one.  No second launch, no host sync.
// - The branch fused.  The kernel reads the texture type, the scale and
//   the incoming value as the strided views the row gather gives, scales
//   the point itself and writes the [N, 3] result: one launch where the
//   eager branch took seven (scale multiply, three copies, compare,
//   marble, where).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kSteps, kCopies and kMinBlocks are the fastest variant without spills
// of tune_turbulence.py (4 resident blocks cap a thread at 64 registers).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident-block floor for ptxas
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;  // flags each thread reads per tile
constexpr int kTile = kThreads * kSteps;
constexpr int kWords = kSteps * kWarps;  // a tile's ballot words
constexpr int kDepth = 7;   // textures/noise_texture.rs:28
constexpr int kCopies = 4;  // gradient table copies
static_assert(kWords % 32 == 0, "warp 0 scans kWords / 32 words a lane");

constexpr uint32_t kRow = kCopies * sizeof(float4);  // a gradient's copies
static_assert(255 * kRow < 65536, "a permutation pair packs two 16-bit "
              "offsets");

struct Smem {
  float4 grad[256][kCopies];
  // perm[i] * kRow | perm[(i + 1) & 255] * kRow << 16
  uint32_t perm[3][256];
  int list[kTile];        // the tile's noise lanes, in launch order
  uint32_t ballot[kWords];
  int offset[kWords + 1];
};

struct Args {
  const int* ttype;
  long long ttype_stride;
  const float* scale;
  long long scale_stride;
  const float* point;
  long long point_stride;
  const float* value;
  long long value_stride;
  int noise_tag;
  int n;
  float* out;
};

__device__ __forceinline__ float smooth(float u) {
  return __fmul_rn(__fmul_rn(u, u), __fsub_rn(3.0f, __fmul_rn(2.0f, u)));
}

// One octave of gradient noise (ops/perlin.py:_noise_xyz) from the
// tables; `q` picks this lane's copy of the gradients.
__device__ __forceinline__ float noise(const Smem& sh, int q, float x,
                                       float y, float z) {
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const float sx = smooth(__fsub_rn(x, fx));
  const float sy = smooth(__fsub_rn(y, fy));
  const float sz = smooth(__fsub_rn(z, fz));
  const uint32_t px = sh.perm[0][static_cast<int>(fx) & 255];
  const uint32_t py = sh.perm[1][static_cast<int>(fy) & 255];
  const uint32_t pz = sh.perm[2][static_cast<int>(fz) & 255];
  // Byte offsets of the corners' rows, this lane's copy folded into x.
  const uint32_t copy = static_cast<uint32_t>(q) * sizeof(float4);
  const uint32_t ox[2] = {(px & 0xFFFFu) | copy, (px >> 16) | copy};
  const uint32_t oy[2] = {py & 0xFFFFu, py >> 16};
  const uint32_t oz[2] = {pz & 0xFFFFu, pz >> 16};
  const char* grad = reinterpret_cast<const char*>(sh.grad);
  // Corner offset 0: lerp weight 1 - s, weight vector s; offset 1: lerp
  // weight s, weight vector s - 1.
  const float ax = __fsub_rn(1.0f, sx), ay = __fsub_rn(1.0f, sy),
              az = __fsub_rn(1.0f, sz);
  const float bx = __fsub_rn(sx, 1.0f), by = __fsub_rn(sy, 1.0f),
              bz = __fsub_rn(sz, 1.0f);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
    const float4 g = *reinterpret_cast<const float4*>(
        grad + (ox[dx] ^ oy[dy] ^ oz[dz]));
    const float wv_dot = __fadd_rn(
        __fadd_rn(__fmul_rn(g.x, dx ? bx : sx), __fmul_rn(g.y, dy ? by : sy)),
        __fmul_rn(g.z, dz ? bz : sz));
    const float lerp_w = __fmul_rn(__fmul_rn(dx ? sx : ax, dy ? sy : ay),
                                   dz ? sz : az);
    const float term = __fmul_rn(lerp_w, wv_dot);
    acc = c == 0 ? term : __fadd_rn(acc, term);
  }
  return acc;
}

// The marble value at the pre-scaled point (ops/turbulence.py:
// marble_plain).
__device__ float marble(const Smem& sh, int q, float px, float py,
                        float pz) {
  float acc = 0.0f;
  float sc = 1.0f, w = 1.0f;  // 2^k and 0.5^k, exact
#pragma unroll 1
  for (int k = 0; k < kDepth; ++k) {
    const float term = __fmul_rn(
        w, noise(sh, q, __fmul_rn(px, sc), __fmul_rn(py, sc),
                 __fmul_rn(pz, sc)));
    acc = k == 0 ? term : __fadd_rn(acc, term);
    sc = __fmul_rn(sc, 2.0f);
    w = __fmul_rn(w, 0.5f);
  }
  const float turb = fabsf(acc);
  return __fmul_rn(0.5f, __fadd_rn(1.0f, sinf(__fadd_rn(
                                             pz, __fmul_rn(10.0f, turb)))));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
noise_texture_kernel(Args a, const float* __restrict__ vectors,
                     const int* __restrict__ perm_x,
                     const int* __restrict__ perm_y,
                     const int* __restrict__ perm_z) {
  __shared__ Smem sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < 256 * kCopies; e += kThreads) {
    const int h = e / kCopies;
    sh.grad[h][e % kCopies] = make_float4(
        vectors[3 * h], vectors[3 * h + 1], vectors[3 * h + 2], 0.0f);
  }
  for (int e = tid; e < 3 * 256; e += kThreads) {
    const int* p = e < 256 ? perm_x : e < 512 ? perm_y : perm_z;
    const int i = e & 255;
    sh.perm[e >> 8][i] = static_cast<uint32_t>(p[i] & 255) * kRow |
                         static_cast<uint32_t>(p[(i + 1) & 255] & 255) * kRow
                             << 16;
  }
  const int tiles = (a.n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    // This thread's lanes are base + s * kThreads + tid: each load is
    // coalesced across the block.  Every load of the tile is issued
    // before the first store, so they are all in flight at once.
    int tt[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = base + s * kThreads + tid;
      tt[s] = i < a.n ? a.ttype[i * a.ttype_stride] : a.noise_tag;
    }
    uint32_t mine = 0, copy = 0;  // bit s: lane s is noise / is copied
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const bool in = base + s * kThreads + tid < a.n;
      mine |= static_cast<uint32_t>(in && tt[s] == a.noise_tag) << s;
      copy |= static_cast<uint32_t>(in && tt[s] != a.noise_tag) << s;
    }
    float v[kSteps][3];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (copy >> s & 1u) {
        const float* src = a.value + (base + s * kThreads + tid) *
                                         a.value_stride;
        v[s][0] = src[0];
        v[s][1] = src[1];
        v[s][2] = src[2];
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (copy >> s & 1u) {
        float* o = a.out + 3LL * (base + s * kThreads + tid);
        o[0] = v[s][0];
        o[1] = v[s][1];
        o[2] = v[s][2];
      }
      const uint32_t b = __ballot_sync(0xFFFFFFFFu, mine >> s & 1u);
      if (lane == 0) sh.ballot[s * kWarps + warp] = b;
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the ballot words' counts
      constexpr int kPer = kWords / 32;
      int c[kPer], sum = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        c[k] = __popc(sh.ballot[kPer * lane + k]);
        sum += c[k];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += up;
      }
      int at = incl - sum;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        sh.offset[kPer * lane + k] = at;
        at += c[k];
      }
      if (lane == 31) sh.offset[kWords] = incl;
    }
    __syncthreads();
    const uint32_t below = (1u << lane) - 1u;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (mine >> s & 1u) {
        const int w = s * kWarps + warp;
        sh.list[sh.offset[w] + __popc(sh.ballot[w] & below)] =
            base + s * kThreads + tid;
      }
    }
    __syncthreads();
    const int count = sh.offset[kWords];
    for (int j = tid; j < count; j += kThreads) {
      const int i = sh.list[j];
      const float sc = a.scale[i * a.scale_stride];
      const float* p = a.point + i * a.point_stride;
      const float m = marble(sh, lane % kCopies, __fmul_rn(sc, p[0]),
                             __fmul_rn(sc, p[1]), __fmul_rn(sc, p[2]));
      float* o = a.out + 3LL * i;
      o[0] = m;
      o[1] = m;
      o[2] = m;
    }
    __syncthreads();  // the next tile rewrites the list and the ballots
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers:
// ttype [n] int32 and scale [n] float32 with element strides; point and
// value [n, 3] float32 with row strides (their columns contiguous);
// vectors [256, 3] float32, perm_x / perm_y / perm_z [256] int32, all
// contiguous; out [n, 3] float32, contiguous.  noise_tag is TT_NOISE.
// The grid is the tiles, capped at the blocks the card holds at once
// (each block walks its tiles and stages the tables once).  Launches on
// `stream` and returns cudaGetLastError() (0 on success, or the error
// of a device query); it never synchronises.
extern "C" int hrt_noise_texture(
    const int* ttype, long long ttype_stride, const float* scale,
    long long scale_stride, const float* point, long long point_stride,
    const float* value, long long value_stride, const float* vectors,
    const int* perm_x, const int* perm_y, const int* perm_z, int noise_tag,
    int n, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64];  // blocks the device holds at once, by ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, noise_texture_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int cap = resident[dev];
  const Args a{ttype, ttype_stride, scale, scale_stride, point, point_stride,
               value, value_stride, noise_tag, n, out};
  noise_texture_kernel<<<tiles < cap ? tiles : cap, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, vectors, perm_x, perm_y, perm_z);
  return static_cast<int>(cudaGetLastError());
}
