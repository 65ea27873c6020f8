// The noise texture's branch of texture_value in one launch, for NVIDIA
// Hopper (sm_90a): per lane, the marble value (7-octave Perlin
// turbulence) where the texture type is noise, the incoming texture
// value elsewhere (K2).  Its backward is the second kernel here (K2b).
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
//
// K2b, the branch's vector-Jacobian product (ops/turbulence.py
// noise_texture_grad; the JAX package differentiates the branch through
// XLA, ops/textures.py:65-70 and ops/perlin.py:203-254), walks the lanes
// as K2 does, with the same tables and compaction: a lane that is not
// noise passes its cotangent through (a 12-byte read, 28 bytes written),
// a noise lane recomputes its seven octaves with K2's rounding (so the
// turbulence sum's sign is the forward's) and sums each octave's
// analytic gradient.  Bound by bytes on a sparse mask, by FP32 throughput
// on a dense one (~2.4x K2's operations); a first, simple design: it holds
// each lane's derivative accumulators in registers (80, no spills).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kSteps, kCopies and kMinBlocks are the fastest variant without spills
// of tune_turbulence.py (4 resident blocks cap a thread at 64 registers).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident-block floor for ptxas
constexpr int kGradMinBlocks = 2;  // the same for the backward kernel
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

// The lanes both kernels walk: the texture type column and its tag.
struct Lanes {
  const int* ttype;
  long long ttype_stride;
  int noise_tag;
  int n;
};

struct Tables {
  const float* vectors;
  const int* perm_x;
  const int* perm_y;
  const int* perm_z;
};

__device__ __forceinline__ float smooth(float u) {
  return __fmul_rn(__fmul_rn(u, u), __fsub_rn(3.0f, __fmul_rn(2.0f, u)));
}

// One octave's lattice cell: the smoothed fractions (and the raw ones,
// which the derivative needs) and the corners' gradient-row offsets.
struct Cell {
  float u[3], s[3];
  uint32_t o[3][2];  // byte offsets, this lane's copy folded into x
};

__device__ __forceinline__ Cell cell(const Smem& sh, int q, float x, float y,
                                     float z) {
  Cell c;
  const float p[3] = {x, y, z};
  uint32_t pr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = floorf(p[a]);
    c.u[a] = __fsub_rn(p[a], f);
    c.s[a] = smooth(c.u[a]);
    pr[a] = sh.perm[a][static_cast<int>(f) & 255];
  }
  const uint32_t copy = static_cast<uint32_t>(q) * sizeof(float4);
  c.o[0][0] = (pr[0] & 0xFFFFu) | copy;
  c.o[0][1] = (pr[0] >> 16) | copy;
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    c.o[a][0] = pr[a] & 0xFFFFu;
    c.o[a][1] = pr[a] >> 16;
  }
  return c;
}

__device__ __forceinline__ float4 corner_grad(const Smem& sh, const Cell& c,
                                              int dx, int dy, int dz) {
  const char* grad = reinterpret_cast<const char*>(sh.grad);
  return *reinterpret_cast<const float4*>(
      grad + (c.o[0][dx] ^ c.o[1][dy] ^ c.o[2][dz]));
}

// One octave of gradient noise (ops/perlin.py:_noise_xyz) from the
// tables; `q` picks this lane's copy of the gradients.  With `d` set,
// also its gradient with respect to (x, y, z) into d[0..2] (plain float
// operations: only the value must round as the plain version does).
template <bool kGrad>
__device__ __forceinline__ float noise(const Smem& sh, int q, float x,
                                       float y, float z, float* d) {
  const Cell c = cell(sh, q, x, y, z);
  const float sx = c.s[0], sy = c.s[1], sz = c.s[2];
  // Corner offset 0: lerp weight 1 - s, weight vector s; offset 1: lerp
  // weight s, weight vector s - 1.
  const float ax = __fsub_rn(1.0f, sx), ay = __fsub_rn(1.0f, sy),
              az = __fsub_rn(1.0f, sz);
  const float bx = __fsub_rn(sx, 1.0f), by = __fsub_rn(sy, 1.0f),
              bz = __fsub_rn(sz, 1.0f);
  float acc = 0.0f, ds[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float4 g = corner_grad(sh, c, dx, dy, dz);
    const float wx = dx ? sx : ax, wy = dy ? sy : ay, wz = dz ? sz : az;
    const float wv_dot = __fadd_rn(
        __fadd_rn(__fmul_rn(g.x, dx ? bx : sx), __fmul_rn(g.y, dy ? by : sy)),
        __fmul_rn(g.z, dz ? bz : sz));
    const float lerp_w = __fmul_rn(__fmul_rn(wx, wy), wz);
    const float term = __fmul_rn(lerp_w, wv_dot);
    acc = k == 0 ? term : __fadd_rn(acc, term);
    if constexpr (kGrad) {
      // d term / d s_a: the lerp weight's factor on axis a turns into
      // +-1 (s or 1 - s), and the weight vector's component into g_a.
      const float ex = wy * wz * wv_dot, ey = wx * wz * wv_dot,
                  ez = wx * wy * wv_dot;
      ds[0] += (dx ? ex : -ex) + lerp_w * g.x;
      ds[1] += (dy ? ey : -ey) + lerp_w * g.y;
      ds[2] += (dz ? ez : -ez) + lerp_w * g.z;
    }
  }
  if constexpr (kGrad) {
#pragma unroll
    for (int a = 0; a < 3; ++a)  // d s / d u = 6 u (1 - u)
      d[a] = ds[a] * (6.0f * c.u[a] * (1.0f - c.u[a]));
  }
  return acc;
}

// The turbulence sum at the pre-scaled point, rounded as the plain
// version; with kGrad, d[0..2] gets the gradient of the (signed) sum.
// The octave at 2^k weighs 0.5^k, so each octave's gradient counts once.
template <bool kGrad>
__device__ float octaves(const Smem& sh, int q, float px, float py, float pz,
                         float* d) {
  float acc = 0.0f;
  float sc = 1.0f, w = 1.0f;  // 2^k and 0.5^k, exact
  if constexpr (kGrad) d[0] = d[1] = d[2] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < kDepth; ++k) {
    float dk[3];
    const float term = __fmul_rn(
        w, noise<kGrad>(sh, q, __fmul_rn(px, sc), __fmul_rn(py, sc),
                        __fmul_rn(pz, sc), dk));
    acc = k == 0 ? term : __fadd_rn(acc, term);
    if constexpr (kGrad) {
      d[0] += dk[0];
      d[1] += dk[1];
      d[2] += dk[2];
    }
    sc = __fmul_rn(sc, 2.0f);
    w = __fmul_rn(w, 0.5f);
  }
  return acc;
}

// The marble's argument z + 10 |turbulence| (ops/turbulence.py).
__device__ __forceinline__ float marble_arg(float pz, float acc) {
  return __fadd_rn(pz, __fmul_rn(10.0f, fabsf(acc)));
}

__device__ void stage_tables(Smem& sh, const Tables& t) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 256 * kCopies; e += kThreads) {
    const int h = e / kCopies;
    sh.grad[h][e % kCopies] = make_float4(
        t.vectors[3 * h], t.vectors[3 * h + 1], t.vectors[3 * h + 2], 0.0f);
  }
  for (int e = tid; e < 3 * 256; e += kThreads) {
    const int* p = e < 256 ? t.perm_x : e < 512 ? t.perm_y : t.perm_z;
    const int i = e & 255;
    sh.perm[e >> 8][i] = static_cast<uint32_t>(p[i] & 255) * kRow |
                         static_cast<uint32_t>(p[(i + 1) & 255] & 255) * kRow
                             << 16;
  }
}

// The walk both kernels share.  The block stages the tables, then takes
// tiles of kTile lanes: it reads their texture types (lane
// base + s * kThreads + tid for s < kSteps: each load coalesced across
// the block), lets `op.other` write every lane's output that needs no
// turbulence, ballots the noise flags per warp into a shared-memory list
// of the tile's noise lanes in launch order, and then all its threads
// work through that list with `op.noise`.
template <class Op>
__device__ __forceinline__ void walk(Smem& sh, const Lanes& a, const Op& op) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (a.n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    int tt[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = base + s * kThreads + tid;
      tt[s] = i < a.n ? a.ttype[i * a.ttype_stride] : a.noise_tag;
    }
    uint32_t mine = 0, copy = 0;  // bit s: lane s is noise / is not
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const bool in = base + s * kThreads + tid < a.n;
      mine |= static_cast<uint32_t>(in && tt[s] == a.noise_tag) << s;
      copy |= static_cast<uint32_t>(in && tt[s] != a.noise_tag) << s;
    }
    op.other(base + tid, mine, copy);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
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
    for (int j = tid; j < count; j += kThreads)
      op.noise(sh, lane % kCopies, sh.list[j]);
    __syncthreads();  // the next tile rewrites the list and the ballots
  }
}

// K2: the marble on noise lanes, the incoming value elsewhere.
struct Marble {
  const float* scale;
  long long scale_stride;
  const float* point;
  long long point_stride;
  const float* value;
  long long value_stride;
  float* out;

  // Every load of the tile starts before its first store, so they are
  // all in flight at once.
  __device__ __forceinline__ void other(int first, uint32_t, uint32_t copy)
      const {
    float v[kSteps][3];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (copy >> s & 1u) {
        const float* src = value + (first + s * kThreads) * value_stride;
        v[s][0] = src[0];
        v[s][1] = src[1];
        v[s][2] = src[2];
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (copy >> s & 1u) {
        float* o = out + 3LL * (first + s * kThreads);
        o[0] = v[s][0];
        o[1] = v[s][1];
        o[2] = v[s][2];
      }
    }
  }

  __device__ __forceinline__ void noise(const Smem& sh, int q, int i) const {
    const float sc = scale[i * scale_stride];
    const float* p = point + i * point_stride;
    const float pz = __fmul_rn(sc, p[2]);
    const float acc = octaves<false>(sh, q, __fmul_rn(sc, p[0]),
                                     __fmul_rn(sc, p[1]), pz, nullptr);
    const float m = __fmul_rn(0.5f, __fadd_rn(1.0f, sinf(marble_arg(pz,
                                                                    acc))));
    float* o = out + 3LL * i;
    o[0] = m;
    o[1] = m;
    o[2] = m;
  }
};

// K2b: the vector-Jacobian product of K2 for the cotangent grad_out.
// On a noise lane, with m = 0.5 (1 + sin(sp_z + 10 |A|)), sp = scale *
// point and A the turbulence sum, the output's three channels are m:
//   g = (sum_c grad_out_c) dm/dsp,
//   dm/dsp = 0.5 cos(sp_z + 10 |A|) (e_z + 10 sign(A) dA/dsp),
//   grad_point = scale g, grad_scale = <point, g>, grad_value = 0;
// on every other lane grad_value = grad_out and the others are 0.  A is
// recomputed with K2's rounding, so sign(A) is the forward's (sign(0) =
// 0, as torch's abs backward has it).
struct MarbleGrad {
  const float* scale;
  long long scale_stride;
  const float* point;
  long long point_stride;
  const float* grad_out;  // [n, 3] contiguous
  float* grad_point;      // [n, 3]
  float* grad_scale;      // [n]
  float* grad_value;      // [n, 3]

  __device__ __forceinline__ void other(int first, uint32_t mine,
                                        uint32_t copy) const {
    float v[kSteps][3];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (copy >> s & 1u) {
        const float* src = grad_out + 3LL * (first + s * kThreads);
        v[s][0] = src[0];
        v[s][1] = src[1];
        v[s][2] = src[2];
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const long long i = first + s * kThreads;
      if (copy >> s & 1u) {
        grad_value[3 * i] = v[s][0];
        grad_value[3 * i + 1] = v[s][1];
        grad_value[3 * i + 2] = v[s][2];
        grad_point[3 * i] = 0.0f;
        grad_point[3 * i + 1] = 0.0f;
        grad_point[3 * i + 2] = 0.0f;
        grad_scale[i] = 0.0f;
      } else if (mine >> s & 1u) {
        grad_value[3 * i] = 0.0f;
        grad_value[3 * i + 1] = 0.0f;
        grad_value[3 * i + 2] = 0.0f;
      }
    }
  }

  __device__ __forceinline__ void noise(const Smem& sh, int q, int i) const {
    const float sc = scale[i * scale_stride];
    const float* p = point + i * point_stride;
    const float px = p[0], py = p[1], pz = p[2];
    const float* go = grad_out + 3LL * i;
    const float gsum = go[0] + go[1] + go[2];
    const float spz = __fmul_rn(sc, pz);
    float dA[3];
    const float acc = octaves<true>(sh, q, __fmul_rn(sc, px),
                                    __fmul_rn(sc, py), spz, dA);
    const float c = 0.5f * cosf(marble_arg(spz, acc)) * gsum;
    const float k = acc > 0.0f ? 10.0f : acc < 0.0f ? -10.0f : 0.0f;
    const float gx = c * (k * dA[0]), gy = c * (k * dA[1]),
                gz = c * (1.0f + k * dA[2]);
    grad_point[3LL * i] = sc * gx;
    grad_point[3LL * i + 1] = sc * gy;
    grad_point[3LL * i + 2] = sc * gz;
    grad_scale[i] = px * gx + py * gy + pz * gz;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
noise_texture_kernel(Lanes a, Marble op, Tables t) {
  __shared__ Smem sh;
  stage_tables(sh, t);
  walk(sh, a, op);
}

__global__ void __launch_bounds__(kThreads, kGradMinBlocks)
noise_texture_grad_kernel(Lanes a, MarbleGrad op, Tables t) {
  __shared__ Smem sh;
  stage_tables(sh, t);
  walk(sh, a, op);
}

// Blocks `kernel` can keep resident on the current device (cached per
// device ordinal and kernel), or a negative CUDA error code.
template <class Kernel>
int resident_blocks(Kernel kernel, int* cache) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

int grid_for(int n, int resident) {
  const int tiles = (n + kTile - 1) / kTile;
  return tiles < resident ? tiles : resident;
}

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers:
// ttype [n] int32 and scale [n] float32 with element strides; point and
// value [n, 3] float32 with row strides (their columns contiguous);
// vectors [256, 3] float32, perm_x / perm_y / perm_z [256] int32, all
// contiguous; every output contiguous.  noise_tag is TT_NOISE.  The grid
// is the tiles, capped at the blocks the card holds at once (each block
// walks its tiles and stages the tables once).  Each launches on
// `stream` and returns cudaGetLastError() (0 on success, or the error of
// a device query); neither synchronises.

// K2: out [n, 3].
extern "C" int hrt_noise_texture(
    const int* ttype, long long ttype_stride, const float* scale,
    long long scale_stride, const float* point, long long point_stride,
    const float* value, long long value_stride, const float* vectors,
    const int* perm_x, const int* perm_y, const int* perm_z, int noise_tag,
    int n, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64];
  const int r = resident_blocks(noise_texture_kernel, resident);
  if (r < 0) return -r;
  noise_texture_kernel<<<grid_for(n, r), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      Lanes{ttype, ttype_stride, noise_tag, n},
      Marble{scale, scale_stride, point, point_stride, value, value_stride,
             out},
      Tables{vectors, perm_x, perm_y, perm_z});
  return static_cast<int>(cudaGetLastError());
}

// K2b: grad_out [n, 3] contiguous in; grad_point [n, 3], grad_scale [n],
// grad_value [n, 3] out.
extern "C" int hrt_noise_texture_grad(
    const int* ttype, long long ttype_stride, const float* scale,
    long long scale_stride, const float* point, long long point_stride,
    const float* grad_out, const float* vectors, const int* perm_x,
    const int* perm_y, const int* perm_z, int noise_tag, int n,
    float* grad_point, float* grad_scale, float* grad_value, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64];
  const int r = resident_blocks(noise_texture_grad_kernel, resident);
  if (r < 0) return -r;
  noise_texture_grad_kernel<<<grid_for(n, r), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      Lanes{ttype, ttype_stride, noise_tag, n},
      MarbleGrad{scale, scale_stride, point, point_stride, grad_out,
                 grad_point, grad_scale, grad_value},
      Tables{vectors, perm_x, perm_y, perm_z});
  return static_cast<int>(cudaGetLastError());
}
