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
// bit for bit.  The forward's octaves and tables live in marble.cuh,
// which the fused shading kernel (shade.cu, K6) includes too.
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
// a noise lane sums each octave's analytic gradient.  What it needs of
// the forward, K2 saves when the branch's output requires grad (the
// kSave instantiation; without grad K2 writes nothing more): its ballot
// words, as a noise bitmask of one bit a lane, and each noise lane's
// signed turbulence sum S.  So:
// - K2b reads one bit a lane where a first design read the 4-byte type
//   from a column of the gathered int rows (28-byte rows, served in
//   32-byte sectors): ~40 bytes a lane on a sparse mask in place of ~68.
// - K2b takes sign(S) and z + 10 |S| from the saved S in place of
//   recomputing the seven octaves with K2's rounding, so its octave walk
//   is the derivative alone, and nvcc may contract it into FMAs: where
//   exact code reaches at most half the FMA-counted rate, this can reach
//   the whole.  The cell of each octave (the floor of 2^k sp) is the
//   forward's: sp = scale * point is rounded as K2 rounds it, and the
//   rest is exact.
// - Its register budget (kGradMinBlocks resident blocks: 80 registers
//   a thread at 3) and its octave loop's unrolling (kGradUnroll octaves
//   a trip) are tune_turbulence.py's fastest variant without spills.
//   Two octaves a trip, so that one octave's shared-memory lookups
//   overlap the other's arithmetic, timed no faster than one (within
//   3%), and 4 resident blocks spill.
// Bound by bytes on a sparse mask, by FP32 throughput on a dense one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "marble.cuh"

namespace {

// kSteps, kCopies and kMinBlocks are the fastest variant without spills
// of tune_turbulence.py (4 resident blocks cap a thread at 64 registers).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident-block floor for ptxas
constexpr int kGradMinBlocks = 3;  // the same for the backward kernel
constexpr int kGradUnroll = 1;     // octaves a trip of K2b's octave loop
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;  // flags each thread reads per tile
constexpr int kTile = kThreads * kSteps;
constexpr int kWords = kSteps * kWarps;  // a tile's ballot words
constexpr int kDepth = hrt::kMarbleOctaves;
constexpr int kCopies = 4;  // gradient table copies
static_assert(kWords % 32 == 0, "warp 0 scans kWords / 32 words a lane");

// The tables (marble.cuh), then the walk's tile.
struct Smem : hrt::PerlinSmem<kCopies> {
  int list[kTile];        // the tile's noise lanes, in launch order
  uint32_t ballot[kWords];
  int offset[kWords + 1];
};

// Where a walk takes its noise flags from: bit s of the result is lane
// base + s * kThreads + tid's.  K2 reads the texture type column.
struct TypeFlags {
  const int* ttype;
  long long ttype_stride;
  int noise_tag;

  __device__ __forceinline__ uint32_t operator()(int base, int tid, int n)
      const {
    int tt[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = base + s * kThreads + tid;
      tt[s] = i < n ? ttype[i * ttype_stride] : ~noise_tag;
    }
    uint32_t mine = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      mine |= static_cast<uint32_t>(tt[s] == noise_tag) << s;
    return mine;
  }
};

// K2b reads K2's saved bitmask: bit l of word w is lane 32 w + l's flag,
// a tile's warp-sized runs of lanes are whole words, and the words past
// the last lane are not read.
struct MaskFlags {
  const uint32_t* mask;

  __device__ __forceinline__ uint32_t operator()(int base, int tid, int n)
      const {
    const int lane = tid & 31, first = base + (tid & ~31);
    uint32_t word[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = first + s * kThreads;
      word[s] = i < n ? mask[i >> 5] : 0u;
    }
    uint32_t mine = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) mine |= (word[s] >> lane & 1u) << s;
    return mine;
  }
};

// The gradient of one octave of noise with respect to (x, y, z), added
// into d[0..2]: plain float operations, which nvcc may contract.  With
// the corner weights W_c = w_x w_y w_z (w = 1 - s at offset 0, s at 1)
// and D_c the corner's weight-vector dot, noise = sum_c W_c D_c and
//   d noise / d s_a = sum_c (+-(W_c / w_a) D_c + W_c g_c,a),
// + at offset 1 on axis a, - at 0; then d s / d u = 6 u (1 - u).
__device__ __forceinline__ void noise_slope(const Smem& sh, int q, float x,
                                            float y, float z, float* d) {
  const hrt::Cell c = hrt::cell(sh, q, x, y, z);
  const float s[3] = {c.s[0], c.s[1], c.s[2]};
  float w[3][2], v[3][2];  // lerp weight and weight-vector component
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w[a][0] = 1.0f - s[a];
    w[a][1] = s[a];
    v[a][0] = s[a];
    v[a][1] = s[a] - 1.0f;
  }
  float wxy[2][2], wyz[2][2], wxz[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wxy[i][j] = w[0][i] * w[1][j];
      wyz[i][j] = w[1][i] * w[2][j];
      wxz[i][j] = w[0][i] * w[2][j];
    }
  }
  float ds[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float4 g = hrt::corner_grad(sh, c, dx, dy, dz);
    const float dot = g.x * v[0][dx] + g.y * v[1][dy] + g.z * v[2][dz];
    const float lw = wxy[dx][dy] * w[2][dz];
    ds[0] += (dx ? wyz[dy][dz] : -wyz[dy][dz]) * dot + lw * g.x;
    ds[1] += (dy ? wxz[dx][dz] : -wxz[dx][dz]) * dot + lw * g.y;
    ds[2] += (dz ? wxy[dx][dy] : -wxy[dx][dy]) * dot + lw * g.z;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d[a] += ds[a] * (6.0f * c.u[a] * (1.0f - c.u[a]));
}

// d[0..2] = the gradient of the signed turbulence sum at the pre-scaled
// point.  The octave at 2^k weighs 0.5^k, so each octave's gradient
// counts once.  kGradUnroll octaves a trip.
__device__ void turbulence_slope(const Smem& sh, int q, float px, float py,
                                 float pz, float* d) {
  d[0] = d[1] = d[2] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < kDepth; k += kGradUnroll) {
#pragma unroll
    for (int u = 0; u < kGradUnroll; ++u) {
      if (k + u < kDepth) {
        const float sc = static_cast<float>(1 << (k + u));  // exact
        noise_slope(sh, q, px * sc, py * sc, pz * sc, d);
      }
    }
  }
}

// The walk both kernels share.  The block stages the tables, then takes
// tiles of kTile lanes: it reads their noise flags (lane
// base + s * kThreads + tid for s < kSteps: each load coalesced across
// the block), lets `op.other` write every lane's output that needs no
// turbulence, ballots the flags per warp (one word per 32 consecutive
// lanes, which `op.ballot` may keep) into a shared-memory list of the
// tile's noise lanes in launch order, and then all its threads work
// through that list with `op.noise`.
template <class Flags, class Op>
__device__ __forceinline__ void walk(Smem& sh, const Flags& flags, int n,
                                     const Op& op) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    uint32_t copy = 0;  // bit s: lane s is in range and not noise
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      copy |= static_cast<uint32_t>(base + s * kThreads + tid < n) << s;
    const uint32_t mine = flags(base, tid, n) & copy;
    copy &= ~mine;
    op.other(base + tid, mine, copy);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t b = __ballot_sync(0xFFFFFFFFu, mine >> s & 1u);
      if (lane == 0) {
        sh.ballot[s * kWarps + warp] = b;
        op.ballot(base + s * kThreads + warp * 32, b);
      }
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

// K2: the marble on noise lanes, the incoming value elsewhere.  With
// kSave (the branch's output requires grad), also what K2b needs: the
// ballot words as a noise bitmask, and each noise lane's signed
// turbulence sum.
template <bool kSave>
struct Marble {
  const float* scale;
  long long scale_stride;
  const float* point;
  long long point_stride;
  const float* value;
  long long value_stride;
  float* out;
  uint32_t* mask;  // [ceil(n / 32)], kSave only
  float* turb;     // [n], written on noise lanes, kSave only
  int n;

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

  // The ballot word of lanes first .. first + 31.
  __device__ __forceinline__ void ballot(int first, uint32_t word) const {
    if constexpr (kSave) {
      if (first < n) mask[first >> 5] = word;
    }
  }

  __device__ __forceinline__ void noise(const Smem& sh, int q, int i) const {
    const float sc = scale[i * scale_stride];
    const float* p = point + i * point_stride;
    const float pz = __fmul_rn(sc, p[2]);
    const float acc = hrt::octaves(sh, q, __fmul_rn(sc, p[0]),
                                   __fmul_rn(sc, p[1]), pz);
    if constexpr (kSave) turb[i] = acc;
    const float m = hrt::marble_value(pz, acc);
    float* o = out + 3LL * i;
    o[0] = m;
    o[1] = m;
    o[2] = m;
  }
};

// K2b: the vector-Jacobian product of K2 for the cotangent grad_out.
// On a noise lane, with m = 0.5 (1 + sin(sp_z + 10 |S|)), sp = scale *
// point and S the turbulence sum (K2's, saved):
//   g = (sum_c grad_out_c) dm/dsp,
//   dm/dsp = 0.5 cos(sp_z + 10 |S|) (e_z + 10 sign(S) dS/dsp),
//   grad_point = scale g, grad_scale = <point, g>, grad_value = 0;
// on every other lane grad_value = grad_out and the others are 0.
// sign(0) = 0, as torch's abs backward has it.
struct MarbleGrad {
  const float* scale;
  long long scale_stride;
  const float* point;
  long long point_stride;
  const float* turb;      // [n], K2's on noise lanes
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

  __device__ __forceinline__ void ballot(int, uint32_t) const {}

  __device__ __forceinline__ void noise(const Smem& sh, int q, int i) const {
    const float sc = scale[i * scale_stride];
    const float* p = point + i * point_stride;
    const float px = p[0], py = p[1], pz = p[2];
    const float* go = grad_out + 3LL * i;
    const float gsum = go[0] + go[1] + go[2];
    const float acc = turb[i];
    const float spz = __fmul_rn(sc, pz);
    float dA[3];
    turbulence_slope(sh, q, __fmul_rn(sc, px), __fmul_rn(sc, py), spz, dA);
    const float c = 0.5f * cosf(hrt::marble_arg(spz, acc)) * gsum;
    const float k = acc > 0.0f ? 10.0f : acc < 0.0f ? -10.0f : 0.0f;
    const float gx = c * (k * dA[0]), gy = c * (k * dA[1]),
                gz = c * (1.0f + k * dA[2]);
    grad_point[3LL * i] = sc * gx;
    grad_point[3LL * i + 1] = sc * gy;
    grad_point[3LL * i + 2] = sc * gz;
    grad_scale[i] = px * gx + py * gy + pz * gz;
  }
};

template <bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
noise_texture_kernel(TypeFlags flags, int n, Marble<kSave> op,
                     hrt::PerlinTables t) {
  __shared__ Smem sh;
  hrt::stage_tables(sh, t, threadIdx.x, kThreads);
  walk(sh, flags, n, op);
}

__global__ void __launch_bounds__(kThreads, kGradMinBlocks)
noise_texture_grad_kernel(MaskFlags flags, int n, MarbleGrad op,
                          hrt::PerlinTables t) {
  __shared__ Smem sh;
  hrt::stage_tables(sh, t, threadIdx.x, kThreads);
  walk(sh, flags, n, op);
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
// contiguous; every output and saved array contiguous.  noise_tag is
// TT_NOISE.  The grid is the tiles, capped at the blocks the card holds
// at once (each block walks its tiles and stages the tables once).  Each
// launches on `stream` and returns cudaGetLastError() (0 on success, or
// the error of a device query); neither synchronises.

// K2: out [n, 3]; with mask [ceil(n / 32)] uint32 and turb [n] float32
// both non-null, also the saved forward (K2's kSave instantiation), and
// with both null nothing more.
extern "C" int hrt_noise_texture(
    const int* ttype, long long ttype_stride, const float* scale,
    long long scale_stride, const float* point, long long point_stride,
    const float* value, long long value_stride, const float* vectors,
    const int* perm_x, const int* perm_y, const int* perm_z, int noise_tag,
    int n, float* out, uint32_t* mask, float* turb, void* stream) {
  if (n <= 0 || (mask == nullptr) != (turb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const TypeFlags flags{ttype, ttype_stride, noise_tag};
  const hrt::PerlinTables t{vectors, perm_x, perm_y, perm_z};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr) {
    static int resident[64];
    const int r = resident_blocks(noise_texture_kernel<false>, resident);
    if (r < 0) return -r;
    noise_texture_kernel<false><<<grid_for(n, r), kThreads, 0, s>>>(
        flags, n,
        Marble<false>{scale, scale_stride, point, point_stride, value,
                      value_stride, out, nullptr, nullptr, n},
        t);
  } else {
    static int resident[64];
    const int r = resident_blocks(noise_texture_kernel<true>, resident);
    if (r < 0) return -r;
    noise_texture_kernel<true><<<grid_for(n, r), kThreads, 0, s>>>(
        flags, n,
        Marble<true>{scale, scale_stride, point, point_stride, value,
                     value_stride, out, mask, turb, n},
        t);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2b: mask and turb as K2 saved them, grad_out [n, 3] contiguous in;
// grad_point [n, 3], grad_scale [n], grad_value [n, 3] out.
extern "C" int hrt_noise_texture_grad(
    const uint32_t* mask, const float* turb, const float* scale,
    long long scale_stride, const float* point, long long point_stride,
    const float* grad_out, const float* vectors, const int* perm_x,
    const int* perm_y, const int* perm_z, int n, float* grad_point,
    float* grad_scale, float* grad_value, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64];
  const int r = resident_blocks(noise_texture_grad_kernel, resident);
  if (r < 0) return -r;
  noise_texture_grad_kernel<<<grid_for(n, r), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      MaskFlags{mask}, n,
      MarbleGrad{scale, scale_stride, point, point_stride, turb, grad_out,
                 grad_point, grad_scale, grad_value},
      hrt::PerlinTables{vectors, perm_x, perm_y, perm_z});
  return static_cast<int>(cudaGetLastError());
}
