// The noise texture's marble value from the scene's Perlin tables in
// shared memory, as device functions that the noise branch's kernels
// (turbulence.cu: K2 and its backward K2b) and the fused shading kernel
// (shade.cu: K6) share, so that the marble's arithmetic has one source.
//
// Contract: marble(sp) = 0.5 * (1 + sin(sp_z + 10 * |S(sp)|)) at the
// pre-scaled point sp = scale * point, with S = sum_{k<7} 0.5^k
// noise(2^k sp) and noise the reference's gradient noise
// (perlin_noise.rs: three axis permutations XORed into the lattice
// hash, cube-corner-biased unit gradients, the smoothed fraction in both
// the lerp weights and the weight vector).
//
// Rounding: every floating-point step is one IEEE round-to-nearest
// operation (__fmul_rn, __fadd_rn, __fsub_rn) in the order of the plain
// version (ops/turbulence.py:noise_texture_plain, through
// ops/perlin.py:_noise_xyz and turbulence_xyz), so nvcc cannot contract
// a*b+c into an FMA.  floorf and the int cast come before & 255, so
// negative lattice coordinates wrap as two's complement.  sinf is the
// CUDA math library's (not __sinf), the function torch's CUDA sin
// calls.  The tables hold exactly the plain version's per-lane hashes
// (tests/test_torch_perlin.py), so the two agree bit for bit.
//
// Layout (turbulence.cu's design note): the gradients in kCopies copies,
// lane l reading copy l % kCopies, and each permutation entry the pair
// perm[i], perm[i + 1] already scaled to byte offsets of gradient rows,
// so that a corner's lookup address is one 3-way XOR.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hrt {

constexpr int kMarbleOctaves = 7;  // textures/noise_texture.rs:28

template <int kCopies>
struct PerlinSmem {
  static constexpr uint32_t kRow = kCopies * sizeof(float4);  // a row
  static_assert(255 * kRow < 65536, "a permutation pair packs two 16-bit "
                "offsets");
  float4 grad[256][kCopies];
  // perm[i] * kRow | perm[(i + 1) & 255] * kRow << 16
  uint32_t perm[3][256];
};

// The scene's tables in device memory: vectors [256, 3] float32,
// perm_x / perm_y / perm_z [256] int32.
struct PerlinTables {
  const float* vectors;
  const int* perm_x;
  const int* perm_y;
  const int* perm_z;
};

// Threads tid of nthreads copy the tables into `sh`; the caller
// synchronises the block before reading it.
template <int kCopies>
__device__ void stage_tables(PerlinSmem<kCopies>& sh, const PerlinTables& t,
                             int tid, int nthreads) {
  constexpr uint32_t kRow = PerlinSmem<kCopies>::kRow;
  for (int e = tid; e < 256 * kCopies; e += nthreads) {
    const int h = e / kCopies;
    sh.grad[h][e % kCopies] = make_float4(
        t.vectors[3 * h], t.vectors[3 * h + 1], t.vectors[3 * h + 2], 0.0f);
  }
  for (int e = tid; e < 3 * 256; e += nthreads) {
    const int* p = e < 256 ? t.perm_x : e < 512 ? t.perm_y : t.perm_z;
    const int i = e & 255;
    sh.perm[e >> 8][i] = static_cast<uint32_t>(p[i] & 255) * kRow |
                         static_cast<uint32_t>(p[(i + 1) & 255] & 255) * kRow
                             << 16;
  }
}

__device__ __forceinline__ float smooth(float u) {
  return __fmul_rn(__fmul_rn(u, u), __fsub_rn(3.0f, __fmul_rn(2.0f, u)));
}

// One octave's lattice cell: the smoothed fractions (and the raw ones,
// which the derivative needs) and the corners' gradient-row offsets.
struct Cell {
  float u[3], s[3];
  uint32_t o[3][2];  // byte offsets, this lane's copy folded into x
};

template <int kCopies>
__device__ __forceinline__ Cell cell(const PerlinSmem<kCopies>& sh, int q,
                                     float x, float y, float z) {
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

template <int kCopies>
__device__ __forceinline__ float4 corner_grad(const PerlinSmem<kCopies>& sh,
                                              const Cell& c, int dx, int dy,
                                              int dz) {
  const char* grad = reinterpret_cast<const char*>(sh.grad);
  return *reinterpret_cast<const float4*>(
      grad + (c.o[0][dx] ^ c.o[1][dy] ^ c.o[2][dz]));
}

// One octave of gradient noise (ops/perlin.py:_noise_xyz) from the
// tables, rounded as the plain version; `q` picks this lane's copy of the
// gradients.
template <int kCopies>
__device__ __forceinline__ float noise(const PerlinSmem<kCopies>& sh, int q,
                                       float x, float y, float z) {
  const Cell c = cell(sh, q, x, y, z);
  const float sx = c.s[0], sy = c.s[1], sz = c.s[2];
  // Corner offset 0: lerp weight 1 - s, weight vector s; offset 1: lerp
  // weight s, weight vector s - 1.
  const float ax = __fsub_rn(1.0f, sx), ay = __fsub_rn(1.0f, sy),
              az = __fsub_rn(1.0f, sz);
  const float bx = __fsub_rn(sx, 1.0f), by = __fsub_rn(sy, 1.0f),
              bz = __fsub_rn(sz, 1.0f);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float4 g = corner_grad(sh, c, dx, dy, dz);
    const float wx = dx ? sx : ax, wy = dy ? sy : ay, wz = dz ? sz : az;
    const float wv_dot = __fadd_rn(
        __fadd_rn(__fmul_rn(g.x, dx ? bx : sx), __fmul_rn(g.y, dy ? by : sy)),
        __fmul_rn(g.z, dz ? bz : sz));
    const float term = __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), wv_dot);
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  return acc;
}

// The signed turbulence sum at the pre-scaled point, rounded as the
// plain version (ops/perlin.py turbulence_sum_xyz).
template <int kCopies>
__device__ float octaves(const PerlinSmem<kCopies>& sh, int q, float px,
                         float py, float pz) {
  float acc = 0.0f;
  float sc = 1.0f, w = 1.0f;  // 2^k and 0.5^k, exact
#pragma unroll 1
  for (int k = 0; k < kMarbleOctaves; ++k) {
    const float term = __fmul_rn(
        w, noise(sh, q, __fmul_rn(px, sc), __fmul_rn(py, sc),
                 __fmul_rn(pz, sc)));
    acc = k == 0 ? term : __fadd_rn(acc, term);
    sc = __fmul_rn(sc, 2.0f);
    w = __fmul_rn(w, 0.5f);
  }
  return acc;
}

// The marble's argument z + 10 |turbulence| (ops/turbulence.py).
__device__ __forceinline__ float marble_arg(float pz, float acc) {
  return __fadd_rn(pz, __fmul_rn(10.0f, fabsf(acc)));
}

// The marble value from the pre-scaled point's z and its turbulence sum.
__device__ __forceinline__ float marble_value(float pz, float acc) {
  return __fmul_rn(0.5f, __fadd_rn(1.0f, sinf(marble_arg(pz, acc))));
}

}  // namespace hrt
