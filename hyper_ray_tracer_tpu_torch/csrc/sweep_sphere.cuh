// What the two sweep kernels (sphere_sweep.cu, K1; typed_sweep.cu, K1b)
// share: the ray packet, the packed sphere record and its pair test with
// the hoisted lerp factor, and the cp.async copies of the primitive ring.
//
// Ray packets.  A thread of a kThreads-thread block carries R rays in
// registers, rays base + r * kThreads + threadIdx.x for r < R, so every
// shared-memory record it reads (a warp-wide LDS.128 broadcast) feeds R
// pairs.  A ray that is inactive or past n still folds a harmless dummy
// ray (o = 0, d = +z) and is written as (BIG, -1) at the end; a thread
// with no active ray skips the folds but reaches every barrier.  A pair
// is folded in two phases: every ray's cheap test first (a sphere's
// discriminant, a box's slab interval), straight-line code; then, only
// when some ray of the packet passes it, the roots, range tests and
// update.
//
// The bound.  A sphere's (or a box's, or a rect's) candidate depends on
// its t_max only through rejection: a root above t_max is dropped, and
// the far root is taken only when the near one lies below t_min.  A
// candidate rejected against a ray's running best could not have
// replaced it, so folding with the running best as the inclusive t_max
// picks the same winner as any stale bound above it (the TPU kernel's
// tile bound, scan_all's tile-start bound), ties to the lower index
// included.  These folds bound by the running best; only media need the
// stale bound (typed_sweep.cu).
//
// The sphere record is two float4s:
//   geo = (cx, cy, cz, r * r)         center p0, squared radius
//   aux = (dpx, dpy, dpz, slot bits)  p1 - p0, shutter slot (int32) or -1
// The host computes p1 - p0, r * r and time1 - time0 with the same IEEE
// operations as the plain version (ops/intersect.py), once per scene.  A
// sphere whose center cannot move (p1 == p0, time0 = 0, time1 = 1) has
// slot -1 and is not lerped: p0 + f * 0 == p0 for every finite f, so that
// is exact.  Every other sphere names a slot of the shutter table
// (time0, time1 - time0); the lerp factor
// f = (time - time0) / (time1 - time0) depends on the ray and the slot
// alone, so a packet divides once per slot change, not once per pair.  The
// slot is the same for every thread of the block (every thread reads the
// same record), so that branch never diverges.
//
// Rounding: every step is one IEEE round-to-nearest operation (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) in the plain version's
// order, so nvcc cannot contract a * b + c into an FMA and no reciprocal
// replaces a division.  The kernels are bit-equal to their plain versions.
// Tensor cores (wgmma) have no place here: the work is a chain of scalar
// FP32 operations per ray-primitive pair with data-dependent branches,
// rounded exactly like the plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_hit.cuh"

namespace hrt {

constexpr int kThreads = 128;  // threads per block of both sweeps
constexpr int kRays = 4;       // rays per thread, the packet size R

// Per-ray words in shared memory: ray r of this thread's packet at
// word(r), so that a warp's accesses hit 32 banks.
__device__ __forceinline__ int word(int r) {
  return r * kThreads + threadIdx.x;
}

// Each ray's winning primitive index.  Only an update writes it (rare:
// a candidate below the running best), so it costs the pair loop no
// register; the running best t, which every second phase reads, stays in
// registers.
__shared__ int s_best[kRays * kThreads];

// 16-byte asynchronous copy global -> shared (cp.async.cg: through L2 only).
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int R>
struct Packet {
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R];
  float a[R];       // |d|^2 (per ray: sphere_roots' a)
  float f[R];       // lerp factor of shutter slot `slot`
  float t_best[R];  // running best (its index: s_best)
  bool on[R];       // active and in range
  int slot;    // the slot f holds, -1 for none yet
  bool live;   // any ray of the packet is on
};

template <int R>
__device__ __forceinline__ int packet_ray(int r) {
  return blockIdx.x * (kThreads * R) + r * kThreads + threadIdx.x;
}

template <int R>
__device__ __forceinline__ void load_packet(
    Packet<R>& pk, const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, int n) {
  pk.live = false;
  pk.slot = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ray = packet_ray<R>(r);
    pk.on[r] = ray < n && active[ray] != 0;
    pk.live = pk.live || pk.on[r];
    pk.ox[r] = pk.on[r] ? o[3 * ray] : 0.f;
    pk.oy[r] = pk.on[r] ? o[3 * ray + 1] : 0.f;
    pk.oz[r] = pk.on[r] ? o[3 * ray + 2] : 0.f;
    pk.dx[r] = pk.on[r] ? d[3 * ray] : 0.f;
    pk.dy[r] = pk.on[r] ? d[3 * ray + 1] : 0.f;
    pk.dz[r] = pk.on[r] ? d[3 * ray + 2] : 1.f;
    pk.a[r] = pin(dot3(pk.dx[r], pk.dy[r], pk.dz[r], pk.dx[r], pk.dy[r],
                       pk.dz[r]));
    pk.f[r] = 0.f;
    pk.t_best[r] = kBig;
    s_best[word(r)] = -1;
  }
}

template <int R>
__device__ __forceinline__ void store_packet(const Packet<R>& pk, int n,
                                             float* __restrict__ t_out,
                                             int* __restrict__ best_out) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ray = packet_ray<R>(r);
    if (ray < n) {
      t_out[ray] = pk.on[r] ? pk.t_best[r] : kBig;  // kBig for misses too
      best_out[ray] = pk.on[r] ? s_best[word(r)] : -1;
    }
  }
}

// The lerp factor of every ray of the packet for shutter slot `slot`
// (shutter[slot] = (time0, time1 - time0)): moving_sphere.rs:53-57.  The
// rays' times are read again here, on a slot change only, rather than
// held in registers through the sweep.
template <int R>
__device__ __forceinline__ void shutter_factor(
    Packet<R>& pk, int slot, const float2* __restrict__ shutter,
    const float* __restrict__ time) {
  if (slot == pk.slot) return;
  const float2 s = __ldg(&shutter[slot]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float tm = pk.on[r] ? time[packet_ray<R>(r)] : 0.f;
    pk.f[r] = pin(__fdiv_rn(__fsub_rn(tm, s.x), s.y));
  }
  pk.slot = slot;
}

// Update ray r's running best with candidate t: only a strictly smaller t
// replaces it, so ties keep the lower index.
template <int R>
__device__ __forceinline__ void update_best(Packet<R>& pk, int r, float t,
                                            int idx) {
  if (t < pk.t_best[r]) {
    pk.t_best[r] = t;
    s_best[word(r)] = idx;
  }
}

// Fold one sphere record (index idx) into every ray of the packet, each
// candidate bounded by the ray's running best.  kMotion = false: the
// record's aux is not read (no sphere of the range moves).  The second
// phase runs only when some ray's line meets the sphere (disc >= 0); a ray
// whose disc < 0 has no candidate.
template <int R, bool kMotion>
__device__ __forceinline__ void fold_sphere(
    Packet<R>& pk, const float4 geo, const float4 aux, int idx, float t_min,
    const float2* __restrict__ shutter, const float* __restrict__ time) {
  const int slot = kMotion ? __float_as_int(aux.w) : -1;
  if (kMotion && slot >= 0) shutter_factor(pk, slot, shutter, time);
  float half_b[R], disc[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float cx = geo.x, cy = geo.y, cz = geo.z;
    if (kMotion && slot >= 0) {
      cx = __fadd_rn(cx, __fmul_rn(pk.f[r], aux.x));
      cy = __fadd_rn(cy, __fmul_rn(pk.f[r], aux.y));
      cz = __fadd_rn(cz, __fmul_rn(pk.f[r], aux.z));
    }
    const float ocx = __fsub_rn(pk.ox[r], cx);
    const float ocy = __fsub_rn(pk.oy[r], cy);
    const float ocz = __fsub_rn(pk.oz[r], cz);
    half_b[r] = dot3(ocx, ocy, ocz, pk.dx[r], pk.dy[r], pk.dz[r]);
    const float c = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), geo.w);
    disc[r] = __fsub_rn(__fmul_rn(half_b[r], half_b[r]),
                        __fmul_rn(pk.a[r], c));
    any = any || disc[r] >= 0.0f;
  }
  if (!any) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (disc[r] >= 0.0f) {
      const float t_max = pk.t_best[r];
      const float sq = __fsqrt_rn(fmaxf(disc[r], 1e-30f));
      const float t_near = __fdiv_rn(__fsub_rn(-half_b[r], sq), pk.a[r]);
      const float t_far = __fdiv_rn(__fadd_rn(-half_b[r], sq), pk.a[r]);
      float t = kBig;
      if (t_near >= t_min && t_near <= t_max) {
        t = t_near;
      } else if (t_far >= t_min && t_far <= t_max) {
        t = t_far;
      }
      update_best(pk, r, t, idx);
    }
  }
}

}  // namespace hrt
