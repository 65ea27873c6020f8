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
// The partitioned form (ops/partition.py).  A lane carries a mask whose bit
// G-1-i says that its segment may meet group i's box (G <= kMaxGroups
// groups, each a range [start, end) of the primitives); the lane folds
// group i's records only when that bit is set, and every other record as
// before.  Each block cuts [0, p) at the groups' bounds into segments
// (plan_segments), leaves out the segments of a group that no ray of the
// block needs (__syncthreads_or of the rays' bits: no copy, no fold) and
// stages the rest in order, a stage never crossing a segment's bound.  In
// a group's stage a thread none of whose rays has the bit skips the fold;
// otherwise the rays without it are parked for the stage (park): their
// running best is -kBig, so no candidate passes their range test or
// replaces their best, exactly as the plain version's update is masked
// off for them, and it is restored after.  With no mask there is one
// segment, [0, p).
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
constexpr int kMaxGroups = 2;  // partition groups (ops/partition.py)
constexpr int kMaxSegments = 2 * kMaxGroups + 1;

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

// A parked ray's running best (park), at word(r).
__shared__ float s_park[kRays * kThreads];
// Each thread's rays' lane masks (load_masks), kept out of the registers.
__shared__ unsigned s_masks[kThreads];

// The partitioned form's arguments: each lane's mask [n] (nullptr for the
// plain sweep) and the groups' ranges.
struct GroupArgs {
  const unsigned char* mask;
  int n;  // groups, 0 with no mask
  int start[kMaxGroups], end[kMaxGroups];
};

// The block's segments (plan_segments): [lo, hi) in order, each with its
// group or -1.
struct Segments {
  int lo[kMaxSegments], hi[kMaxSegments], group[kMaxSegments];
  int n;
};
__shared__ Segments s_seg;

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

// Each ray's lane mask into s_masks[threadIdx.x], 8 bits a ray (ray r's at
// bit 8r), 0 for a ray that is off or with no mask.
template <int R>
__device__ __forceinline__ void load_masks(
    const Packet<R>& pk, const unsigned char* __restrict__ mask) {
  unsigned m = 0u;
  if (mask != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (pk.on[r])
        m |= static_cast<unsigned>(mask[packet_ray<R>(r)]) << (8 * r);
  }
  s_masks[threadIdx.x] = m;
}

// Group i's bit in a lane's mask.
__device__ __forceinline__ unsigned group_bit(const GroupArgs& g, int i) {
  return 1u << (g.n - 1 - i);
}

// Whether some ray of this thread's packet has mask bit `bit`.
__device__ __forceinline__ bool thread_has(unsigned masks, unsigned bit) {
  return (masks & (bit * 0x01010101u)) != 0u;
}

// Cut [0, p) at the groups' bounds into s_seg, leaving out the segments of
// a group that no ray of the block needs.  Every thread of the block calls
// it, after load_masks; it ends on a barrier.
__device__ __forceinline__ void plan_segments(const GroupArgs& g, int p) {
  const unsigned masks = s_masks[threadIdx.x];
  bool need[kMaxGroups];
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i)  // g.n is the same for every thread
    need[i] = i < g.n && __syncthreads_or(thread_has(masks, group_bit(g, i)));
  if (threadIdx.x == 0) {
    int cuts[2 * kMaxGroups + 2];
    int nc = 0;
    cuts[nc++] = 0;
    cuts[nc++] = p;
    for (int i = 0; i < g.n; ++i) {
      cuts[nc++] = min(max(g.start[i], 0), p);
      cuts[nc++] = min(max(g.end[i], 0), p);
    }
    for (int i = 1; i < nc; ++i)  // insertion sort of at most 6
      for (int j = i; j > 0 && cuts[j - 1] > cuts[j]; --j) {
        const int c = cuts[j];
        cuts[j] = cuts[j - 1];
        cuts[j - 1] = c;
      }
    int n = 0;
    for (int k = 0; k + 1 < nc; ++k) {
      const int lo = cuts[k], hi = cuts[k + 1];
      if (hi <= lo) continue;
      int group = -1;
      for (int i = 0; i < g.n; ++i)
        if (g.start[i] <= lo && lo < g.end[i]) group = i;
      if (group >= 0 && !need[group]) continue;
      s_seg.lo[n] = lo;
      s_seg.hi[n] = hi;
      s_seg.group[n] = group;
      ++n;
    }
    s_seg.n = n;
  }
  __syncthreads();
}

// A stage of the block's ring: [lo, hi()) of segment seg, at most kStage
// records.
template <int kStage>
struct Cursor {
  int seg, lo;
  __device__ __forceinline__ static Cursor first() {
    return Cursor{0, s_seg.n > 0 ? s_seg.lo[0] : 0};
  }
  __device__ __forceinline__ bool valid() const { return seg < s_seg.n; }
  __device__ __forceinline__ int hi() const {
    return min(lo + kStage, s_seg.hi[seg]);
  }
  __device__ __forceinline__ int group() const { return s_seg.group[seg]; }
  __device__ __forceinline__ Cursor next() const {
    const int h = hi();
    if (h < s_seg.hi[seg]) return Cursor{seg, h};
    return Cursor{seg + 1, seg + 1 < s_seg.n ? s_seg.lo[seg + 1] : 0};
  }
};

// Before a stage of group `group`: whether this thread folds it (some ray
// of its packet has the group's bit), and if so, park the rays whose mask
// lacks the bit (see "The partitioned form").
template <int R>
__device__ __forceinline__ bool park(Packet<R>& pk, const GroupArgs& g,
                                     int group) {
  const unsigned masks = s_masks[threadIdx.x], bit = group_bit(g, group);
  if (!thread_has(masks, bit)) return false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (((masks >> (8 * r)) & bit) == 0u) {
      s_park[word(r)] = pk.t_best[r];
      pk.t_best[r] = -kBig;
    }
  }
  return true;
}

// After the stage: restore the parked rays, the only ones whose running
// best is -kBig (a fold never lowers a best below t_min).
template <int R>
__device__ __forceinline__ void unpark(Packet<R>& pk) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (pk.t_best[r] == -kBig) pk.t_best[r] = s_park[word(r)];
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
