// Closest-hit sweep of rays against every primitive type (spheres and
// moving spheres, rects, solid boxes, medium spheres, medium boxes, with
// baked rigid transforms) (K1b), for NVIDIA Hopper (sm_90a).
//
// What it replaces: the JAX package traces these scenes with an XLA
// sweep, not a Pallas kernel: the planned scan_all of
// hyper_ray_tracer_tpu/ops/bvh.py:273-400 over the primitive intersector
// make_prim_intersector (ops/intersect.py:439-510).  This kernel computes
// that contract.  The primitives, in canonical order, come in plan tiles
// (a host-side table, one row per tile); every tile holds one primitive
// type.  For each tile in order, every ray computes the candidate t's with
// the best t it held at the tile's START as the inclusive t_max, and a
// candidate replaces the best only when strictly smaller, so ties go to
// the lowest index.  An inactive ray returns (BIG, -1).
//
// The bound.  For a sphere, rect or box, folding with the ray's running
// best as t_max picks scan_all's winner (sweep_sphere.cuh, "The bound"),
// so those tiles do.  The argument does not carry over to media: a
// medium's free flight compares the sampled distance against
// min(t_exit, t_max) (intersect.py:403-412), so whether a medium is hit
// depends on t_max, and only scan_all's stale per-tile bound reproduces
// its decisions.  A medium tile folds with the best t each ray held at
// the tile's start (kept in shared memory while the tile spans stages)
// and a running best: that picks the tile's first-minimum argmin
// followed by a strict < against the tile-start best.  A medium's
// uniform is the ray's bounce word through the port's stream_bits
// (ops/rng.py, purpose P_MEDIUM, salt stable_id), computed here in native
// uint32; the wrapper passes the words as int64 and the kernel narrows
// them.
//
// Rounding: as K1 (sweep_sphere.cuh), in the order of the plain version
// (ops/typed_sweep.py:typed_sweep_plain via ops/intersect.py).  The
// slab's 1e-20 floor and the rect's dk == 0 guard are kept.  The medium's
// log is the CUDA math library's logf (no fast math), the function
// torch's CUDA log calls.  The hit detailer finds a box's face by
// comparing the winning t with six slab t's it recomputes in torch, so the
// two must agree bit for bit, and do.
//
// What bounds it on this card: FP32 issue, as K1: 18-25 operations per
// ray-primitive pair before its hit test (a sphere 18, a rect 12, a box
// 25; a moving sphere's lerp 6 more, a transform 33 more) against 37 bytes
// read and 8 written per ray.
//
// The first version (one thread per ray; 22 float slots per primitive
// staged 128 at a time; two barriers per stage with nothing overlapping
// the copy) ran at about 14% of its bound.  It computed per pair what
// depends on the ray alone: |d|^2 for every sphere, three correctly
// rounded slab reciprocals for every box, the medium's ray length, and a
// motion tile's lerp division for every sphere of the tile.  This one:
// - hoists those per-ray terms: |d|^2 once per ray, the slab reciprocals
//   and the ray length once per ray and tile segment, the lerp factor once
//   per ray and shutter slot; only the spheres that move are lerped
//   (their record's slot, sweep_sphere.cuh).  In a transformed tile the
//   direction is the pair's own, so there they stay per pair.
// - packs each type into two 16-byte records (geo, aux), plus three for
//   the transform (xf) in transformed tiles only:
//     sphere         geo (cx, cy, cz, r*r)  aux (p1 - p0, shutter slot)
//     medium sphere  geo (cx, cy, cz, r*r)  aux (nid, stable_id, 0, 0)
//     rect           geo (a0, b0, k, a1)    aux (b1, 0, 0, 0)
//     box            geo (p0, 0)            aux (p1, 0)
//     medium box     geo (p0, nid)          aux (p1, stable_id)
//     xf             R row-major, then t: 12 floats
//   A static-sphere tile stages geo alone.
// - carries R rays per thread (sweep_sphere.cuh), folds sphere tiles with
//   K1's routine (hrt::fold_sphere) and box tiles in the same two phases
//   (the slab interval, then the range test only where some ray's line
//   meets the box).
// - streams the records through a double-buffered ring of kStage-record
//   stages filled by cp.async, stage k + 1 in flight while stage k is
//   folded.  Stages are cut from the canonical order regardless of plan
//   tiles: a stage folds the segments of every tile it overlaps, and a
//   medium tile that spans stages keeps its start bound across them.
// The partitioned form (sweep_sphere.cuh): the plan is cut at the groups'
// bounds (a tile lies in one group at most), so are the stages; a block
// stages and folds no group that none of its rays needs, and in a group's
// stages the rays whose mask lacks the group are parked.  The plan walk
// skips the tiles of a group that was left out.
// The bf16 form (RenderSettings.bf16_hits; the JAX package's
// make_scan_intersector(..., bf16=True), ops/bvh.py:47-104 and :254-366).
// A tile of static, untransformed spheres (plan columns type, motion and
// transform) computes its candidate t's in bfloat16, rounded as the JAX
// package's jitted XLA rounds them: oc = o - c in float32, then rounded;
// the three-term dots half_b = oc.d and oc.oc (and a = d.d per ray) as
// float32 sums, left to right, of products that are exact in float32 (8
// + 8 bits), each dot rounded to bf16 once; c = oc.oc - bf16(bf16(r)^2),
// the discriminant and the roots each one rounded bf16 operation; the
// square root and 1/a in float32, correctly rounded, then rounded to bf16
// (exact as a bf16 operation: 24 >= 2 * 8 + 2 bits).  The candidate,
// upcast, replaces the running float32 best only when strictly smaller.
// Every step is rounded on its own: a bf16x2 operation is PTX's
// add/sub/mul.rn.bf16x2 (.rn: never contracted into an HFMA2), a dot's
// FFMAs add exact products, so it rounds as a float32 add would
// (ops/typed_sweep.py sphere_t_bf16, dot3_bf16): the form is bit-equal to
// its plain twin.  The JAX package bounds a tile's
// candidates by t_max16 = bf16(the best t at the tile's start); this form
// takes the nearer root at or above t_min (else the farther) with no
// upper bound, which picks the same winners: a root above t_max16 =
// rn(T0) is above rn(T) for the running best T <= T0, and a bfloat16
// value above rn(T) is above T, so it never passes the strict float32
// test, nor does the farther root behind it.  Nor does a miss
// (bf16(3.0e38) in the JAX package, above float32's BIG).
// Its design.  The form is bound by instruction issue, as the float32
// sweep: per ray and pair of spheres it needs 6 float32 differences (oc),
// 6 roundings of them, 12 multiplies and FFMAs (the dots), 2 packs and 4
// bf16x2 operations (c and the discriminant of both spheres at once), all
// on the FMA pipes (tune_bf16.py: an F2FP issues at half FFMA's rate, a
// bf16x2 operation waits 8 cycles for its operand where FFMA waits 4).
// - Its own kernel, typed_sweep_kernel<kBf16Rays, true>, with its own
//   launch shape (kBf16Rays rays a thread, kBf16MinBlocks resident blocks,
//   kBf16Pairs pairs of spheres a trip under one sign test; measured by
//   tune_bf16.py), so that ptxas spills nothing; the float32 kernel keeps
//   its own.  The packet's float32 terms that the loop never reads wait
//   in shared memory through a bf16 segment (hold, release), and 1 / a,
//   which only the roots read, too: their registers go to warps.
// - No bf16x2 word is unpacked in the pair loop.  A float32 is rounded to
//   bf16 in place by one F2FP (cvt.rn.bf16x2.f32 of x and 0: bf16(x) in
//   the high half, 0 in the low, which is bf16(x) as a float32), so oc
//   feeds the dots without a pack and an unpack; the dots of both spheres
//   are packed by one F2FP each; and the discriminants are tested by
//   their sign bits, ANDed per ray and over the packet: a set sign in
//   all of them rules out disc >= 0 (a discriminant is never -0: hb * hb
//   is not).
// - The roots are rare: on `sphereflake`'s camera rays 1.4% of the pairs
//   have a bf16 disc >= 0, in 3.9% of the (32 rays, 2 spheres) blocks a
//   warp folds at once (chip_smoke.py phase 27).  So they stay a branch
//   per ray and pair, taken by the warp together, which unpacks, tests
//   disc >= 0 exactly (a clear sign may be a NaN's) and updates, in index
//   order.  Their square root is MUFU's (sqrt_of_bf16).
// - One record a sphere: a bf16 tile stages its spheres' bf16 records
//   (center, bf16(bf16(r)^2); SweepScene.geo16, built on the device) in
//   place of the float32 ones, one 16-byte cp.async and one shared read
//   a sphere.
// The ring, its double buffer and its two barriers a stage, the plan walk
// and the partitioned form's parked rays are the float32 kernel's.  A
// kBf16 = false instantiation compiles the float32 kernel alone, as
// before.
// Registers, shared memory and spills per instantiation: the ptxas report
// (chip_smoke.py phases 1, 5 and 27).

#include "sweep_sphere.cuh"

namespace {

using hrt::box_slab;
using hrt::dot3;
using hrt::kBig;
using hrt::kBox;
using hrt::kMediumBox;
using hrt::kMediumSphere;
using hrt::kRect;
using hrt::kSphere;
using hrt::kThreads;
using hrt::medium_scatter_t;
using hrt::medium_uniform;
using hrt::ray_terms;
using hrt::RayTerms;
using hrt::rect_t;
using hrt::to_object;

constexpr int kMinBlocks = 5;  // resident blocks per SM: <= 96 registers
constexpr int kStage = 256;    // primitive records per ring slot
// The bf16 form's own launch shape (tune_bf16.py): rays a thread,
// resident blocks per SM (<= 85 registers), and pairs of spheres a trip
// of its loop (one sign test for them all).
constexpr int kBf16Rays = 2;
constexpr int kBf16MinBlocks = 6;
constexpr int kBf16Pairs = 6;
static_assert(kBf16Rays <= hrt::kRays, "the shared per-ray words");
// A plan row: 8 int32 (ops/typed_sweep.py PLAN_COLUMNS).
struct Tile {
  int start, width, type, motion, xform, axis, xf_off;
};

__device__ __forceinline__ Tile load_tile(const int4* __restrict__ plan,
                                          int k) {
  const int4 a = __ldg(&plan[2 * k]), b = __ldg(&plan[2 * k + 1]);
  return Tile{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

// Whether plan tile t folds in bf16 (ops/bvh.py:254-256's rule).
__device__ __forceinline__ bool bf16_tile(const Tile& t) {
  return t.type == kSphere && !t.motion && !t.xform;
}

// The media's bound: each ray's best t at the current medium tile's start,
// kept in shared memory through the tile (at hrt::word(r)).
__shared__ float s_bound[hrt::kRays * kThreads];

// The per-ray inputs a fold reads again where it needs them (a slot
// change, a medium tile), rather than holding them in registers.
struct RayInputs {
  const float* time;      // [n] shutter time
  const long long* bits;  // [n] bounce words of the media's uniform
};

// The ring: two slots of kStage geo and aux records, and of kStage * 3 xf
// records when the scene has a transformed tile.
struct Ring {
  float4* geo;
  float4* aux;
  float4* xf;
};

// The candidate t of one pair of a rect or medium tile, or of a
// transformed tile (f: the ray's lerp factor, read when a sphere's slot is
// >= 0).
template <int kType>
__device__ __forceinline__ float prim_t(const float4 g, const float4 m,
                                        int slot, float f, int axis,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        const RayTerms& rt, uint32_t bits,
                                        float t_min, float t_max) {
  if constexpr (kType == kSphere) {
    float cx = g.x, cy = g.y, cz = g.z;
    if (slot >= 0) {
      cx = __fadd_rn(cx, __fmul_rn(f, m.x));
      cy = __fadd_rn(cy, __fmul_rn(f, m.y));
      cz = __fadd_rn(cz, __fmul_rn(f, m.z));
    }
    return hrt::sphere_t(cx, cy, cz, g.w, ox, oy, oz, dx, dy, dz, rt.a,
                         t_min, t_max);
  } else if constexpr (kType == kRect) {
    return rect_t(g, m.x, axis, ox, oy, oz, dx, dy, dz, t_min, t_max);
  } else if constexpr (kType == kBox) {
    float entry, exit;
    box_slab(g, m, ox, oy, oz, rt, entry, exit);
    if (!(exit > entry)) return kBig;
    if (entry >= t_min && entry <= t_max) return entry;
    if (exit >= t_min && exit <= t_max) return exit;
    return kBig;
  } else if constexpr (kType == kMediumSphere) {
    const hrt::Roots r = hrt::sphere_roots(g.x, g.y, g.z, g.w, ox, oy, oz,
                                           dx, dy, dz, rt.a);
    if (!r.exists) return kBig;
    const float u = medium_uniform(bits, __float_as_uint(m.y));
    return medium_scatter_t(r.t_near, r.t_far, m.x, rt.len, t_min, t_max,
                            u);
  } else {  // kMediumBox
    float entry, exit;
    box_slab(g, m, ox, oy, oz, rt, entry, exit);
    if (!(exit > entry)) return kBig;
    const float u = medium_uniform(bits, __float_as_uint(m.w));
    return medium_scatter_t(entry, exit, g.w, rt.len, t_min, t_max, u);
  }
}

// Fold one box record (index idx) of an untransformed tile into every ray
// of the packet, in two phases as hrt::fold_sphere: every ray's slab
// interval first; then, only when some ray's line meets the box
// (exit > entry), the range tests and the update (ops/intersect.py box_t:
// the entry if in range, else the exit).  rt: the rays' slab reciprocals.
template <int R>
__device__ __forceinline__ void fold_box(hrt::Packet<R>& pk, const float4 g,
                                         const float4 m, const RayTerms* rt,
                                         int idx, float t_min) {
  float entry[R], exit[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    box_slab(g, m, pk.ox[r], pk.oy[r], pk.oz[r], rt[r], entry[r], exit[r]);
    any = any || exit[r] > entry[r];
  }
  if (!any) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (exit[r] > entry[r]) {
      const float t_max = pk.t_best[r];
      float t = hrt::kBig;
      if (entry[r] >= t_min && entry[r] <= t_max) {
        t = entry[r];
      } else if (exit[r] >= t_min && exit[r] <= t_max) {
        t = exit[r];
      }
      hrt::update_best(pk, r, t, idx);
    }
  }
}

// Fold `count` staged records of one tile (first index idx0) into the
// packet.  Untransformed tiles go record by record through the whole
// packet: spheres and boxes, nearly all of the work, in two phases bounded
// by the running best; rects and media one pair at a time, media bounded
// by the tile-start bound.  Transformed tiles (rare) go ray by ray through
// the records, so that only one ray's object-frame terms are live at a
// time and the kernel needs no more registers for them.
template <int R, int kType, bool kXform, bool kMotion>
__device__ __forceinline__ void fold_segment(
    hrt::Packet<R>& pk, const RayInputs& in,
    const float4* sg, const float4* sa, const float4* sx, int count,
    int idx0, int axis, float t_min, const float2* __restrict__ shutter) {
  constexpr bool kMedium = kType == kMediumSphere || kType == kMediumBox;
  uint32_t bits[R]{};
  float bound[R]{};
  if constexpr (kMedium) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // A word below 2^32.
      bits[r] = pk.on[r] ? static_cast<uint32_t>(
                               in.bits[hrt::packet_ray<R>(r)])
                         : 0u;
      bound[r] = s_bound[hrt::word(r)];
    }
  }
  if constexpr (kType == kSphere && !kXform) {  // K1's routine
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      const float4 g = sg[j];
      float4 m = g;
      if constexpr (kMotion) m = sa[j];
      hrt::fold_sphere<R, kMotion>(pk, g, m, idx0 + j, t_min, shutter,
                                   in.time);
    }
  } else if constexpr (!kXform) {
    RayTerms base[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      base[r] = ray_terms<kType>(pk.dx[r], pk.dy[r], pk.dz[r]);
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      const float4 g = sg[j];
      const float4 m = sa[j];
      if constexpr (kType == kBox) {
        fold_box<R>(pk, g, m, base, idx0 + j, t_min);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float t = prim_t<kType>(
              g, m, -1, 0.f, axis, pk.ox[r], pk.oy[r], pk.oz[r], pk.dx[r],
              pk.dy[r], pk.dz[r], base[r], bits[r], t_min,
              kMedium ? bound[r] : pk.t_best[r]);
          hrt::update_best(pk, r, t, idx0 + j);
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll 1
      for (int j = 0; j < count; ++j) {
        const float4 g = sg[j];
        const float4 m = sa[j];
        int slot = -1;
        if constexpr (kType == kSphere && kMotion) {
          slot = __float_as_int(m.w);
          if (slot >= 0) hrt::shutter_factor(pk, slot, shutter, in.time);
        }
        float ox = pk.ox[r], oy = pk.oy[r], oz = pk.oz[r];
        float dx = pk.dx[r], dy = pk.dy[r], dz = pk.dz[r];
        to_object(sx[3 * j], sx[3 * j + 1], sx[3 * j + 2], ox, oy, oz, dx,
                  dy, dz);
        const float t = prim_t<kType>(
            g, m, slot, pk.f[r], axis, ox, oy, oz, dx, dy, dz,
            ray_terms<kType>(dx, dy, dz), bits[r], t_min,
            kMedium ? bound[r] : pk.t_best[r]);
        hrt::update_best(pk, r, t, idx0 + j);
      }
    }
  }
}

// One float32 rounded to bfloat16, as float32 (its low half zero): one
// F2FP, the pack of x and 0.
__device__ __forceinline__ float round_bf16(float x) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(x), "f"(0.0f));
  return __uint_as_float(u);
}

// lo and hi rounded to bfloat16 and packed, lo in the low half: one F2FP.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// w unchanged, as hrt::pin does for a float: a per-ray bf16x2 term stays
// out of the pair loop.
__device__ __forceinline__ unsigned pin_word(unsigned w) {
  asm volatile("" : "+r"(w));
  return w;
}

// The halves of a bf16x2 word as float32: exact.
__device__ __forceinline__ float lo_f32(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Correctly rounded bf16x2 operations on packed words (.rn: never
// contracted into an HFMA2).
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned sub2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// dot3 of float32 copies of bf16 values: the products are exact, so each
// FFMA rounds as the float32 add of the twin's left-to-right sum.
__device__ __forceinline__ float dot3_exact(float ax, float ay, float az,
                                            float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// What a bf16 segment keeps in shared memory, at hrt::word(r): the
// float32 terms of the packet that its loop never reads (d, |d|^2, the
// lerp factor), parked from its start to its end, and each ray's 1 / a16
// (twice, a bf16x2 word), which only the roots read.  So neither holds a
// register through the loop.
constexpr int kHeld = 5;
__shared__ float s_held[kHeld][hrt::kRays * kThreads];
__shared__ unsigned s_inv_a[hrt::kRays * kThreads];

// x read from shared memory again, where the compiler cannot keep a copy
// in a register instead.
template <class T>
__device__ __forceinline__ T reread(const T& x) {
  return *static_cast<const volatile T*>(&x);
}

// A ray's bf16 terms: d rounded to bf16 (as float32, for the dots), and
// a = d.d held twice in a bf16x2 word; 1 / a goes to s_inv_a.
template <int R>
struct Bf16Rays {
  float dx[R], dy[R], dz[R];
  unsigned a[R];
};

template <int R>
__device__ __forceinline__ void bf16_rays(const hrt::Packet<R>& pk,
                                          Bf16Rays<R>& br) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    br.dx[r] = hrt::pin(round_bf16(pk.dx[r]));
    br.dy[r] = hrt::pin(round_bf16(pk.dy[r]));
    br.dz[r] = hrt::pin(round_bf16(pk.dz[r]));
    const float a = round_bf16(dot3_exact(br.dx[r], br.dy[r], br.dz[r],
                                          br.dx[r], br.dy[r], br.dz[r]));
    const float inv_a = __fdiv_rn(1.0f, a);
    br.a[r] = pin_word(pack_bf16(a, a));
    s_inv_a[hrt::word(r)] = pack_bf16(inv_a, inv_a);
  }
}

// Park the packet's float32 terms in s_held, and take them back.
template <int R>
__device__ __forceinline__ void hold(const hrt::Packet<R>& pk) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = hrt::word(r);
    s_held[0][w] = pk.dx[r];
    s_held[1][w] = pk.dy[r];
    s_held[2][w] = pk.dz[r];
    s_held[3][w] = pk.a[r];
    s_held[4][w] = pk.f[r];
  }
}

template <int R>
__device__ __forceinline__ void release(hrt::Packet<R>& pk) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = hrt::word(r);
    pk.dx[r] = reread(s_held[0][w]);
    pk.dy[r] = reread(s_held[1][w]);
    pk.dz[r] = reread(s_held[2][w]);
    pk.a[r] = reread(s_held[3][w]);
    pk.f[r] = reread(s_held[4][w]);
  }
}

// The square root of a non-negative bf16 value x (as float32), as
// float32: MUFU's approximate root, one instruction where the correctly
// rounded one takes a dozen and a slow path.  Rounded to bf16 after, it
// equals bf16(sqrt_rn(x)) on every non-negative bf16 value, +0 to +inf
// (all 32,641 are checked on the card: ops/typed_sweep.py bf16_sqrt), so
// the roots round as the contract says.
__device__ __forceinline__ float sqrt_of_bf16(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Ray r's candidate of one sphere (its discriminant and roots, bf16
// values as float32): the nearer root at or above t_min16, else the
// farther; it replaces the best only when strictly smaller.
template <int R>
__device__ __forceinline__ void bf16_update(hrt::Packet<R>& pk, int r,
                                            float disc, float t_near,
                                            float t_far, int idx,
                                            float t_min16) {
  if (disc >= 0.0f) {
    const float t = t_near >= t_min16 ? t_near
                    : t_far >= t_min16 ? t_far
                                       : kBig;
    hrt::update_best(pk, r, t, idx);
  }
}

// o - c0 and o - c1 (one coordinate, two spheres), each rounded to bf16
// (as float32).
__device__ __forceinline__ void oc_bf16(float o, float c0, float c1,
                                        float& v0, float& v1) {
  v0 = round_bf16(__fsub_rn(o, c0));
  v1 = round_bf16(__fsub_rn(o, c1));
}

// Fold the kPairs pairs of spheres idx, idx + 1, ... (records s[0..2 *
// kPairs): center, bf16(r)^2) into every ray of the packet, one bf16x2
// instruction for the two spheres of a pair; kTwo = false (kPairs = 1):
// the pair is s[0] twice and only idx is folded.  Every ray's
// discriminants first, straight-line code; then, only when one of them
// has a clear sign bit (a superset of disc >= 0: a NaN may have one), the
// roots of the rays that have one, tested exactly, a ray's spheres in
// index order.
template <int R, int kPairs, bool kTwo>
__device__ __forceinline__ void fold_spheres_bf16(hrt::Packet<R>& pk,
                                                  const Bf16Rays<R>& br,
                                                  const float4* s, int idx,
                                                  float t_min16) {
  static_assert(kTwo || kPairs == 1, "a single sphere is one pair");
  unsigned half_b[kPairs][R], disc[kPairs][R];
  unsigned ray_all[R];  // the AND of each ray's discriminant words
#pragma unroll
  for (int r = 0; r < R; ++r) ray_all[r] = 0xffffffffu;
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float4 s0 = s[2 * q], s1 = kTwo ? s[2 * q + 1] : s0;
    const unsigned rr = __byte_perm(__float_as_uint(s0.w),
                                    __float_as_uint(s1.w), 0x7632);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x0, y0, z0, x1, y1, z1;
      oc_bf16(pk.ox[r], s0.x, s1.x, x0, x1);
      oc_bf16(pk.oy[r], s0.y, s1.y, y0, y1);
      oc_bf16(pk.oz[r], s0.z, s1.z, z0, z1);
      half_b[q][r] = pack_bf16(
          dot3_exact(x0, y0, z0, br.dx[r], br.dy[r], br.dz[r]),
          dot3_exact(x1, y1, z1, br.dx[r], br.dy[r], br.dz[r]));
      const unsigned c = sub2(
          pack_bf16(dot3_exact(x0, y0, z0, x0, y0, z0),
                    dot3_exact(x1, y1, z1, x1, y1, z1)),
          rr);
      disc[q][r] = sub2(mul2(half_b[q][r], half_b[q][r]),
                        mul2(br.a[r], c));
      ray_all[r] &= disc[q][r];
    }
  }
  unsigned all = 0xffffffffu;
#pragma unroll
  for (int r = 0; r < R; ++r) all &= ray_all[r];
  if ((all & 0x80008000u) == 0x80008000u) return;  // every sign set
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((ray_all[r] & 0x80008000u) == 0x80008000u) continue;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const unsigned dw = disc[q][r];
      if ((dw & 0x80008000u) != 0x80008000u) {
        const float d0 = lo_f32(dw), d1 = hi_f32(dw);
        const unsigned sq = pack_bf16(sqrt_of_bf16(fmaxf(d0, 0.0f)),
                                      sqrt_of_bf16(fmaxf(d1, 0.0f)));
        const unsigned nhb = half_b[q][r] ^ 0x80008000u;  // -half_b
        const unsigned inv_a = reread(s_inv_a[hrt::word(r)]);
        const unsigned tn = mul2(sub2(nhb, sq), inv_a);
        const unsigned tf = mul2(add2(nhb, sq), inv_a);
        bf16_update(pk, r, d0, lo_f32(tn), lo_f32(tf), idx + 2 * q,
                    t_min16);
        if (kTwo)
          bf16_update(pk, r, d1, hi_f32(tn), hi_f32(tf), idx + 2 * q + 1,
                      t_min16);
      }
    }
  }
}

// Fold `count` staged bf16 records of a bf16 tile (first index idx0) into
// the packet: 2 * kBf16Pairs spheres a trip, then the pairs left, then
// the odd one.
template <int R>
__device__ __forceinline__ void fold_segment_bf16(hrt::Packet<R>& pk,
                                                  const float4* sg,
                                                  int count, int idx0,
                                                  float t_min) {
  constexpr int kTrip = 2 * kBf16Pairs;
  const float t_min16 = round_bf16(t_min);
  Bf16Rays<R> br;
  bf16_rays<R>(pk, br);
  hold<R>(pk);
  const int trips = count / kTrip;
#pragma unroll 1
  for (int j = 0; j < trips; ++j)
    fold_spheres_bf16<R, kBf16Pairs, true>(pk, br, sg + kTrip * j,
                                           idx0 + kTrip * j, t_min16);
  int j = trips * kTrip;
#pragma unroll 1
  for (; j + 1 < count; j += 2)
    fold_spheres_bf16<R, 1, true>(pk, br, sg + j, idx0 + j, t_min16);
  if (j < count)
    fold_spheres_bf16<R, 1, false>(pk, br, sg + j, idx0 + j, t_min16);
  release<R>(pk);
}

// Issue the cp.async copies of the stage [lo, hi) into ring slot buf,
// walking the plan from tile `tile` (past the tiles that end at or before
// lo, which a left-out group's stages skip; left at the first tile that
// goes on past hi).  Only the records a tile's type reads are copied; a
// bf16 tile (kBf16) copies its bf16 records (geo16) in place of geo.
template <bool kBf16>
__device__ __forceinline__ void stage_copy(
    const Ring& ring, int lo, int hi, int buf, int& tile,
    const int4* __restrict__ plan, int n_tiles,
    const float4* __restrict__ geo, const float4* __restrict__ aux,
    const float4* __restrict__ xf, const float4* __restrict__ geo16) {
  float4* sg = ring.geo + buf * kStage;
  float4* sa = ring.aux + buf * kStage;
  float4* sx = ring.xf + buf * 3 * kStage;
  while (tile < n_tiles) {
    const Tile t = load_tile(plan, tile);
    if (t.start + t.width <= lo) {
      ++tile;
      continue;
    }
    if (t.start >= hi) break;
    const int a = max(lo, t.start), b = min(hi, t.start + t.width);
    const bool need_aux = t.type != kSphere || t.motion;
    const float4* src = kBf16 && bf16_tile(t) ? geo16 : geo;
    for (int j = threadIdx.x; j < b - a; j += kThreads) {
      hrt::cp_async16(sg + (a - lo) + j, src + a + j);
      if (need_aux) hrt::cp_async16(sa + (a - lo) + j, aux + a + j);
    }
    if (t.xform) {
      const float4* src = xf + 3 * (t.xf_off + a - t.start);
      for (int j = threadIdx.x; j < 3 * (b - a); j += kThreads)
        hrt::cp_async16(sx + 3 * (a - lo) + j, src + j);
    }
    if (t.start + t.width > hi) break;  // the tile goes on in the next stage
    ++tile;
  }
}

// Fold ring slot buf (the stage [lo, hi)) into the packet, tile segment by
// tile segment, from tile `tile` on (walked as in stage_copy); kBf16: the
// bf16 tiles through the bf16 form.
template <int R, bool kBf16>
__device__ __forceinline__ void fold_stage(
    hrt::Packet<R>& pk, const RayInputs& in, const Ring& ring, int lo,
    int hi, int buf, int& tile, const int4* __restrict__ plan, int n_tiles,
    float t_min, const float2* __restrict__ shutter) {
  while (tile < n_tiles) {
    const Tile t = load_tile(plan, tile);
    if (t.start + t.width <= lo) {
      ++tile;
      continue;
    }
    if (t.start >= hi) break;
    if (t.start >= lo && (t.type == kMediumSphere || t.type == kMediumBox)) {
      // A medium tile begins here: scan_all's stale t_max.
#pragma unroll
      for (int r = 0; r < R; ++r) s_bound[hrt::word(r)] = pk.t_best[r];
    }
    const int a = max(lo, t.start), b = min(hi, t.start + t.width);
    const float4* sg = ring.geo + buf * kStage + (a - lo);
    const float4* sa = ring.aux + buf * kStage + (a - lo);
    const float4* sx = ring.xf + buf * 3 * kStage + 3 * (a - lo);
    const int n_seg = b - a, ax = t.axis;
    // The tile's type and flags are the same for the whole block: these
    // branches never diverge.
#define HRT_FOLD(TYPE, XF, MO)                                           \
  fold_segment<R, TYPE, XF, MO>(pk, in, sg, sa, sx, n_seg, a, ax, t_min, \
                                shutter)
    switch (t.type) {
      case kSphere:
        if constexpr (kBf16) {
          if (bf16_tile(t)) {
            fold_segment_bf16<R>(pk, sg, n_seg, a, t_min);
            break;
          }
        }
        if (t.xform) {
          if (t.motion) HRT_FOLD(kSphere, true, true);
          else HRT_FOLD(kSphere, true, false);
        } else {
          if (t.motion) HRT_FOLD(kSphere, false, true);
          else HRT_FOLD(kSphere, false, false);
        }
        break;
      case kRect:
        if (t.xform) HRT_FOLD(kRect, true, false);
        else HRT_FOLD(kRect, false, false);
        break;
      case kBox:
        if (t.xform) HRT_FOLD(kBox, true, false);
        else HRT_FOLD(kBox, false, false);
        break;
      case kMediumSphere:
        if (t.xform) HRT_FOLD(kMediumSphere, true, false);
        else HRT_FOLD(kMediumSphere, false, false);
        break;
      case kMediumBox:
        if (t.xform) HRT_FOLD(kMediumBox, true, false);
        else HRT_FOLD(kMediumBox, false, false);
        break;
      default:
        break;
    }
#undef HRT_FOLD
    if (t.start + t.width > hi) break;  // the tile goes on in the next stage
    ++tile;
  }
}

template <int R, bool kBf16>
__global__ void __launch_bounds__(kThreads,
                                  kBf16 ? kBf16MinBlocks : kMinBlocks)
typed_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ time,
                   const unsigned char* __restrict__ active,
                   const long long* __restrict__ bits, int n,
                   const float4* __restrict__ geo,
                   const float4* __restrict__ aux,
                   const float4* __restrict__ xf,
                   const int4* __restrict__ plan, int n_tiles, int p,
                   const float2* __restrict__ shutter, float t_min,
                   const hrt::GroupArgs groups,
                   const float4* __restrict__ geo16,
                   float* __restrict__ t_out, int* __restrict__ best_out) {
  extern __shared__ float4 smem[];
  // xf points past the geo and aux slots; with no transformed tile it is
  // never written or read.
  const Ring ring{smem, smem + 2 * kStage, smem + 4 * kStage};
  using Cursor = hrt::Cursor<kStage>;

  hrt::Packet<R> pk;
  hrt::load_packet<R>(pk, o, d, active, n);
  hrt::load_masks<R>(pk, groups.mask);
  hrt::plan_segments(groups, p);
  const RayInputs in{time, bits};

  int copy_tile = 0, fold_tile = 0;
  Cursor cur = Cursor::first();
  if (cur.valid())
    stage_copy<kBf16>(ring, cur.lo, cur.hi(), 0, copy_tile, plan, n_tiles,
                      geo, aux, xf, geo16);
  hrt::cp_async_commit();
  // Every thread, live or not, runs every stage: each has two barriers.
  for (int q = 0; cur.valid(); ++q) {
    const int buf = q & 1;
    {
      const Cursor nxt = cur.next();
      if (nxt.valid())
        stage_copy<kBf16>(ring, nxt.lo, nxt.hi(), buf ^ 1, copy_tile, plan,
                          n_tiles, geo, aux, xf, geo16);
    }
    hrt::cp_async_commit();  // possibly empty: keeps one group per stage
    hrt::cp_async_wait<1>();  // this stage has landed (this thread's copies)
    __syncthreads();          // ... and every other thread's
    const int group = cur.group();
    if (pk.live && (group < 0 || hrt::park<R>(pk, groups, group))) {
      fold_stage<R, kBf16>(pk, in, ring, cur.lo, cur.hi(), buf, fold_tile,
                           plan, n_tiles, t_min, shutter);
      if (group >= 0) hrt::unpark<R>(pk);
    }
    __syncthreads();  // this slot is read; the stage after next may refill it
    cur = cur.next();
  }
  hrt::store_packet<R>(pk, n, t_out, best_out);
}

// One form's launch: R rays a thread.
template <int R, bool kBf16>
int launch(const float* o, const float* d, const float* time,
           const unsigned char* active, const long long* bits, int n,
           const float4* geo, const float4* aux, const float4* xf,
           const int4* plan, int n_tiles, int p, const float2* shutter,
           bool has_xf, float t_min, const hrt::GroupArgs& groups,
           const float4* geo16, float* t_out, int* best_out,
           cudaStream_t stream) {
  const size_t smem = sizeof(float4) * kStage * (has_xf ? 10 : 4);
  const int blocks = (n + kThreads * R - 1) / (kThreads * R);
  typed_sweep_kernel<R, kBf16><<<blocks, kThreads, smem, stream>>>(
      o, d, time, active, bits, n, geo, aux, xf, plan, n_tiles, p, shutter,
      t_min, groups, geo16, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

__global__ void bf16_sqrt_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = round_bf16(sqrt_of_bf16(fmaxf(x[i], 0.0f)));
}

}  // namespace

// The bf16 form's square root on its own, for its check: out[i] =
// bf16(sqrt(max(x[i], 0))) as the roots compute it, for n float32 x[i]
// on the device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int hrt_bf16_sqrt(const float* x, float* out, int n,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bf16_sqrt_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: rays o, d [n,3], time [n] float32, active [n] (bool
// as bytes), bits [n] int64 words; records geo, aux [p] float4, xf
// [x,3] float4 (the transformed tiles' primitives), plan [n_tiles,8]
// int32 (start, width, type, motion, transform, rect axis, xf offset,
// group), the shutter table [slots] float2; the partitioned form's lane
// masks [n] uint8 (nullptr for the plain sweep) and n_groups <= 2 groups
// [g0_start, g0_end), [g1_start, g1_end) (sweep_sphere.cuh; the plan's
// tiles are cut at their bounds); outputs t_out [n] float32 and best_out
// [n] int32.  has_xf: some tile is transformed.  geo16 [p] float4, each
// sphere's bf16 record (center, bf16(bf16(r)^2)), selects the bf16 form;
// nullptr the float32 sweep.  A mask without groups, or groups without a
// mask, is refused.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); it never synchronises.
extern "C" int hrt_typed_sweep(const float* o, const float* d,
                               const float* time, const unsigned char* active,
                               const long long* bits, int n,
                               const float4* geo, const float4* aux,
                               const float4* xf, const int* plan,
                               int n_tiles, int p, const float2* shutter,
                               int has_xf, float t_min,
                               const unsigned char* mask, int n_groups,
                               int g0_start, int g0_end, int g1_start,
                               int g1_end, const float4* geo16,
                               float* t_out, int* best_out, void* stream) {
  if (n <= 0 || n_tiles <= 0 || p <= 0 || n_groups < 0 ||
      n_groups > hrt::kMaxGroups || (mask == nullptr) != (n_groups == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const hrt::GroupArgs groups{mask, n_groups, {g0_start, g1_start},
                              {g0_end, g1_end}};
  const int4* rows = reinterpret_cast<const int4*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geo16 != nullptr)
    return launch<kBf16Rays, true>(o, d, time, active, bits, n, geo, aux, xf,
                                   rows, n_tiles, p, shutter, has_xf != 0,
                                   t_min, groups, geo16, t_out, best_out, s);
  return launch<hrt::kRays, false>(o, d, time, active, bits, n, geo, aux, xf,
                                   rows, n_tiles, p, shutter, has_xf != 0,
                                   t_min, groups, nullptr, t_out, best_out,
                                   s);
}
