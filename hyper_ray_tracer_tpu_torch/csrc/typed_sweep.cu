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
// Two spheres of a stage go through one __nv_bfloat162 instruction for
// one ray (the pair's f32 differences and dots each packed by one
// __floats2bfloat162_rn); __hmul2_rn / __hadd2_rn / __hsub2_rn keep every
// product and sum rounded on its own (no HFMA2 contraction), and a dot's
// FFMAs add exact products, so it rounds as a float32 add would
// (ops/typed_sweep.py sphere_t_bf16, dot3_bf16): the form is bit-equal to
// its plain twin.  The JAX package bounds a tile's
// candidates by t_max16 = bf16(the best t at the tile's start); this form
// takes the nearer root at or above t_min (else the farther) with no
// upper bound, which picks the same winners: a root above t_max16 =
// rn(T0) is above rn(T) for the running best T <= T0, and a bfloat16
// value above rn(T) is above T, so it never passes the strict float32
// test, nor does the farther root behind it.  Nor does a miss
// (bf16(3.0e38) in the JAX package, above float32's BIG).  A kBf16 = false
// instantiation compiles the float32 kernel alone, as before.
// Registers, shared memory and spills per instantiation: the ptxas report
// (chip_smoke.py phases 1 and 5).

#include <cuda_bf16.h>

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
// A plan row: 8 int32 (ops/typed_sweep.py PLAN_COLUMNS).
struct Tile {
  int start, width, type, motion, xform, axis, xf_off;
};

__device__ __forceinline__ Tile load_tile(const int4* __restrict__ plan,
                                          int k) {
  const int4 a = __ldg(&plan[2 * k]), b = __ldg(&plan[2 * k + 1]);
  return Tile{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

// 4-byte asynchronous copy global -> shared (cp.async.ca: the bf16
// tiles' squared radii, one float each).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
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

// x unchanged, as pin does for a float: a per-ray bf16 term stays out of
// the pair loop.
__device__ __forceinline__ __nv_bfloat162 pin2(__nv_bfloat162 x) {
  unsigned u = *reinterpret_cast<unsigned*>(&x);
  asm volatile("" : "+r"(u));
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// dot3 of float32 copies of bf16 values: the products are exact, so each
// FFMA rounds as the float32 add of the twin's left-to-right sum.
__device__ __forceinline__ float dot3_exact(float ax, float ay, float az,
                                            float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// A ray's bf16 terms: d rounded to bf16 (as float32, for the dots), and a
// = d.d and 1 / a, each held twice in a pair.
template <int R>
struct Bf16Rays {
  float dx[R], dy[R], dz[R];
  __nv_bfloat162 a[R], inv_a[R];
};

template <int R>
__device__ __forceinline__ void bf16_rays(const hrt::Packet<R>& pk,
                                          Bf16Rays<R>& br) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    br.dx[r] = hrt::pin(__bfloat162float(__float2bfloat16_rn(pk.dx[r])));
    br.dy[r] = hrt::pin(__bfloat162float(__float2bfloat16_rn(pk.dy[r])));
    br.dz[r] = hrt::pin(__bfloat162float(__float2bfloat16_rn(pk.dz[r])));
    const __nv_bfloat16 a = __float2bfloat16_rn(dot3_exact(
        br.dx[r], br.dy[r], br.dz[r], br.dx[r], br.dy[r], br.dz[r]));
    br.a[r] = pin2(__bfloat162bfloat162(a));
    br.inv_a[r] = pin2(__float2bfloat162_rn(
        __fdiv_rn(1.0f, __bfloat162float(a))));
  }
}

// Ray r's candidate of one sphere: the nearer root at or above t_min16,
// else the farther; it replaces the best only when strictly smaller.
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

// Fold spheres idx and idx + 1 (g0, g1; their bf16(r)^2 in rr) into every
// ray of the packet, one bf16x2 operation for both; two = false: g1 is g0
// again and only idx is folded.  The second phase runs only when some
// ray's line meets one of them, as hrt::fold_sphere's.
template <int R>
__device__ __forceinline__ void fold_sphere_pair_bf16(
    hrt::Packet<R>& pk, const Bf16Rays<R>& br, const float4 g0,
    const float4 g1, const __nv_bfloat162 rr, int idx, bool two,
    float t_min16) {
  __nv_bfloat162 half_b[R], disc[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 ocx = __bfloat1622float2(__floats2bfloat162_rn(
        __fsub_rn(pk.ox[r], g0.x), __fsub_rn(pk.ox[r], g1.x)));
    const float2 ocy = __bfloat1622float2(__floats2bfloat162_rn(
        __fsub_rn(pk.oy[r], g0.y), __fsub_rn(pk.oy[r], g1.y)));
    const float2 ocz = __bfloat1622float2(__floats2bfloat162_rn(
        __fsub_rn(pk.oz[r], g0.z), __fsub_rn(pk.oz[r], g1.z)));
    half_b[r] = __floats2bfloat162_rn(
        dot3_exact(ocx.x, ocy.x, ocz.x, br.dx[r], br.dy[r], br.dz[r]),
        dot3_exact(ocx.y, ocy.y, ocz.y, br.dx[r], br.dy[r], br.dz[r]));
    const __nv_bfloat162 c = __hsub2_rn(
        __floats2bfloat162_rn(
            dot3_exact(ocx.x, ocy.x, ocz.x, ocx.x, ocy.x, ocz.x),
            dot3_exact(ocx.y, ocy.y, ocz.y, ocx.y, ocy.y, ocz.y)),
        rr);
    disc[r] = __hsub2_rn(__hmul2_rn(half_b[r], half_b[r]),
                         __hmul2_rn(br.a[r], c));
    const float2 df = __bfloat1622float2(disc[r]);
    any = any || df.x >= 0.0f || df.y >= 0.0f;
  }
  if (!any) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 df = __bfloat1622float2(disc[r]);
    if (df.x >= 0.0f || df.y >= 0.0f) {
      const __nv_bfloat162 sq = __floats2bfloat162_rn(
          __fsqrt_rn(fmaxf(df.x, 0.0f)), __fsqrt_rn(fmaxf(df.y, 0.0f)));
      const __nv_bfloat162 nhb = __hneg2(half_b[r]);
      const float2 tn =
          __bfloat1622float2(__hmul2_rn(__hsub2_rn(nhb, sq), br.inv_a[r]));
      const float2 tf =
          __bfloat1622float2(__hmul2_rn(__hadd2_rn(nhb, sq), br.inv_a[r]));
      bf16_update(pk, r, df.x, tn.x, tf.x, idx, t_min16);
      if (two) bf16_update(pk, r, df.y, tn.y, tf.y, idx + 1, t_min16);
    }
  }
}

// Fold `count` staged records of a bf16 tile (first index idx0; the x of
// each aux record: its bf16(r)^2) into the packet, two spheres a trip.
template <int R>
__device__ __forceinline__ void fold_segment_bf16(hrt::Packet<R>& pk,
                                                  const float4* sg,
                                                  const float4* sa,
                                                  int count, int idx0,
                                                  float t_min) {
  const float t_min16 = __bfloat162float(__float2bfloat16_rn(t_min));
  Bf16Rays<R> br;
  bf16_rays<R>(pk, br);
#pragma unroll 1
  for (int j = 0; j < count; j += 2) {
    const bool two = j + 1 < count;
    const int k = two ? j + 1 : j;
    fold_sphere_pair_bf16<R>(pk, br, sg[j], sg[k],
                             __floats2bfloat162_rn(sa[j].x, sa[k].x),
                             idx0 + j, two, t_min16);
  }
}

// Issue the cp.async copies of the stage [lo, hi) into ring slot buf,
// walking the plan from tile `tile` (past the tiles that end at or before
// lo, which a left-out group's stages skip; left at the first tile that
// goes on past hi).  Only the records a tile's type reads are copied; a
// bf16 tile (kBf16) copies each sphere's rr16 into the x of its aux
// record, which a static sphere does not read.
template <bool kBf16>
__device__ __forceinline__ void stage_copy(
    const Ring& ring, int lo, int hi, int buf, int& tile,
    const int4* __restrict__ plan, int n_tiles,
    const float4* __restrict__ geo, const float4* __restrict__ aux,
    const float4* __restrict__ xf, const float* __restrict__ rr16) {
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
    const bool need_rr = kBf16 && bf16_tile(t);
    for (int j = threadIdx.x; j < b - a; j += kThreads) {
      hrt::cp_async16(sg + (a - lo) + j, geo + a + j);
      if (need_aux) hrt::cp_async16(sa + (a - lo) + j, aux + a + j);
      if (need_rr)
        cp_async4(reinterpret_cast<float*>(sa + (a - lo) + j), rr16 + a + j);
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
            fold_segment_bf16<R>(pk, sg, sa, n_seg, a, t_min);
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
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
                   const float* __restrict__ rr16,
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
                      geo, aux, xf, rr16);
  hrt::cp_async_commit();
  // Every thread, live or not, runs every stage: each has two barriers.
  for (int q = 0; cur.valid(); ++q) {
    const int buf = q & 1;
    {
      const Cursor nxt = cur.next();
      if (nxt.valid())
        stage_copy<kBf16>(ring, nxt.lo, nxt.hi(), buf ^ 1, copy_tile, plan,
                          n_tiles, geo, aux, xf, rr16);
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

template <int R>
int launch(const float* o, const float* d, const float* time,
           const unsigned char* active, const long long* bits, int n,
           const float4* geo, const float4* aux, const float4* xf,
           const int4* plan, int n_tiles, int p, const float2* shutter,
           bool has_xf, float t_min, const hrt::GroupArgs& groups,
           const float* rr16, float* t_out, int* best_out,
           cudaStream_t stream) {
  const size_t smem = sizeof(float4) * kStage * (has_xf ? 10 : 4);
  const int blocks = (n + kThreads * R - 1) / (kThreads * R);
  if (rr16 != nullptr)
    typed_sweep_kernel<R, true><<<blocks, kThreads, smem, stream>>>(
        o, d, time, active, bits, n, geo, aux, xf, plan, n_tiles, p,
        shutter, t_min, groups, rr16, t_out, best_out);
  else
    typed_sweep_kernel<R, false><<<blocks, kThreads, smem, stream>>>(
        o, d, time, active, bits, n, geo, aux, xf, plan, n_tiles, p,
        shutter, t_min, groups, nullptr, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: rays o, d [n,3], time [n] float32, active [n] (bool
// as bytes), bits [n] int64 words; records geo, aux [p] float4, xf
// [x,3] float4 (the transformed tiles' primitives), plan [n_tiles,8]
// int32 (start, width, type, motion, transform, rect axis, xf offset,
// group), the shutter table [slots] float2; the partitioned form's lane
// masks [n] uint8 (nullptr for the plain sweep) and n_groups <= 2 groups
// [g0_start, g0_end), [g1_start, g1_end) (sweep_sphere.cuh; the plan's
// tiles are cut at their bounds); outputs t_out [n] float32 and best_out
// [n] int32.  has_xf: some tile is transformed.  rr16 [p] float32, each
// sphere's bf16(bf16(r)^2) (bf16 values), selects the bf16 form; nullptr
// the float32 sweep.  A mask without groups,
// or groups without a mask, is refused.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int hrt_typed_sweep(const float* o, const float* d,
                               const float* time, const unsigned char* active,
                               const long long* bits, int n,
                               const float4* geo, const float4* aux,
                               const float4* xf, const int* plan,
                               int n_tiles, int p, const float2* shutter,
                               int has_xf, float t_min,
                               const unsigned char* mask, int n_groups,
                               int g0_start, int g0_end, int g1_start,
                               int g1_end, const float* rr16,
                               float* t_out, int* best_out, void* stream) {
  if (n <= 0 || n_tiles <= 0 || p <= 0 || n_groups < 0 ||
      n_groups > hrt::kMaxGroups || (mask == nullptr) != (n_groups == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const hrt::GroupArgs groups{mask, n_groups, {g0_start, g1_start},
                              {g0_end, g1_end}};
  return launch<hrt::kRays>(o, d, time, active, bits, n, geo, aux, xf,
                            reinterpret_cast<const int4*>(plan), n_tiles, p,
                            shutter, has_xf != 0, t_min, groups, rr16,
                            t_out, best_out,
                            static_cast<cudaStream_t>(stream));
}
