// Closest hit over the cluster layout (K5), for NVIDIA Hopper (sm_90a).
//
// What it replaces: the JAX package's cluster intersector traces with XLA,
// not a Pallas kernel: make_cluster_intersector
// (hyper_ray_tracer_tpu/ops/cluster_sweep.py:245), a scan over ray tiles
// that culls each run's cluster boxes per tile and visits the surviving
// clusters nearest first, over the geometry in the padded cluster order of
// models/clusters.py.  This kernel computes the port's contract
// (ops/cluster_sweep.py cluster_sweep_plain), which finds the same
// closest hits nearest first per ray instead of per tile.
//
// The contract, per active ray, with t_best = kBig and best = -1 at the
// start (per-ray nearest first):
// 1. the always-swept tail, group by group and slot by slot;
// 2. then each run in order, in windows of kWindow clusters in layout
//    order (a run holds up to 4,096).  With a box's slab distances
//    (b - o) * (1 / d), lo the largest of the per-axis minima and hi the
//    smallest of the maxima, the box admits the ray when
//    hi > max(lo, t_min); a NaN among its six slab distances misses it,
//    as NaN-propagating min and max do in torch (an axis-parallel ray
//    whose origin lies on a bound plane: 0 * inf).  A window's admitted
//    clusters are visited in ascending (lo, cluster index) order, the
//    order of a stable sort of the entries (lo's sign of zero does not
//    count); a cluster whose lo exceeds t_best at its turn ends the
//    window for that ray, since the entries ascend;
// 3. a visited cluster's slots, each tested by prim_lane.cuh's prim_t
//    with the running best as the inclusive t_max.  A slot wins with
//    t < t_best, or t == t_best and a lower slot index: K4's rule, so ties
//    go to the lowest slot in any visit order.  (The JAX package folds
//    with a strict < in its per-tile nearest-first order instead.)  Pad
//    slots (PT_NONE, NaN geometry) never hit.
// A medium's free flight is bounded by the running best, so a medium's
// slots are tested one after the other; any other type's t does not
// depend on its bound (a t beyond it comes back kBig), so its slots may be
// tested at once against the bound the group or cluster started with, the
// smallest (t, slot) then folded in: the same result.
//
// Where the order matters.  Without media, every visit order that tests
// the same slots gives the same (t, slot).  It changes the result only
// where a primitive's float32 t falls below its own cluster's box entry
// (a graze: the box is skipped under a nearer best although the
// primitive's t is nearer still), or on a medium.  This kernel and the
// plain version visit in the same order.
//
// One level.  The JAX package tests a run's super boxes first once it has
// SUPER_MIN_CLUSTERS (512) clusters or more (ops/cluster_sweep.py:96-105,
// 505-730).  A super box is the union of its members' boxes, and the slab
// test is monotone under union, so culling by supers first changes no
// result, and no scene of models/builders.py has a run that long at its
// defaults (`sphereflake`: 256 clusters): every run is one level here.
//
// Design: a warp a ray, four rays a block.  What bounds the first design
// (a thread a ray, clusters in layout order) was divergence: a warp
// stepped through the union of the clusters its 32 rays admitted, one
// slot at a time.  Here every lane works for one ray:
// - box tests: lane j tests clusters j, j + 32, ... of the window
//   (kPerLane each, neighbouring lanes on neighbouring 32-byte boxes, read
//   through __ldg) and keeps each admitted cluster's lo in its own words
//   of shared memory (registers are what limits the resident warps);
// - the next cluster is the warp's smallest (lo, index): two
//   __reduce_min_sync, of lo's bits in the float's order and then of the
//   index among the lanes that hold that lo; its owner drops it; the
//   window ends when that lo is +inf (none left) or above t_best;
// - a visit: lane j tests slots j, j + 32, ... of the cluster (9 rounds of
//   a `sphereflake` cluster's 264; neighbouring lanes read neighbouring
//   16-byte records) against the bound the cluster started with, keeps
//   its smallest (t, slot), and two more reductions give every lane the
//   warp's, folded with (t_best, best) by the tie rule.  A run of spheres
//   without motion or transform (a still-sphere run: `sphereflake`,
//   `random`) reads only each slot's geo record (16 bytes, not prim_t's
//   36: the tag, geo and aux), its pads NaN there;
// - a medium group or cluster: every lane folds its slots in order with
//   the running bound, the same loads and arithmetic in lock step, so
//   every lane ends with the same (t_best, best);
// - the tail: each group as a visit.
// The constants below are tune_cluster.py's fastest choice without spills
// on an H100 (PERF.md §6): a floor of kMinBlocks blocks (79 registers).
// Every lane holds the ray's (t_best, best) after each visit, so all
// control flow but a visit's last partial round is uniform across the
// warp; lane 0 writes the result.  A lane's shutter-lerp cache (Ray.slot,
// Ray.f) sees its own slots; f is a function of the ray's time and the
// slot's shutter row, so it does not depend on which lane computed it.
// The per-type hit functions are prim_hit.cuh's, shared with K1b and K4.
//
// Rounding: as prim_hit.cuh (__f*_rn, no contraction, true divisions), in
// the order of the plain version.

#include "prim_lane.cuh"

namespace {

using hrt::kBig;
using hrt::Prims;
using hrt::Ray;

// The launch shape, which tune_cluster.py measures.
constexpr int kWarp = 32;
constexpr int kWarps = 4;      // rays a block
constexpr int kMinBlocks = 6;  // resident blocks ptxas sizes for (0: none)
constexpr int kThreads = kWarp * kWarps;
// Clusters a ray orders at once: ops/cluster_sweep.py WINDOW, which the
// wrapper checks against hrt_cluster_sweep_window().
constexpr int kWindow = 256;
constexpr int kPerLane = kWindow / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// (t, s) before (u, v): a smaller t, or an equal t and a lower index.
__device__ __forceinline__ bool before(float t, int s, float u, int v) {
  return t < u || (t == u && s < v);
}

// A float's bits as an unsigned integer in the float's order (-0.0 just
// below 0.0; no NaN comes here), and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The warp's smallest (t, s) by before(), on every lane (s may be -1).
__device__ __forceinline__ void warp_min(float& t, int& s) {
  const unsigned k = __reduce_min_sync(kFull, order_key(t));
  s = __reduce_min_sync(kFull, order_key(t) == k ? s : 0x7fffffff);
  t = key_value(k);
}

// The entry lo of the box (lo4.xyz, hi4.xyz) along the ray when the
// contract's slab test admits it, else +inf.
__device__ __forceinline__ float entry(const float4 lo4, const float4 hi4,
                                       const Ray& r, float t_min) {
  const float x0 = __fmul_rn(__fsub_rn(lo4.x, r.ox), r.ix);
  const float x1 = __fmul_rn(__fsub_rn(hi4.x, r.ox), r.ix);
  const float y0 = __fmul_rn(__fsub_rn(lo4.y, r.oy), r.iy);
  const float y1 = __fmul_rn(__fsub_rn(hi4.y, r.oy), r.iy);
  const float z0 = __fmul_rn(__fsub_rn(lo4.z, r.oz), r.iz);
  const float z1 = __fmul_rn(__fsub_rn(hi4.z, r.oz), r.iz);
  if (isnan(x0) || isnan(x1) || isnan(y0) || isnan(y1) || isnan(z0) ||
      isnan(z1))
    return inf();
  const float lo =
      fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float hi =
      fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  // + 0 turns -0.0 into 0.0: the order counts no sign of zero.
  return hi > fmaxf(lo, t_min) ? __fadd_rn(lo, 0.0f) : inf();
}

// How a group's or a cluster's slots are tested.
enum Kind { kSplit, kInOrder, kStillSpheres };

// prim_t of a slot of a sphere run without motion or transform (its
// kSphere case with no shutter slot), from the geo record alone: a pad's
// record is NaN there, and misses.
__device__ __forceinline__ float still_sphere_t(const Ray& ray, int pid,
                                                const Prims& pr, float t_min,
                                                float t_max) {
  const float4 g = __ldg(&pr.geo[pid]);
  return hrt::sphere_t(g.x, g.y, g.z, g.w, ray.ox, ray.oy, ray.oz, ray.dx,
                       ray.dy, ray.dz, ray.rt.a, t_min, t_max);
}

// Slots first .. first + count - 1 split across the lanes, each tested
// against the bound at the start, then the warp's smallest (t, slot)
// folded into (t_best, best) on every lane.
template <bool kStillOnly>
__device__ __forceinline__ void visit_split(Ray& ray, int lane, int first,
                                            int count, const Prims& pr,
                                            float t_min, float& t_best,
                                            int& best) {
  const float bound = t_best;
  float t = t_best;
  int s = best;
  for (int j = lane; j < count; j += kWarp) {
    const float u = kStillOnly
                        ? still_sphere_t(ray, first + j, pr, t_min, bound)
                        : hrt::prim_t(ray, first + j, pr, t_min, bound);
    if (before(u, first + j, t, s)) {
      t = u;
      s = first + j;
    }
  }
  warp_min(t, s);
  t_best = t;
  best = s;
}

// Slots first .. first + count - 1 folded into (t_best, best) on every
// lane: a medium's in order with the running bound, every lane alike.
__device__ __forceinline__ void visit(Ray& ray, int lane, int first,
                                      int count, Kind kind, const Prims& pr,
                                      float t_min, float& t_best, int& best) {
  if (kind == kInOrder)
    hrt::test_range(ray, first, count, pr, t_min, t_best, best);
  else if (kind == kStillSpheres)
    visit_split<true>(ray, lane, first, count, pr, t_min, t_best, best);
  else
    visit_split<false>(ray, lane, first, count, pr, t_min, t_best, best);
}

// tail [n_tail] int4: (first slot, slots, transformed, medium); runs
// [n_runs] two int4: (first slot, clusters, slots a cluster,
// transformed), (first box row, type, moving, 0); boxes [clusters] two
// float4: (min, 0), (max, 0).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cluster_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ time,
                     const unsigned char* __restrict__ active,
                     const long long* __restrict__ bits, int n,
                     const int4* __restrict__ tail, int n_tail,
                     const int4* __restrict__ runs, int n_runs,
                     const float4* __restrict__ boxes, Prims pr, float t_min,
                     float* __restrict__ t_out, int* __restrict__ best_out) {
  // A lane's kPerLane entries: lo(q) is cluster lane + q * kWarp's.  A
  // lane reads and writes only its own, so nothing waits for another.
  __shared__ float s_lo[kThreads * kPerLane];
  float* const own =
      s_lo + threadIdx.x / kWarp * kWindow + threadIdx.x % kWarp;
  auto lo = [&](int q) -> float& { return own[q * kWarp]; };
  const int lane = threadIdx.x % kWarp;
  const int i = blockIdx.x * kWarps + threadIdx.x / kWarp;  // the ray
  if (i >= n) return;  // the whole warp
  float t_best = kBig;
  int best = -1;
  if (active[i]) {
    Ray ray = hrt::load_ray(i, o, d, time, bits);
    for (int g = 0; g < n_tail; ++g) {
      const int4 grp = __ldg(&tail[g]);
      Prims frame = pr;
      frame.has_xf = grp.z != 0;
      visit(ray, lane, grp.x, grp.y, grp.w != 0 ? kInOrder : kSplit, frame,
            t_min, t_best, best);
    }
    for (int r = 0; r < n_runs; ++r) {
      const int4 run = __ldg(&runs[2 * r]);
      const int4 row = __ldg(&runs[2 * r + 1]);
      Prims frame = pr;
      frame.has_xf = run.w != 0;
      const Kind kind =
          row.y == hrt::kMediumSphere || row.y == hrt::kMediumBox ? kInOrder
          : row.y == hrt::kSphere && row.z == 0 && run.w == 0 ? kStillSpheres
                                                              : kSplit;
      for (int c0 = 0; c0 < run.y; c0 += kWindow) {
        const int m = min(kWindow, run.y - c0);
        const float4* box = boxes + 2 * (row.x + c0);
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + q * kWarp;
          lo(q) = c < m ? entry(__ldg(&box[2 * c]), __ldg(&box[2 * c + 1]),
                                ray, t_min)
                        : inf();
        }
        for (;;) {
          float e = lo(0);
          int c = lane;
#pragma unroll
          for (int q = 1; q < kPerLane; ++q) {
            if (lo(q) < e) {
              e = lo(q);
              c = lane + q * kWarp;
            }
          }
          warp_min(e, c);
          if (!(e <= t_best)) break;  // none left, or all beyond the best
#pragma unroll
          for (int q = 0; q < kPerLane; ++q) {
            if (c == lane + q * kWarp) lo(q) = inf();
          }
          visit(ray, lane, run.x + (c0 + c) * run.z, run.z, kind, frame,
                t_min, t_best, best);
        }
      }
    }
  }
  if (lane == 0) {
    t_out[i] = t_best;
    best_out[i] = best;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: rays o, d [n,3], time [n] float32, active [n] (bool
// as bytes), bits [n] int64 words; the tail groups [n_tail] int4 and the
// runs [n_runs] two int4 (ops/cluster_sweep.py cluster_scene); the
// cluster boxes [clusters] two float4; primitive records geo, aux [p]
// float4, tag [p] int32, xf [p,3] float4 (read only in a transformed
// group), the shutter table [slots] float2; outputs t_out [n] float32 and
// best_out [n] int32.  A warp a ray: the grid is n / kWarps blocks, and no
// index beyond 3 n is formed.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int hrt_cluster_sweep(const float* o, const float* d,
                                 const float* time,
                                 const unsigned char* active,
                                 const long long* bits, int n,
                                 const int4* tail, int n_tail,
                                 const int4* runs, int n_runs,
                                 const float4* boxes, const float4* geo,
                                 const float4* aux, const int* tag,
                                 const float4* xf, const float2* shutter,
                                 float t_min, float* t_out, int* best_out,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Prims pr{geo, aux, tag, xf, shutter, false};
  cluster_sweep_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      o, d, time, active, bits, n, tail, n_tail, runs, n_runs, boxes, pr,
      t_min, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}

// The window width kWindow, which ops/cluster_sweep.py's WINDOW must equal.
extern "C" int hrt_cluster_sweep_window() { return kWindow; }
