// Closest hit over the cluster layout (K5), for NVIDIA Hopper (sm_90a).
//
// What it replaces: the JAX package's cluster intersector traces with XLA,
// not a Pallas kernel: make_cluster_intersector
// (hyper_ray_tracer_tpu/ops/cluster_sweep.py:245), a scan over ray tiles
// that culls each run's cluster boxes per tile and visits the surviving
// clusters nearest first, over the geometry in the padded cluster order of
// models/clusters.py.  This kernel computes the port's contract
// (ops/cluster_sweep.py cluster_sweep_plain), which finds the same
// closest hits in a fixed order of its own.
//
// The contract, per active ray, with t_best = kBig and best = -1 at the
// start:
// 1. the always-swept tail, group by group and slot by slot;
// 2. then each run in order, and each of its clusters in layout order
//    whose box admits the ray: with the box's slab distances
//    (b - o) * (1 / d), lo the largest of the per-axis minima and hi the
//    smallest of the maxima, the box admits the ray when
//    hi > max(lo, t_min) and lo <= t_best (the running best); then the
//    cluster's slots in order.
// Each slot is tested by prim_lane.cuh's prim_t with the running best as
// the inclusive t_max, and wins with t < t_best, or t == t_best and a
// lower slot index: K4's rule, so ties go to the lowest slot in any visit
// order.  (The JAX package folds with a strict < in its per-tile
// nearest-first order instead.)  A NaN among a box's six slab distances
// misses the box, as NaN-propagating min and max do in torch (an
// axis-parallel ray whose origin lies on a bound plane: 0 * inf).  Pad
// slots (PT_NONE, NaN geometry) never hit.
//
// Where the order matters.  Without media, every visit order that tests
// the same slots gives the same (t, slot).  It changes the result only
// where a primitive's float32 t falls below its own cluster's box entry
// (a graze: the box is culled by a nearer best although the primitive's
// t is nearer still, as where K4's walk parts from the JAX package's on
// one `sphereflake` camera ray in 921,600), or on a medium, whose free
// flight is bounded by the running best.  This kernel and the
// plain version visit in the same order; a per-ray nearest-first order is
// the redesign's.
//
// One level.  The JAX package tests a run's super boxes first once it has
// SUPER_MIN_CLUSTERS clusters or more, and bins and re-traces secondary
// rays (ops/cluster_sweep.py:96-105, 505-730): TPU schedules of the same
// function.  A super box is the union of its members' boxes, and the slab
// test is monotone under union (a box that admits the ray lies in a super
// that admits it), so culling by supers first changes no result; every run
// is one level here, and supers are left to the redesign.
//
// Design (the first, a simple one): one thread a ray, a flat grid.  A
// run's cluster boxes are staged in shared memory kChunk at a time (two
// float4 a box, 32 KB), every thread of the block reading the same box at
// once (a broadcast); a cluster's slots are read contiguously.  The
// per-type hit functions are prim_hit.cuh's, shared with K1b and K4.
//
// Rounding: as prim_hit.cuh (__f*_rn, no contraction, true divisions), in
// the order of the plain version.

#include "prim_lane.cuh"

namespace {

using hrt::kBig;
using hrt::Prims;
using hrt::Ray;

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // cluster boxes staged at a time

// Whether the box (lo4.xyz, hi4.xyz) admits the ray: the contract's slab
// test against the running best.
__device__ __forceinline__ bool admits(const float4 lo4, const float4 hi4,
                                       const Ray& r, float t_min,
                                       float t_best) {
  const float x0 = __fmul_rn(__fsub_rn(lo4.x, r.ox), r.ix);
  const float x1 = __fmul_rn(__fsub_rn(hi4.x, r.ox), r.ix);
  const float y0 = __fmul_rn(__fsub_rn(lo4.y, r.oy), r.iy);
  const float y1 = __fmul_rn(__fsub_rn(hi4.y, r.oy), r.iy);
  const float z0 = __fmul_rn(__fsub_rn(lo4.z, r.oz), r.iz);
  const float z1 = __fmul_rn(__fsub_rn(hi4.z, r.oz), r.iz);
  if (isnan(x0) || isnan(x1) || isnan(y0) || isnan(y1) || isnan(z0) ||
      isnan(z1))
    return false;
  const float lo =
      fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float hi =
      fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return hi > fmaxf(lo, t_min) && lo <= t_best;
}

// tail [n_tail] int4: (first slot, slots, transformed, 0); runs [n_runs]
// two int4: (first slot, clusters, slots a cluster, transformed),
// (first box row, 0, 0, 0); boxes [clusters] two float4: (min, 0),
// (max, 0).
__global__ void __launch_bounds__(kThreads)
cluster_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ time,
                     const unsigned char* __restrict__ active,
                     const long long* __restrict__ bits, int n,
                     const int4* __restrict__ tail, int n_tail,
                     const int4* __restrict__ runs, int n_runs,
                     const float4* __restrict__ boxes, Prims pr, float t_min,
                     float* __restrict__ t_out, int* __restrict__ best_out) {
  __shared__ float4 s_box[2 * kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n && active[i];
  float t_best = kBig;
  int best = -1;
  Ray ray;
  if (live) {
    ray = hrt::load_ray(i, o, d, time, bits);
    for (int g = 0; g < n_tail; ++g) {
      const int4 grp = __ldg(&tail[g]);
      Prims frame = pr;
      frame.has_xf = grp.z != 0;
      hrt::test_range(ray, grp.x, grp.y, frame, t_min, t_best, best);
    }
  }
  for (int r = 0; r < n_runs; ++r) {
    const int4 run = __ldg(&runs[2 * r]);
    const int box0 = __ldg(&runs[2 * r + 1]).x;
    Prims frame = pr;
    frame.has_xf = run.w != 0;
    for (int c0 = 0; c0 < run.y; c0 += kChunk) {
      const int m = min(kChunk, run.y - c0);
      __syncthreads();  // the previous chunk's boxes are read
      for (int k = threadIdx.x; k < 2 * m; k += kThreads)
        s_box[k] = __ldg(&boxes[2 * (box0 + c0) + k]);
      __syncthreads();
      if (!live) continue;
      for (int c = 0; c < m; ++c) {
        if (admits(s_box[2 * c], s_box[2 * c + 1], ray, t_min, t_best))
          hrt::test_range(ray, run.x + (c0 + c) * run.z, run.z, frame,
                          t_min, t_best, best);
      }
    }
  }
  if (i < n) {
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
// best_out [n] int32.  Launches on `stream` and returns
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
  cluster_sweep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      o, d, time, active, bits, n, tail, n_tail, runs, n_runs, boxes, pr,
      t_min, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
