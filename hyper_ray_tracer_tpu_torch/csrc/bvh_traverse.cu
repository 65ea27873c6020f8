// Closest-hit traversal of the skip-threaded BVH (K4), for NVIDIA Hopper
// (sm_90a).
//
// What it replaces: the JAX package's BVH mode traces with an XLA
// while_loop, not a Pallas kernel: make_bvh_traverser
// (hyper_ray_tracer_tpu/ops/bvh.py:408-460) over the scene-wide primitive
// intersector make_prim_intersector(static).  This kernel computes that
// contract (ops/bvh.py of the port), not its loop structure: where the
// TPU steps the whole wavefront one node at a time with gathers, one
// thread here walks one ray to its end.
//
// The walk.  A ray's cursor starts at node 0 (an inactive ray returns
// (kBig, -1) at once).  Each step reads the node's two 16-byte records
// and runs the slab test with t_min and the running best as t_max.  A hit
// on a leaf tests its slots j < count in index order, each against the
// running best as the inclusive t_max, and a slot replaces the best only
// with a strictly smaller t.  The next node is node + 1 after a hit on an
// inner node, else the node's skip.  The DFS order is fixed, left then
// right, so ties go to the lowest index, as in the plain version.
//
// The slab test follows ops/intersect.py aabb_hit on inv_d = 1 / d with
// no floor.  For an axis-parallel ray 1 / d is +-inf, and an origin on a
// bound plane gives 0 * inf = NaN; torch and jnp propagate NaN through
// min and max, so the test fails and the node is missed.  CUDA's fminf
// and fmaxf return the operand that is not NaN, so here any NaN among the
// six slab distances misses the node explicitly, and the min and max run
// only on NaN-free values.
//
// The primitive test is prim_hit_t_lanes: the scene-wide flags, not a
// tile's.  With motion, every sphere whose center can move is lerped
// (its record's shutter slot, sweep_sphere.cuh's layout); with ray
// transforms, every primitive's ray is taken to its object frame.  The
// per-type functions are K1b's (prim_hit.cuh).  A medium's uniform is
// the ray's bounce word through stream_bits (P_MEDIUM, salt stable_id),
// the wrapper's int64 word narrowed here.
//
// Records.  A node is two float4: (bounds_min, skip) and (bounds_max,
// leaf word), the ints as their bits; the leaf word is -1 for an inner
// node, else first << 4 | count (leaf sizes 1-8).  A leaf mixes types,
// so a primitive is its type tag (int32) and K1b's two float4 records,
// geo and aux (a rect's aux carries its plane tag in .y), plus three
// float4 of transform when the scene has one.  sphereflake's 34,557
// nodes (1.1 MB) and 66,431 primitives (2.4 MB) stay in the 50 MB L2.
//
// What bounds it on this card: FP32 operations, counted over the tests
// the rays need: a node test is 25 (6 sub, 6 mul, the 6 min/max of the
// axes' pairs, 4 to reduce over the axes, the t_min and t_max clamps and
// the compare; the NaN checks not counted), a sphere 18 and its roots.
// This first version is one thread per ray with divergent walks, so it
// stays far from that bound: a warp's rays visit different nodes, a warp
// steps as long as its longest walk, and each node's records are a
// dependent load from L2.
// Rounding: as prim_hit.cuh, in the order of the plain version.

#include "prim_hit.cuh"

namespace {

using hrt::kBig;
using hrt::RayTerms;

constexpr int kThreads = 128;
constexpr int kLeafShift = 4;  // ops/bvh.py LEAF_SHIFT
constexpr int kLeafMask = (1 << kLeafShift) - 1;

// The slab test of a node (ops/intersect.py aabb_hit): false when any of
// the six slab distances is NaN, as NaN-propagating min and max give.
__device__ __forceinline__ bool node_hit(const float4 lo, const float4 hi,
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float t_min, float t_max) {
  const float x0 = __fmul_rn(__fsub_rn(lo.x, ox), ix);
  const float x1 = __fmul_rn(__fsub_rn(hi.x, ox), ix);
  const float y0 = __fmul_rn(__fsub_rn(lo.y, oy), iy);
  const float y1 = __fmul_rn(__fsub_rn(hi.y, oy), iy);
  const float z0 = __fmul_rn(__fsub_rn(lo.z, oz), iz);
  const float z1 = __fmul_rn(__fsub_rn(hi.z, oz), iz);
  if (isnan(x0) || isnan(x1) || isnan(y0) || isnan(y1) || isnan(z0) ||
      isnan(z1))
    return false;
  const float t_lo = fmaxf(
      fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)), t_min);
  const float t_hi = fminf(
      fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)), t_max);
  return t_hi > t_lo;
}

// One ray's state through its walk.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  RayTerms rt;     // the untransformed ray's terms (no ray transforms)
  float time;      // shutter time
  uint32_t bits;   // bounce word of the media's uniform
  int slot;        // the shutter slot f holds, -1 for none yet
  float f;         // lerp factor of that slot
};

// The candidate t of primitive `pid` (ops/intersect.py prim_hit_t_lanes),
// kBig on a miss.
__device__ __forceinline__ float prim_t(Ray& ray, int pid,
                                        const float4* __restrict__ geo,
                                        const float4* __restrict__ aux,
                                        const int* __restrict__ tag,
                                        const float4* __restrict__ xf,
                                        const float2* __restrict__ shutter,
                                        bool has_xf, float t_min,
                                        float t_max) {
  const int type = __ldg(&tag[pid]);
  const float4 g = __ldg(&geo[pid]);
  const float4 m = __ldg(&aux[pid]);
  float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  RayTerms rt = ray.rt;
  if (has_xf) {
    hrt::to_object(__ldg(&xf[3 * pid]), __ldg(&xf[3 * pid + 1]),
                   __ldg(&xf[3 * pid + 2]), ox, oy, oz, dx, dy, dz);
    rt = hrt::ray_terms<-1>(dx, dy, dz);
  }
  switch (type) {
    case hrt::kSphere: {
      float cx = g.x, cy = g.y, cz = g.z;
      const int slot = __float_as_int(m.w);
      if (slot >= 0) {
        if (slot != ray.slot) {
          const float2 s = __ldg(&shutter[slot]);
          ray.f = __fdiv_rn(__fsub_rn(ray.time, s.x), s.y);
          ray.slot = slot;
        }
        cx = __fadd_rn(cx, __fmul_rn(ray.f, m.x));
        cy = __fadd_rn(cy, __fmul_rn(ray.f, m.y));
        cz = __fadd_rn(cz, __fmul_rn(ray.f, m.z));
      }
      return hrt::sphere_t(cx, cy, cz, g.w, ox, oy, oz, dx, dy, dz, rt.a,
                           t_min, t_max);
    }
    case hrt::kRect:
      return hrt::rect_t(g, m.x, __float_as_int(m.y), ox, oy, oz, dx, dy,
                         dz, t_min, t_max);
    case hrt::kBox: {
      float entry, exit;
      hrt::box_slab(g, m, ox, oy, oz, rt, entry, exit);
      if (!(exit > entry)) return kBig;
      if (entry >= t_min && entry <= t_max) return entry;
      if (exit >= t_min && exit <= t_max) return exit;
      return kBig;
    }
    case hrt::kMediumSphere: {
      const hrt::Roots r = hrt::sphere_roots(g.x, g.y, g.z, g.w, ox, oy, oz,
                                             dx, dy, dz, rt.a);
      if (!r.exists) return kBig;
      const float u = hrt::medium_uniform(ray.bits, __float_as_uint(m.y));
      return hrt::medium_scatter_t(r.t_near, r.t_far, m.x, rt.len, t_min,
                                   t_max, u);
    }
    case hrt::kMediumBox: {
      float entry, exit;
      hrt::box_slab(g, m, ox, oy, oz, rt, entry, exit);
      if (!(exit > entry)) return kBig;
      const float u = hrt::medium_uniform(ray.bits, __float_as_uint(m.w));
      return hrt::medium_scatter_t(entry, exit, g.w, rt.len, t_min, t_max,
                                   u);
    }
    default:  // a pad slot (PT_NONE); never within a leaf's count
      return kBig;
  }
}

__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ time,
                    const unsigned char* __restrict__ active,
                    const long long* __restrict__ bits, int n,
                    const float4* __restrict__ nodes, int n_nodes,
                    const float4* __restrict__ geo,
                    const float4* __restrict__ aux,
                    const int* __restrict__ tag,
                    const float4* __restrict__ xf,
                    const float2* __restrict__ shutter, bool has_xf,
                    float t_min, float* __restrict__ t_out,
                    int* __restrict__ best_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float t_best = kBig;
  int best = -1;
  if (active[i]) {
    Ray ray;
    ray.ox = o[3 * i];
    ray.oy = o[3 * i + 1];
    ray.oz = o[3 * i + 2];
    ray.dx = d[3 * i];
    ray.dy = d[3 * i + 1];
    ray.dz = d[3 * i + 2];
    ray.rt = hrt::ray_terms<-1>(ray.dx, ray.dy, ray.dz);
    ray.time = time[i];
    ray.bits = static_cast<uint32_t>(bits[i]);  // a word below 2^32
    ray.slot = -1;
    ray.f = 0.f;
    const float ix = __fdiv_rn(1.0f, ray.dx);
    const float iy = __fdiv_rn(1.0f, ray.dy);
    const float iz = __fdiv_rn(1.0f, ray.dz);
    int node = 0;
    while (node < n_nodes) {
      const float4 lo = __ldg(&nodes[2 * node]);
      const float4 hi = __ldg(&nodes[2 * node + 1]);
      const bool hit = node_hit(lo, hi, ray.ox, ray.oy, ray.oz, ix, iy, iz,
                                t_min, t_best);
      const int leaf = __float_as_int(hi.w);
      if (hit && leaf >= 0) {
        const int first = leaf >> kLeafShift, count = leaf & kLeafMask;
        for (int j = 0; j < count; ++j) {
          const float t = prim_t(ray, first + j, geo, aux, tag, xf, shutter,
                                 has_xf, t_min, t_best);
          if (t < t_best) {
            t_best = t;
            best = first + j;
          }
        }
      }
      node = hit && leaf < 0 ? node + 1 : __float_as_int(lo.w);
    }
  }
  t_out[i] = t_best;
  best_out[i] = best;
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: rays o, d [n,3], time [n] float32, active [n] (bool
// as bytes), bits [n] int64 words; node records [n_nodes] pairs of
// float4; primitive records geo, aux [p] float4, tag [p] int32, xf [p,3]
// float4 (read only when has_xf), the shutter table [slots] float2;
// outputs t_out [n] float32 and best_out [n] int32.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); it never synchronises.
extern "C" int hrt_bvh_traverse(const float* o, const float* d,
                                const float* time,
                                const unsigned char* active,
                                const long long* bits, int n,
                                const float4* nodes, int n_nodes,
                                const float4* geo, const float4* aux,
                                const int* tag, const float4* xf,
                                const float2* shutter, int has_xf,
                                float t_min, float* t_out, int* best_out,
                                void* stream) {
  if (n <= 0 || n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh_traverse_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, time, active, bits, n, nodes, n_nodes, geo, aux, tag, xf,
      shutter, has_xf != 0, t_min, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
