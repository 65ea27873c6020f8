// Closest-hit traversal of the BVH (K4), for NVIDIA Hopper (sm_90a).
//
// What it replaces: the JAX package's BVH mode traces with an XLA
// while_loop, not a Pallas kernel: make_bvh_traverser
// (hyper_ray_tracer_tpu/ops/bvh.py:408-460) over the scene-wide primitive
// intersector make_prim_intersector(static).  This kernel computes the
// port's contract (ops/bvh.py bvh_traverse_plain), which finds the same
// closest hits in another order: where the TPU steps the whole wavefront
// one node at a time with gathers, one thread here walks one ray to its
// end, the nearer child first.
//
// What bounds it on this card.  Counted over the tests the rays need, the
// work is FP32 operations (a box test 25, a sphere 18), far below the
// card's rate; the walk is bound by latency instead: every step's address
// comes from the step before (a pointer chase through L2), a warp steps as
// long as its longest ray, and a thread has nothing else in flight.  The
// design shortens the chase and the walks:
//
// * Two-child records (ops/bvh.py node_records).  One 64-byte record per
//   inner node holds both children's bounds and words, so a step is four
//   independent float4 loads that test two boxes, and a leaf's box is
//   never fetched again.  A child word is the child's record row, or for a
//   leaf ~(first << 4 | count) (leaf sizes 1-8).  Row 0 holds the root's
//   box and word.  sphereflake's 17,278 inner records (1.1 MB) and 66,431
//   primitives (2.4 MB) stay in the 50 MB L2.
// * Nearer child first.  Both children's slabs are tested against the
//   running best; the walk enters the one with the smaller entry t_lo (L
//   on a tie) and pushes the other with its t_lo on a per-thread stack of
//   kStack (word, t_lo) pairs.  The closest hit is found early, so the
//   running best culls more boxes and leaves.  A pop visits its node only
//   if t_best > t_lo: the slab test rerun with the smaller t_max, since
//   the far side already passed.  A leaf slot wins with t < t_best, or
//   with t == t_best and a lower index: ties go to the lowest index in
//   any visit order, as in the JAX package's fixed left-then-right walk.
// * One ray a thread, a flat grid.  Persistent warps that took their
//   next 32 rays from a global counter were measured against it, in
//   turns on sphereflake's chunk (8,294,400 lanes, bounces 0-2, H100):
//   they were 1.2x slower on every bounce, so the hardware's block
//   scheduler hands out the rays.  A ray's result depends only on the
//   ray.
//
// The slab test follows ops/intersect.py aabb_entry on inv_d = 1 / d with
// no floor.  For an axis-parallel ray 1 / d is +-inf, and an origin on a
// bound plane gives 0 * inf = NaN; torch and jnp propagate NaN through
// min and max, so the test fails and the box is missed.  CUDA's fminf and
// fmaxf return the operand that is not NaN, so here any NaN among the six
// slab distances misses the box explicitly, and the min and max run only
// on NaN-free values.
//
// The primitive test is prim_lane.cuh's prim_t with the scene-wide flags
// (prim_hit_t_lanes): with motion, every sphere whose center can move is
// lerped; with ray transforms, every primitive's ray is taken to its
// object frame.  A medium's free flight is bounded by the running best.
// Rounding: as prim_hit.cuh, in the order of the plain version.

#include "prim_lane.cuh"

namespace {

using hrt::kBig;
using hrt::Prims;
using hrt::Ray;

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;
constexpr int kStack = 32;     // ops/bvh.py STACK_SIZE
constexpr int kLeafShift = 4;  // ops/bvh.py LEAF_SHIFT
constexpr int kLeafMask = (1 << kLeafShift) - 1;

// The slab test of a box (ops/intersect.py aabb_entry): false when any of
// the six slab distances is NaN, as NaN-propagating min and max give;
// else t_hi > t_lo, with the entry t_lo set.
__device__ __forceinline__ bool box_entry(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float t_min, float t_max,
                                          float& t_lo) {
  const float x0 = __fmul_rn(__fsub_rn(lx, ox), ix);
  const float x1 = __fmul_rn(__fsub_rn(hx, ox), ix);
  const float y0 = __fmul_rn(__fsub_rn(ly, oy), iy);
  const float y1 = __fmul_rn(__fsub_rn(hy, oy), iy);
  const float z0 = __fmul_rn(__fsub_rn(lz, oz), iz);
  const float z1 = __fmul_rn(__fsub_rn(hz, oz), iz);
  if (isnan(x0) || isnan(x1) || isnan(y0) || isnan(y1) || isnan(z0) ||
      isnan(z1))
    return false;
  t_lo = fmaxf(fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)),
               t_min);
  const float t_hi = fminf(
      fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)), t_max);
  return t_hi > t_lo;
}

// The slots of the leaf of child word `word` (prim_lane.cuh test_range).
__device__ __forceinline__ void test_leaf(Ray& ray, int word,
                                          const Prims& pr, float t_min,
                                          float& t_best, int& best) {
  const int leaf = ~word;
  hrt::test_range(ray, leaf >> kLeafShift, leaf & kLeafMask, pr, t_min,
                  t_best, best);
}

// Ray i's walk, nearer child first; writes its (t, index).
__device__ __forceinline__ void walk(
    int i, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ time, const unsigned char* __restrict__ active,
    const long long* __restrict__ bits, const float4* __restrict__ nodes,
    const Prims& pr, float t_min, float* __restrict__ t_out,
    int* __restrict__ best_out) {
  float t_best = kBig;
  int best = -1;
  if (active[i]) {
    Ray ray = hrt::load_ray(i, o, d, time, bits);
    const float4 r0 = __ldg(&nodes[0]);
    const float4 r1 = __ldg(&nodes[1]);
    float t_lo;
    if (box_entry(r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, ray.ox, ray.oy,
                  ray.oz, ray.ix, ray.iy, ray.iz, t_min, kBig, t_lo)) {
      float2 stack[kStack];  // (t_lo, child word as float bits)
      int sp = 0;
      int cur = __float_as_int(r0.w);  // > 0 an inner row, < 0 a leaf
      for (;;) {
        while (cur > 0) {
          const float4* rec = nodes + 4 * cur;
          const float4 a = __ldg(rec);
          const float4 b = __ldg(rec + 1);
          const float4 c = __ldg(rec + 2);
          const float4 e = __ldg(rec + 3);
          float t_l, t_r;
          const bool h_l = box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ray.ox,
                                     ray.oy, ray.oz, ray.ix, ray.iy, ray.iz,
                                     t_min, t_best, t_l);
          const bool h_r = box_entry(c.x, c.y, c.z, e.x, e.y, e.z, ray.ox,
                                     ray.oy, ray.oz, ray.ix, ray.iy, ray.iz,
                                     t_min, t_best, t_r);
          const int w_l = __float_as_int(a.w), w_r = __float_as_int(b.w);
          if (h_l && h_r) {
            const bool r_first = t_r < t_l;
            stack[sp++] = make_float2(r_first ? t_l : t_r,
                                      __int_as_float(r_first ? w_l : w_r));
            cur = r_first ? w_r : w_l;
          } else {
            cur = h_l ? w_l : (h_r ? w_r : 0);
          }
        }
        if (cur < 0) test_leaf(ray, cur, pr, t_min, t_best, best);
        cur = 0;
        while (sp > 0) {
          const float2 top = stack[--sp];
          if (t_best > top.x) {
            cur = __float_as_int(top.y);
            break;
          }
        }
        if (cur == 0) break;
      }
    }
  }
  t_out[i] = t_best;
  best_out[i] = best;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ time,
                    const unsigned char* __restrict__ active,
                    const long long* __restrict__ bits, int n,
                    const float4* __restrict__ nodes, Prims pr, float t_min,
                    float* __restrict__ t_out, int* __restrict__ best_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n)
    walk(i, o, d, time, active, bits, nodes, pr, t_min, t_out, best_out);
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: rays o, d [n,3], time [n] float32, active [n] (bool
// as bytes), bits [n] int64 words; node records [rows] of four float4
// (ops/bvh.py node_records); primitive records geo, aux [p] float4, tag
// [p] int32, xf [p,3] float4 (read only when has_xf), the shutter table
// [slots] float2; outputs t_out [n] float32 and best_out [n] int32.  The
// tree must be at most kStack deep (the wrapper checks).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises.
extern "C" int hrt_bvh_traverse(const float* o, const float* d,
                                const float* time,
                                const unsigned char* active,
                                const long long* bits, int n,
                                const float4* nodes, const float4* geo,
                                const float4* aux, const int* tag,
                                const float4* xf, const float2* shutter,
                                int has_xf, float t_min, float* t_out,
                                int* best_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Prims pr{geo, aux, tag, xf, shutter, has_xf != 0};
  bvh_traverse_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, time, active, bits, n, nodes, pr, t_min, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
