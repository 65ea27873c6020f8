// Closest-hit sweep of rays against spheres and moving spheres (K1), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel hyper_ray_tracer_tpu/ops/pallas_sweep.py::_kernel
// (launched by make_pallas_sphere_sweep).  It computes the same contract:
// for every ray (origin o, unnormalised direction d, shutter time, active
// flag) the closest hit distance t_best and the winning sphere index best
// over P spheres.  The center is lerped at the ray's time; the half-b
// quadratic takes the near root if it lies in [t_min, t_best], else the
// far root.  Ties go to the lowest index: a strict < keeps the earlier
// winner.  An inactive ray returns (BIG, -1).
//
// The TPU kernel folds a 128-sphere tile with a stale t_max and a min
// over lanes.  Here each ray walks the spheres in order with its running
// t_best as the inclusive upper bound.  That picks the same winner: a
// candidate's root values do not depend on the bound, a root rejected
// against the running bound could not have replaced the running minimum,
// and an exact tie keeps the earlier index in both forms.  Rounding and
// the packed sphere record: sweep_sphere.cuh.  The kernel is bit-equal to
// ops/sphere_sweep.py:sphere_sweep_plain.
//
// What bounds it on this card: FP32 issue.  A ray-sphere pair costs ~18
// FP32 operations before its hit test (6 more when the sphere moves),
// against 29 bytes read and 8 written per ray, so at P = 486 (`random`)
// the sweep is far above the card's operations-per-byte balance.  The
// contract forbids FMA contraction, so the FP32 pipes peak at half the
// 67 TFLOP/s that the bound counts.
//
// The first version (one thread per ray, 128 spheres staged as
// structure-of-arrays floats, two barriers per stage with nothing
// overlapping the copy) ran at about 20% of that bound: each pair issued
// 5-10 LDS.32 for one ray, a moving sphere's lerp divided once per pair,
// and every pair paid for the branch structure of its roots.  This one:
// - carries R rays per thread (a ray packet, sweep_sphere.cuh), so the two
//   LDS.128 broadcasts of a sphere record feed R pairs;
// - folds a sphere in two phases: every ray's discriminant as
//   straight-line code, the roots and the update only when some ray's line
//   meets the sphere;
// - divides for the lerp once per ray and shutter slot, not per pair, and
//   reads r * r from the record;
// - stages kStage-sphere records in a double-buffered ring filled by
//   cp.async, stage k + 1 in flight while stage k is folded; a scene with
//   no moving sphere copies and reads only the geo half of each record.
// The partitioned form (sweep_sphere.cuh): the stages are cut at the
// groups' bounds, a block stages no group that none of its rays needs,
// and in a group's stages the rays whose mask lacks the group are parked.
// Registers, shared memory and spills per instantiation: the ptxas report
// (chip_smoke.py phases 1 and 2).

#include "sweep_sphere.cuh"

namespace {

using hrt::kThreads;
constexpr int kMinBlocks = 7;  // resident blocks per SM: <= 72 registers
constexpr int kStage = 256;    // sphere records per ring slot

template <int R, bool kMotion>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sphere_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ time,
                    const unsigned char* __restrict__ active, int n,
                    const float4* __restrict__ geo,
                    const float4* __restrict__ aux, int p,
                    const float2* __restrict__ shutter, float t_min,
                    const hrt::GroupArgs groups,
                    float* __restrict__ t_out, int* __restrict__ best_out) {
  __shared__ float4 s_geo[2][kStage];
  __shared__ float4 s_aux[kMotion ? 2 : 1][kMotion ? kStage : 1];
  using Cursor = hrt::Cursor<kStage>;

  hrt::Packet<R> pk;
  hrt::load_packet<R>(pk, o, d, active, n);
  hrt::load_masks<R>(pk, groups.mask);
  hrt::plan_segments(groups, p);

  auto stage = [&](const Cursor& c, int buf) {  // issue a stage's copies
    const int lo = c.lo, count = c.hi() - lo;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      hrt::cp_async16(&s_geo[buf][j], geo + lo + j);
      if constexpr (kMotion) hrt::cp_async16(&s_aux[buf][j], aux + lo + j);
    }
  };
  Cursor cur = Cursor::first();
  if (cur.valid()) stage(cur, 0);
  hrt::cp_async_commit();
  // Every thread, live or not, runs every stage: each has two barriers.
  for (int q = 0; cur.valid(); ++q) {
    const int buf = q & 1;
    {
      const Cursor nxt = cur.next();
      if (nxt.valid()) stage(nxt, buf ^ 1);
    }
    hrt::cp_async_commit();  // possibly empty: keeps one group per stage
    hrt::cp_async_wait<1>();  // this stage has landed (this thread's copies)
    __syncthreads();          // ... and every other thread's
    const int group = cur.group();
    if (pk.live && (group < 0 || hrt::park<R>(pk, groups, group))) {
      const int lo = cur.lo, count = cur.hi() - lo;
#pragma unroll 1
      for (int j = 0; j < count; ++j) {
        const float4 g = s_geo[buf][j];
        float4 m = g;
        if constexpr (kMotion) m = s_aux[buf][j];
        hrt::fold_sphere<R, kMotion>(pk, g, m, lo + j, t_min, shutter, time);
      }
      if (group >= 0) hrt::unpark<R>(pk);
    }
    __syncthreads();  // this slot is read; the stage after next may refill it
    cur = cur.next();
  }
  hrt::store_packet<R>(pk, n, t_out, best_out);
}

template <int R, bool kMotion>
int launch(const float* o, const float* d, const float* time,
           const unsigned char* active, int n, const float4* geo,
           const float4* aux, int p, const float2* shutter, float t_min,
           const hrt::GroupArgs& groups, float* t_out, int* best_out,
           cudaStream_t stream) {
  const int blocks = (n + kThreads * R - 1) / (kThreads * R);
  sphere_sweep_kernel<R, kMotion><<<blocks, kThreads, 0, stream>>>(
      o, d, time, active, n, geo, aux, p, shutter, t_min, groups, t_out,
      best_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: rays o, d [n,3], time [n] float32, active [n] (bool
// as bytes); sphere records geo, aux [p] float4 and the shutter table
// [slots] float2 (sweep_sphere.cuh; aux and shutter are read only when
// has_motion); the partitioned form's lane masks [n] uint8 (nullptr for
// the plain sweep) and n_groups <= 2 groups [g0_start, g0_end), [g1_start,
// g1_end) (sweep_sphere.cuh); outputs t_out [n] float32 and best_out [n]
// int32.  A mask without groups, or groups without a mask, is refused.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
extern "C" int hrt_sphere_sweep(const float* o, const float* d,
                                const float* time,
                                const unsigned char* active, int n,
                                const float4* geo, const float4* aux, int p,
                                const float2* shutter, int has_motion,
                                float t_min, const unsigned char* mask,
                                int n_groups, int g0_start, int g0_end,
                                int g1_start, int g1_end, float* t_out,
                                int* best_out, void* stream) {
  if (n <= 0 || p <= 0 || n_groups < 0 || n_groups > hrt::kMaxGroups ||
      (mask == nullptr) != (n_groups == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const hrt::GroupArgs groups{mask, n_groups, {g0_start, g1_start},
                              {g0_end, g1_end}};
  const auto s = static_cast<cudaStream_t>(stream);
  return has_motion != 0
             ? launch<hrt::kRays, true>(o, d, time, active, n, geo, aux, p,
                                        shutter, t_min, groups, t_out,
                                        best_out, s)
             : launch<hrt::kRays, false>(o, d, time, active, n, geo, aux, p,
                                         shutter, t_min, groups, t_out,
                                         best_out, s);
}
