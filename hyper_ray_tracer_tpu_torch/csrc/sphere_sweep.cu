// Closest-hit sweep of rays against spheres and moving spheres, for
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
// over lanes.  Here each thread walks the spheres in order with its
// running t_best as the inclusive upper bound.  That picks the same
// winner: a candidate's root values do not depend on the bound, a root
// rejected against the running bound could not have replaced the running
// minimum, and an exact tie keeps the earlier index in both forms.
//
// Rounding: every floating-point step is one IEEE round-to-nearest
// operation (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the order of
// the plain version (ops/sphere_sweep.py via ops/intersect.py:sphere_t),
// so nvcc cannot contract a*b+c into an FMA and no reciprocal replaces a
// division.  Near-tangent discriminants (the r = 1000 ground sphere loses
// ~0.06 to cancellation in |oc|^2 - r^2) and self-hits at the t_min
// boundary then round the same way in both, and the two agree bit for
// bit.  The division of the center lerp runs only for moving spheres: a
// static sphere (p1 == p0, time1 != time0) has center p0 exactly in both.
//
// What bounds it on this card: FP32 ALU work, about 30 operations per
// ray-sphere pair (one division for a moving sphere, a sqrt and two
// divisions for a sphere the ray's line meets), against one 28-byte ray
// read and 8 bytes written per ray.  At P = 486 (the `random` scene) a ray
// does ~15k operations per ~40 bytes of device memory traffic, far above
// the card's operations-per-byte balance, so the sweep is compute-bound
// once the sphere fields come from on-chip memory.  The design keeps them
// there: one thread per ray, 128 rays per block; the block stages 128
// spheres at a time as structure-of-arrays floats (5 KB) in shared memory,
// where every thread of a warp reads the same word (a broadcast, no bank
// conflict).  Ray packets, wider tiles and cluster multicast are left for
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rays per block, one thread per ray
constexpr int kTile = 128;     // spheres staged in shared memory per step
constexpr float kBig = 3.0e38f;

struct SphereTile {
  float cx[kTile], cy[kTile], cz[kTile];  // p0: center at time0
  float dx[kTile], dy[kTile], dz[kTile];  // p1 - p0
  float t0[kTile], dt[kTile], r[kTile];   // time0, time1 - time0, radius
  int moving[kTile];                      // p1 != p0
};

// a.b summed left to right with one rounding per step (ops/intersect.py
// _dot3).
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kThreads)
sphere_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ time,
                    const unsigned char* __restrict__ active, int n,
                    const float* __restrict__ p0, const float* __restrict__ dp,
                    const float* __restrict__ t0,
                    const float* __restrict__ dt,
                    const float* __restrict__ radius, int p, float t_min,
                    float* __restrict__ t_out, int* __restrict__ best_out) {
  __shared__ SphereTile tile;

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = ray < n;
  const bool live = in_range && active[ray] != 0;

  float ox = 0.f, oy = 0.f, oz = 0.f;
  float dx = 0.f, dy = 0.f, dz = 1.f, tm = 0.f;
  if (live) {
    ox = o[3 * ray];
    oy = o[3 * ray + 1];
    oz = o[3 * ray + 2];
    dx = d[3 * ray];
    dy = d[3 * ray + 1];
    dz = d[3 * ray + 2];
    tm = time[ray];
  }
  const float a = dot3(dx, dy, dz, dx, dy, dz);

  float t_best = kBig;
  int best = -1;
  // Every thread, live or not, runs the tile loop: each iteration has two
  // __syncthreads(), which the whole block must reach.
  for (int base = 0; base < p; base += kTile) {
    const int count = min(kTile, p - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const int s = base + j;
      tile.cx[j] = p0[3 * s];
      tile.cy[j] = p0[3 * s + 1];
      tile.cz[j] = p0[3 * s + 2];
      tile.dx[j] = dp[3 * s];
      tile.dy[j] = dp[3 * s + 1];
      tile.dz[j] = dp[3 * s + 2];
      tile.t0[j] = t0[s];
      tile.dt[j] = dt[s];
      tile.r[j] = radius[s];
      tile.moving[j] =
          dp[3 * s] != 0.f || dp[3 * s + 1] != 0.f || dp[3 * s + 2] != 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      float cx = tile.cx[j], cy = tile.cy[j], cz = tile.cz[j];
      if (tile.moving[j]) {  // the same j for the whole warp: no divergence
        const float f = __fdiv_rn(__fsub_rn(tm, tile.t0[j]), tile.dt[j]);
        cx = __fadd_rn(cx, __fmul_rn(f, tile.dx[j]));
        cy = __fadd_rn(cy, __fmul_rn(f, tile.dy[j]));
        cz = __fadd_rn(cz, __fmul_rn(f, tile.dz[j]));
      }
      const float ocx = __fsub_rn(ox, cx);
      const float ocy = __fsub_rn(oy, cy);
      const float ocz = __fsub_rn(oz, cz);
      const float r = tile.r[j];
      const float half_b = dot3(ocx, ocy, ocz, dx, dy, dz);
      const float c =
          __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), __fmul_rn(r, r));
      const float disc = __fsub_rn(__fmul_rn(half_b, half_b), __fmul_rn(a, c));
      if (disc >= 0.0f) {
        const float sq = __fsqrt_rn(fmaxf(disc, 1e-30f));
        const float t_near = __fdiv_rn(__fsub_rn(-half_b, sq), a);
        const float t_far = __fdiv_rn(__fadd_rn(-half_b, sq), a);
        float t = kBig;
        if (t_near >= t_min && t_near <= t_best) {
          t = t_near;
        } else if (t_far >= t_min && t_far <= t_best) {
          t = t_far;
        }
        if (t < t_best) {
          t_best = t;
          best = base + j;
        }
      }
    }
  }
  if (in_range) {
    t_out[ray] = t_best;  // kBig for inactive rays and misses
    best_out[ray] = best;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: o, d [n,3], time [n], active [n] (bool as bytes),
// p0, dp = p1 - p0 [p,3], t0 = time0, dt = time1 - time0, radius [p];
// outputs t_out [n] float32 and
// best_out [n] int32.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); it never synchronises.
extern "C" int hrt_sphere_sweep(const float* o, const float* d,
                                const float* time,
                                const unsigned char* active, int n,
                                const float* p0, const float* dp,
                                const float* t0, const float* dt,
                                const float* radius, int p, float t_min,
                                float* t_out, int* best_out, void* stream) {
  if (n <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  sphere_sweep_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, time, active, n, p0, dp, t0, dt, radius, p, t_min, t_out,
      best_out);
  return static_cast<int>(cudaGetLastError());
}
