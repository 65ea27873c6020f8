// The segment folds of the typed sweep (typed_sweep.cu, K1b), one kernel
// each, for counting instructions: never launched by the port.
//
// K1b inlines the fold of every tile type into one kernel, so its SASS
// holds ten pair loops side by side and no name tells them apart.  Here
// each (R, tile type, transform, motion) instantiation of the same
// fold_segment runs alone in a kernel of its own, so that chip_smoke.py
// (phase 5) can count each type's SASS instructions per pair from
// `cuobjdump -sass` of this library: the innermost loop of fold_probe<...>
// folds one record into R rays per trip, that of fold_probe_bf16 two
// spheres of a bf16 tile into the bf16 form's rays (K1b's bf16 form).  The
// records come from shared memory, as in K1b.

#include "typed_sweep.cu"

template <int R, int kType, bool kXform, bool kMotion>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_probe(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ time,
           const unsigned char* __restrict__ active,
           const long long* __restrict__ bits, int n, int count,
           const float2* __restrict__ shutter, float t_min,
           float* __restrict__ t_out, int* __restrict__ best_out) {
  extern __shared__ float4 smem[];
  hrt::Packet<R> pk;
  hrt::load_packet<R>(pk, o, d, active, n);
#pragma unroll
  for (int r = 0; r < R; ++r) s_bound[hrt::word(r)] = t_min * r;
  fold_segment<R, kType, kXform, kMotion>(
      pk, RayInputs{time, bits}, smem, smem + kStage, smem + 2 * kStage,
      count, 0, count & 3, t_min, shutter);
  hrt::store_packet<R>(pk, n, t_out, best_out);
}

#define HRT_PROBE(R, TYPE, XF, MO)                                          \
  template __global__ void fold_probe<R, TYPE, XF, MO>(                     \
      const float*, const float*, const float*, const unsigned char*,      \
      const long long*, int, int, const float2*, float, float*, int*)

HRT_PROBE(hrt::kRays, kSphere, false, false);
HRT_PROBE(hrt::kRays, kSphere, false, true);
HRT_PROBE(hrt::kRays, kSphere, true, false);
HRT_PROBE(hrt::kRays, kRect, false, false);
HRT_PROBE(hrt::kRays, kRect, true, false);
HRT_PROBE(hrt::kRays, kBox, false, false);
HRT_PROBE(hrt::kRays, kBox, true, false);
HRT_PROBE(hrt::kRays, kMediumSphere, false, false);
HRT_PROBE(hrt::kRays, kMediumBox, false, false);

// The bf16 form's fold at its own launch shape (kBf16Rays rays a thread,
// kBf16MinBlocks resident blocks), as typed_sweep_kernel<kBf16Rays, true>.
template <int R>
__global__ void __launch_bounds__(kThreads, kBf16MinBlocks)
fold_probe_bf16(const float* __restrict__ o, const float* __restrict__ d,
                const unsigned char* __restrict__ active, int n, int count,
                float t_min, float* __restrict__ t_out,
                int* __restrict__ best_out) {
  extern __shared__ float4 smem[];
  hrt::Packet<R> pk;
  hrt::load_packet<R>(pk, o, d, active, n);
  fold_segment_bf16<R>(pk, smem, count, 0, t_min);
  hrt::store_packet<R>(pk, n, t_out, best_out);
}

template __global__ void fold_probe_bf16<kBf16Rays>(
    const float*, const float*, const unsigned char*, int, int, float,
    float*, int*);
