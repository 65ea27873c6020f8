// The rest of a forward-only bounce after the trace, in one launch, for
// NVIDIA Hopper (sm_90a) (K6): per lane, the background on a miss, the
// winner's joined shade row, its hit detail, its texture and its
// material, and the radiance, throughput, origin, direction and alive
// update.  It replaces the eager render.shade_hits of a render (some 450
// elementwise launches a bounce on `final`, each reading and writing
// whole [N] and [N, 3] tensors); no TPU kernel stands behind it.  The
// eager code stays the CPU's path and the train step's (autograd needs
// its graph), and it is the twin K6 is held to on the card.
//
// Contract (render.shade_hits with differentiable false; t_hit is the
// trace's, or the bf16 sweep's float32 recompute): for lane i with
// prim[i] >= 0 the winner's rows fpack[prim[i]] (columns at the offsets
// of ops/intersect.shade_pack_layout) and ipack[prim[i]] (ptype,
// stable_id, material, axis, mtype, ttype, image_id);
//   radiance += alive & miss ? throughput * background : 0
//   radiance += alive & hit ? throughput * emitted : 0
//   alive = alive & hit & did_scatter
//   throughput, o, d = alive ? (throughput * attenuation, hit point,
//                               scattered direction) : unchanged
// with hit detail, texture and material as ops/intersect.hit_detail,
// ops/textures.texture_value and ops/materials.shade compute them, and
// every draw the same word of ops/rng.py (stream_bits on the bounce word
// bb, in uint32 arithmetic).
//
// Rounding: the eager path's, operation for operation, as ATen rounds it
// on the card.  Every step is one IEEE round-to-nearest operation
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) in the eager
// expression's order, so nvcc contracts nothing into an FMA; the
// explicit three-term dots (ops/intersect.py _dot3, _xform_ray) sum left
// to right, and a torch .sum(-1) over three components in the order
// ATen's reduction takes on the card (tsum3).  The transcendental calls
// are the CUDA math library's, the ones ATen's kernels make: sinf, cosf,
// acosf, atan2f and powf (the float32 exponent 1/3), with no fast math.
// `1.0 / x` in torch is reciprocal(x) * 1, a true division here too; no
// eager expression on this path divides a tensor by a Python number.
//
// Design: one thread a lane; a lane computes its own primitive type's
// detail, its own texture and its own material only, chosen by the
// winner's tags, so a scene pays for the branches its lanes take.  Three
// flags of the scene (ops/shade.py shade_flags) come as an argument, for
// the branches the eager path takes or skips for every lane alike:
// rotated rects and boxes (the ray into object space), motion (the
// center's lerp) and the noise texture (the Perlin tables' staging).
// Pack rows, texels and image sizes are read through __ldg.  The marble is
// marble.cuh's (K2's arithmetic, one source), from the Perlin tables
// each block stages in shared memory once; the grid is capped at the
// blocks the card holds at once and each walks its lanes.
//
// What bounds it: a lane reads ~77 bytes (o, d, time, the bounce word,
// t, prim, alive, throughput, radiance) and writes ~49 (o, d,
// throughput, radiance, alive); the rows and texels it gathers stay in
// L1 and L2.  The arithmetic, a few hundred FP32 operations a hit lane
// (seven octaves of noise on a marble lane), is far below that.

#include <cuda_runtime.h>
#include <stdint.h>

#include "marble.cuh"
#include "prim_hit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCopies = 4;  // gradient table copies, as K2's

// The scene's flags (ops/shade.py shade_flags).
constexpr unsigned kXform = 1u;   // SceneStatic.has_ray_xform
constexpr unsigned kMotion = 2u;  // SceneStatic.has_motion
constexpr unsigned kNoise = 4u;   // SceneStatic.has_noise_tex
constexpr unsigned kAllFlags = kXform | kMotion | kNoise;

// Material type tags (models/scene.py MT_*).
constexpr int kLambertian = 0, kMetal = 1, kDielectric = 2,
              kDiffuseLight = 3, kIsotropic = 4;

// Texture type tags (models/scene.py TT_*).
constexpr int kTexChecker = 1, kTexNoise = 2, kTexImage = 3;

// ops/rng.py purposes of the materials' draws.
constexpr uint32_t kLambertA = 0x10, kLambertB = 0x11, kSphereA = 0x12,
                   kSphereB = 0x13, kSphereC = 0x14, kDielectricP = 0x15;

constexpr float kPi = 0x1.921fb6p+1f;         // float32(pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;      // float32(2 pi)
constexpr float kHalfInvPi = 0x1.45f306p-3f;  // float32(0.5 / pi)
constexpr float kInvPi = 0x1.45f306p-2f;      // float32(1 / pi)
constexpr float kThird = 0x1.555556p-2f;      // float32(1 / 3)
constexpr float kAcosClip = 0x1.fffffcp-1f;   // float32(1 - 1e-7)
constexpr float kNearZero = 1e-8f;            // ops/math.NEAR_ZERO_EPS
constexpr float kRefractFloor = 1e-12f;       // ops/math.refract's clamp

// Column offsets of the joined float row (-1: not packed) and its width.
struct Cols {
  int width, p0, p1, radius, time0, time1, rot, trans, fuzz, albedo, ior,
      color1, color2, scale;
};

struct Lanes {
  const float* o;           // [n, 3]
  const float* d;           // [n, 3]
  const float* time;        // [n]
  const long long* bb;      // [n] bounce words in [0, 2^32)
  const float* t_hit;       // [n]
  const int* prim;          // [n], -1 on a miss
  const unsigned char* alive;  // [n] bool
  const float* throughput;  // [n, 3]
  const float* radiance;    // [n, 3]
};

struct Scene {
  const float* fpack;  // [P, cols.width]
  const int* ipack;    // [P, 7]
  Cols cols;
  const float* texels;   // [n_images * image_h * image_w, 3]
  const int* image_wh;   // [n_images, 2] (width, height)
  long long n_texels;    // n_images * image_h * image_w
  int image_h, image_w;
  hrt::PerlinTables perlin;
  unsigned flags;   // kXform | kMotion | kNoise
  int sky;          // 1: the gradient sky (bg0 white, bg1 blue)
  float bg0[3], bg1[3];
};

struct Out {
  float* o;
  float* d;
  float* throughput;
  float* radiance;
  unsigned char* alive;
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch's (x * y).sum(-1) over three components as ATen reduces it on
// the card: two threads share the row, the first adding components 0
// and 2 (each accumulator starting from 0), the second holding 1, then
// the first adds the second's.
__device__ __forceinline__ float tsum3(float a0, float a1, float a2) {
  return fadd(fadd(fadd(0.0f, a0), fadd(0.0f, a2)), fadd(0.0f, a1));
}

__device__ __forceinline__ float tdot(const float* a, const float* b) {
  return tsum3(fmul(a[0], b[0]), fmul(a[1], b[1]), fmul(a[2], b[2]));
}

// torch.clamp's NaN-propagating bounds.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// ops/rng.py uniform(bb, purpose): stream_bits with salt 0, then the top
// 24 bits.
__device__ __forceinline__ float uniform(uint32_t bb, uint32_t purpose) {
  const uint32_t bits = hrt::fmix32(bb + purpose * 0x9E3779B9u);
  return fmul(__uint2float_rn(bits >> 8), 0x1p-24f);
}

// ops/math.unit_vector_from_uniforms.
__device__ __forceinline__ void unit_vector(float u1, float u2, float* v) {
  const float z = fsub(1.0f, fmul(2.0f, u1));
  const float r = __fsqrt_rn(clamp_min(fsub(1.0f, fmul(z, z)), 0.0f));
  const float phi = fmul(kTwoPi, u2);
  v[0] = fmul(r, cosf(phi));
  v[1] = fmul(r, sinf(phi));
  v[2] = z;
}

// ops/math.in_unit_sphere_from_uniforms on the P_SPHERE_* draws.
__device__ __forceinline__ void in_unit_sphere(uint32_t bb, float* v) {
  unit_vector(uniform(bb, kSphereA), uniform(bb, kSphereB), v);
  const float radius = powf(uniform(bb, kSphereC), kThird);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = fmul(v[c], radius);
}

// ops/math.normalize.
__device__ __forceinline__ void normalize(const float* v, float* u) {
  const float len = __fsqrt_rn(tdot(v, v));
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = fdiv(v[c], len);
}

// ops/math.reflect: v - 2 (v.n) n.
__device__ __forceinline__ void reflect(const float* v, const float* n,
                                        float* r) {
  const float k = fmul(2.0f, tdot(v, n));
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = fsub(v[c], fmul(k, n[c]));
}

// (-u) . n, clamped above at 1: the dielectric's cos_theta, and
// ops/math.refract's.
__device__ __forceinline__ float neg_cos(const float* u, const float* n) {
  return clamp_max(tsum3(fmul(-u[0], n[0]), fmul(-u[1], n[1]),
                         fmul(-u[2], n[2])),
                   1.0f);
}

// The unit vector e_ax, rotated world-from-object as hit_detail rotates
// it: (rot * e[None, :]).sum(-1).
__device__ __forceinline__ void axis_out(bool xform, int ax,
                                         const float* rot, float* out) {
  float e[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) e[c] = ax == c ? 1.0f : 0.0f;
  if (xform) {
#pragma unroll
    for (int r = 0; r < 3; ++r) out[r] = tdot(rot + 3 * r, e);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = e[c];
  }
}

// A rect's (k, a, b) components of a vector by its plane tag
// (ops/intersect._rect_components).
__device__ __forceinline__ void rect_ab(int axis, const float* v, float* a,
                                        float* b) {
  *a = axis == 0 ? v[0] : axis == 1 ? v[1] : v[2];
  *b = axis == 0 ? v[1] : axis == 1 ? v[2] : v[0];
}

// The hit detail of the winner (ops/intersect.hit_detail): the world hit
// point, the outward normal and uv of the lane's own primitive type.
__device__ __forceinline__ void detail(unsigned flags, const float* fp,
                                       const Cols& c, int ptype, int axis,
                                       const float* o, const float* d,
                                       float time, float t, float* point,
                                       float* outward, float* u,
                                       float* v) {
  float oo[3], dd[3], rot[9];
  const bool xform = (flags & kXform) != 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) point[k] = fadd(o[k], fmul(t, d[k]));
  if (xform) {
    // _xform_ray: o' = R^T (o - trans), d' = R^T d, left to right over
    // R's rows.
    float om[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k] = __ldg(fp + c.rot + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) om[k] = fsub(o[k], __ldg(fp + c.trans + k));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      oo[k] = fadd(fadd(fmul(rot[k], om[0]), fmul(rot[3 + k], om[1])),
                   fmul(rot[6 + k], om[2]));
      dd[k] = fadd(fadd(fmul(rot[k], d[0]), fmul(rot[3 + k], d[1])),
                   fmul(rot[6 + k], d[2]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      oo[k] = o[k];
      dd[k] = d[k];
    }
  }
  float p0[3], p1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p0[k] = __ldg(fp + c.p0 + k);
    p1[k] = __ldg(fp + c.p1 + k);
  }
  *u = 0.0f;
  *v = 0.0f;
  outward[0] = outward[1] = outward[2] = 0.0f;
  if (ptype == hrt::kSphere) {
    // World frame; a static sphere has p1 == p0.
    float center[3];
    if ((flags & kMotion) != 0) {
      const float t0 = __ldg(fp + c.time0), t1 = __ldg(fp + c.time1);
      const float frac = fdiv(fsub(time, t0), fsub(t1, t0));
#pragma unroll
      for (int k = 0; k < 3; ++k)
        center[k] = fadd(p0[k], fmul(frac, fsub(p1[k], p0[k])));
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) center[k] = p0[k];
    }
    const float radius = __ldg(fp + c.radius);
    const float safe_r = radius == 0.0f ? 1.0f : radius;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      outward[k] = fdiv(fsub(point[k], center[k]), safe_r);
    // _sphere_uv
    const float theta = acosf(clamp(-outward[1], -kAcosClip, kAcosClip));
    const float z = outward[2];
    const float x = outward[0] == 0.0f && z == 0.0f ? 1e-20f : outward[0];
    const float phi = fadd(atan2f(-z, x), kPi);
    *u = fmul(phi, kHalfInvPi);
    *v = fmul(theta, kInvPi);
  } else if (ptype == hrt::kRect) {
    float oa, ob, da, db;
    rect_ab(axis, oo, &oa, &ob);
    rect_ab(axis, dd, &da, &db);
    const float a0 = p0[0], b0 = p0[1], a1 = p1[0], b1 = p1[1];
    *u = fdiv(fsub(fadd(oa, fmul(t, da)), a0), a1 > a0 ? fsub(a1, a0) : 1.0f);
    *v = fdiv(fsub(fadd(ob, fmul(t, db)), b0), b1 > b0 ? fsub(b1, b0) : 1.0f);
    axis_out(xform, axis == 0 ? 2 : axis - 1, rot, outward);
  } else if (ptype == hrt::kBox) {
    // The face is the slab t (box_t's arithmetic) nearest the winning
    // t: torch.argmin's first index, a NaN counting as the least.
    float cand[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ds = fabsf(dd[k]) < hrt::kSlabFloor ? hrt::kSlabFloor
                                                       : dd[k];
      const float inv = fdiv(1.0f, ds);
      const float lo = fmul(fsub(p0[k], oo[k]), inv);
      const float hi = fmul(fsub(p1[k], oo[k]), inv);
      // torch.minimum / maximum: NaN from either side.
      cand[k] = lo != lo ? lo : hi != hi ? hi : fminf(lo, hi);
      cand[3 + k] = lo != lo ? lo : hi != hi ? hi : fmaxf(lo, hi);
    }
    int best = 0;
    float best_v = fabsf(fsub(cand[0], t));
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      const float e = fabsf(fsub(cand[k], t));
      if (best_v == best_v && (e != e || e < best_v)) {
        best = k;
        best_v = e;
      }
    }
    const int face = best % 3;
    axis_out(xform, face, rot, outward);
    float rel[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float span = fsub(p1[k], p0[k]);
      rel[k] = fdiv(fsub(fadd(oo[k], fmul(t, dd[k])), p0[k]),
                    span > 0.0f ? span : 1.0f);
    }
    *u = face == 0 ? rel[1] : face == 1 ? rel[2] : rel[0];
    *v = face == 0 ? rel[2] : face == 1 ? rel[0] : rel[1];
  }
  // Media (and any other tag) keep the zero normal and uv.
}

// The texture value (ops/textures.texture_value) of the lane's own
// texture type.
__device__ __forceinline__ void texture(
    const Scene& s, const hrt::PerlinSmem<kCopies>& tab, int q,
    const float* fp, int ttype, int image_id, const float* point, float u,
    float v, float* tex) {
  const Cols& c = s.cols;
#pragma unroll
  for (int k = 0; k < 3; ++k) tex[k] = __ldg(fp + c.color1 + k);
  if (ttype == kTexChecker) {
    const float sines = fmul(fmul(sinf(fmul(10.0f, point[0])),
                                  sinf(fmul(10.0f, point[1]))),
                             sinf(fmul(10.0f, point[2])));
    if (!(sines < 0.0f)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tex[k] = __ldg(fp + c.color2 + k);
    }
  } else if (ttype == kTexNoise) {  // a scene with kNoise: tab is staged
    const float sc = __ldg(fp + c.scale);
    const float pz = fmul(sc, point[2]);
    const float acc =
        hrt::octaves(tab, q, fmul(sc, point[0]), fmul(sc, point[1]), pz);
    tex[0] = tex[1] = tex[2] = hrt::marble_value(pz, acc);
  } else if (ttype == kTexImage) {  // textures.texel_rows
    const int w = __ldg(s.image_wh + 2 * image_id);
    const int h = __ldg(s.image_wh + 2 * image_id + 1);
    const float uu = clamp(u, 0.0f, 1.0f);
    const float vv = fsub(1.0f, clamp(v, 0.0f, 1.0f));
    const int i = min(static_cast<int>(fmul(uu, static_cast<float>(w))),
                      w - 1);
    const int j = min(static_cast<int>(fmul(vv, static_cast<float>(h))),
                      h - 1);
    long long row =
        static_cast<long long>(image_id) * s.image_h * s.image_w +
        static_cast<long long>(j) * s.image_w + i;
    row = row < 0 ? 0 : row > s.n_texels - 1 ? s.n_texels - 1 : row;
#pragma unroll
    for (int k = 0; k < 3; ++k) tex[k] = __ldg(s.texels + 3 * row + k);
  }
}

// One lane of shade_hits.
__device__ __forceinline__ void shade_lane(
    const Lanes& in, const Scene& s, const Out& out,
    const hrt::PerlinSmem<kCopies>& tab, int q, long long i) {
  float o[3], d[3], thr[3], rad[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = in.o[3 * i + k];
    d[k] = in.d[3 * i + k];
    thr[k] = in.throughput[3 * i + k];
    rad[k] = in.radiance[3 * i + k];
  }
  const bool alive = in.alive[i] != 0;
  const int prim = in.prim[i];
  const bool hit = prim >= 0;

  // Misses: the background, the sky's from the unit direction's y.
  float add[3] = {0.0f, 0.0f, 0.0f};
  if (alive && !hit) {
    float bg[3];
    if (s.sky) {
      const float unit_y = fdiv(d[1], __fsqrt_rn(tdot(d, d)));
      const float sky_t = fmul(0.5f, fadd(unit_y, 1.0f));
      const float w = fsub(1.0f, sky_t);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        bg[k] = fadd(fmul(w, s.bg0[k]), fmul(sky_t, s.bg1[k]));
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) bg[k] = s.bg0[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) add[k] = fmul(thr[k], bg[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) rad[k] = fadd(rad[k], add[k]);

  bool scatter = false;
  float emit[3] = {0.0f, 0.0f, 0.0f}, att[3] = {0.0f, 0.0f, 0.0f},
        dir[3] = {0.0f, 0.0f, 0.0f}, point[3];
  const bool contrib = alive && hit;
  if (contrib) {
    const Cols& c = s.cols;
    const int* ip = s.ipack + 7LL * prim;
    const float* fp = s.fpack + static_cast<long long>(prim) * c.width;
    const int ptype = __ldg(ip), axis = __ldg(ip + 3), mtype = __ldg(ip + 4);
    const float t = in.t_hit[i];
    const float time = (s.flags & kMotion) != 0 ? in.time[i] : 0.0f;
    float outward[3], u, v;
    detail(s.flags, fp, c, ptype, axis, o, d, time, t, point, outward, &u,
           &v);
    // set_face_normal
    const bool front = tdot(d, outward) < 0.0f;
    float n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = front ? outward[k] : -outward[k];

    const uint32_t bb = static_cast<uint32_t>(in.bb[i]);
    const bool textured =
        mtype == kLambertian || mtype == kDiffuseLight || mtype == kIsotropic;
    float tex[3] = {0.0f, 0.0f, 0.0f};
    if (textured)
      texture(s, tab, q, fp, __ldg(ip + 5), __ldg(ip + 6), point, u, v,
              tex);

    if (mtype == kLambertian) {
      float uv[3], sd[3];
      unit_vector(uniform(bb, kLambertA), uniform(bb, kLambertB), uv);
#pragma unroll
      for (int k = 0; k < 3; ++k) sd[k] = fadd(n[k], uv[k]);
      const bool tiny = fabsf(sd[0]) < kNearZero &&
                        fabsf(sd[1]) < kNearZero && fabsf(sd[2]) < kNearZero;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dir[k] = tiny ? n[k] : sd[k];
        att[k] = tex[k];
      }
      scatter = true;
    } else if (mtype == kMetal) {
      float ins[3], ud[3], r[3];
      in_unit_sphere(bb, ins);
      normalize(d, ud);
      reflect(ud, n, r);
      const float fuzz = __ldg(fp + c.fuzz);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dir[k] = fadd(r[k], fmul(fuzz, ins[k]));
        att[k] = __ldg(fp + c.albedo + k);
      }
      scatter = tdot(dir, n) > 0.0f;  // metal.rs:37-41 absorption
    } else if (mtype == kDielectric) {
      const float ior = __ldg(fp + c.ior);
      const float ratio = front ? fdiv(1.0f, ior) : ior;
      float ud[3];
      normalize(d, ud);
      const float cos_theta = neg_cos(ud, n);
      const float sin2 = clamp_min(fsub(1.0f, fmul(cos_theta, cos_theta)),
                                   0.0f);
      const bool cannot = fmul(fmul(ratio, ratio), sin2) > 1.0f;
      // Schlick (ops/math.reflectance), the powers left to right.
      float r0 = fdiv(fsub(1.0f, ratio), fadd(1.0f, ratio));
      r0 = fmul(r0, r0);
      const float om = fsub(1.0f, cos_theta);
      float tail = fsub(1.0f, r0);
#pragma unroll
      for (int k = 0; k < 5; ++k) tail = fmul(tail, om);
      const bool use_reflect =
          cannot || fadd(r0, tail) > uniform(bb, kDielectricP);
      if (use_reflect) {
        reflect(ud, n, dir);
      } else {  // ops/math.refract
        const float ct = neg_cos(ud, n);
        float perp[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          perp[k] = fmul(ratio, fadd(ud[k], fmul(ct, n[k])));
        const float par = -__fsqrt_rn(
            clamp_min(fabsf(fsub(1.0f, tdot(perp, perp))), kRefractFloor));
#pragma unroll
        for (int k = 0; k < 3; ++k) dir[k] = fadd(perp[k], fmul(par, n[k]));
      }
      att[0] = att[1] = att[2] = 1.0f;
      scatter = true;
    } else if (mtype == kDiffuseLight) {
#pragma unroll
      for (int k = 0; k < 3; ++k) emit[k] = tex[k];
    } else if (mtype == kIsotropic) {
      in_unit_sphere(bb, dir);
#pragma unroll
      for (int k = 0; k < 3; ++k) att[k] = tex[k];
      scatter = true;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rad[k] = fadd(rad[k], contrib ? fmul(thr[k], emit[k]) : 0.0f);
  if (scatter) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      thr[k] = fmul(thr[k], att[k]);
      o[k] = point[k];
      d[k] = dir[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.o[3 * i + k] = o[k];
    out.d[3 * i + k] = d[k];
    out.throughput[3 * i + k] = thr[k];
    out.radiance[3 * i + k] = rad[k];
  }
  out.alive[i] = scatter;
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(Lanes in, Scene s, Out out, long long n) {
  __shared__ hrt::PerlinSmem<kCopies> tab;
  if ((s.flags & kNoise) != 0) {  // the same for every thread
    hrt::stage_tables(tab, s.perlin, threadIdx.x, kThreads);
    __syncthreads();
  }
  const int q = threadIdx.x % kCopies;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    shade_lane(in, s, out, tab, q, i);
}

// Blocks the kernel can keep resident on the current device (cached per
// device ordinal), or a negative CUDA error code.
int resident_blocks() {
  static int cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, shade_kernel, kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

}  // namespace

// C entry point, bound with ctypes.  Device pointers: o, d, throughput,
// radiance [n, 3] float32, time and t_hit [n] float32, bb [n] int64,
// prim [n] int32, alive [n] bool; fpack [P, cols[0]] float32 and ipack
// [P, 7] int32; texels [n_images * image_h * image_w, 3] float32 and
// image_wh [n_images, 2] int32; vectors [256, 3] float32 and perm_x /
// perm_y / perm_z [256] int32; the outputs as their inputs.  Every array
// contiguous.  Host arrays: cols, the 14 column offsets of Cols; bg, the
// background's two colors (white then blue with sky, else the constant
// twice).  `flags`: the scene's kXform | kMotion | kNoise.  Launches on
// `stream` and returns cudaGetLastError() (0 on success, or the error
// of a device query, or cudaErrorInvalidValue for an unknown flag);
// does not synchronise.
extern "C" int hrt_shade(
    unsigned flags, const float* o, const float* d, const float* time,
    const long long* bb, const float* t_hit, const int* prim,
    const unsigned char* alive, const float* throughput,
    const float* radiance, long long n, const float* fpack, const int* ipack,
    const int* cols, const float* texels, const int* image_wh,
    int n_images, int image_h, int image_w, const float* vectors,
    const int* perm_x, const int* perm_y, const int* perm_z, int sky,
    const float* bg, float* o_out, float* d_out, float* thr_out,
    float* rad_out, unsigned char* alive_out, void* stream) {
  if ((flags & ~kAllFlags) != 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = resident_blocks();
  if (r < 0) return -r;
  const long long tiles = (n + kThreads - 1) / kThreads;
  const Cols c{cols[0], cols[1], cols[2],  cols[3],  cols[4],
               cols[5], cols[6], cols[7],  cols[8],  cols[9],
               cols[10], cols[11], cols[12], cols[13]};
  const Scene s{fpack, ipack, c, texels, image_wh,
                static_cast<long long>(n_images) * image_h * image_w,
                image_h, image_w,
                hrt::PerlinTables{vectors, perm_x, perm_y, perm_z}, flags,
                sky,
                {bg[0], bg[1], bg[2]}, {bg[3], bg[4], bg[5]}};
  shade_kernel<<<static_cast<int>(tiles < r ? tiles : r), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          Lanes{o, d, time, bb, t_hit, prim, alive, throughput, radiance}, s,
          Out{o_out, d_out, thr_out, rad_out, alive_out}, n);
  return static_cast<int>(cudaGetLastError());
}
