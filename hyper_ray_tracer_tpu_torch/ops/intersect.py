"""Primitive intersection, the winner's row gather and its hit detail
(``hyper_ray_tracer_tpu/ops/intersect.py``).

Every primitive type's hit distance, each a plain function of tensors that
broadcast [rays, prims], and the hit detail of the winning primitive.
Specialisation flags from ``SceneStatic`` prune what a scene cannot use.

Semantics sources:
  sphere      sphere.rs:40-75 (half-b quadratic, nearer root first,
                               inclusive [t_min, t_max] bounds)
  moving      moving_sphere.rs:53-95 (center lerped at the ray's time; a
                               static sphere is stored with p1 == p0)
  rect        rect.rs:53-86   (axis permutation table, inclusive bounds)
  box         cuboid.rs:31-88 (a solid cuboid intersected as ONE slab
                               interval, the closest in-range endpoint)
  medium      constant_medium.rs:34-76 (entry/exit + exponential free
                               flight, the uniform drawn per primitive)
  transforms  translation.rs / rotation.rs, baked: the ray goes to the
                               object frame, o' = R^T (o - t), d' = R^T d

A negative sphere radius is a hollow shell: its outward normal
``(p - c) / r`` points inward, which is what flips refraction inside the
glass.

Rounding: every 3-term sum is written left to right, one IEEE operation
per step (``_dot3``, ``_xform_ray``), the order the CUDA sweep kernels use,
so that a kernel and its plain version round identically.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.scene import (
    MT_DIELECTRIC,
    MT_METAL,
    PLANE_AXES,
    PT_BOX,
    PT_MEDIUM_BOX,
    PT_MEDIUM_SPHERE,
    PT_RECT,
    PT_SPHERE,
)
from . import rng as prng
from .gather import gather_rows
from .math import sqrt_capped_grad

BIG = float(np.float32(3.0e38))  # sentinel "miss" distance (finite)
MEDIUM_REHIT_EPS = float(np.float32(1.0e-4))  # constant_medium.rs:38
SLAB_FLOOR = 1e-20  # |d| floor of the slab test (axis-parallel rays)


class PrimFields(NamedTuple):
    """Per-ray (or per-prim) primitive fields; a field the caller's
    specialisation cannot use is None."""

    p0: torch.Tensor  # [B,3]
    p1: torch.Tensor  # [B,3]
    radius: torch.Tensor  # [B]
    time0: Optional[torch.Tensor] = None  # [B]; None without motion
    time1: Optional[torch.Tensor] = None
    ptype: Optional[torch.Tensor] = None  # [B] int
    stable_id: Optional[torch.Tensor] = None  # [B] int (media RNG salt)
    axis: Optional[torch.Tensor] = None  # [B] int (rect plane)
    neg_inv_density: Optional[torch.Tensor] = None  # [B]
    rot: Optional[torch.Tensor] = None  # [B,3,3] world-from-object
    trans: Optional[torch.Tensor] = None  # [B,3]


class ShadeFields(NamedTuple):
    """Per-ray material+texture fields, star-joined into the prim rows;
    a field the scene cannot use is None."""

    mtype: torch.Tensor  # [B] int32
    ttype: torch.Tensor  # [B] int32
    image_id: torch.Tensor  # [B] int32
    fuzz: Optional[torch.Tensor]  # [B]
    ior: Optional[torch.Tensor]  # [B]
    albedo: Optional[torch.Tensor]  # [B,3] (metal)
    color1: torch.Tensor  # [B,3] (solid / checker odd)
    color2: Optional[torch.Tensor]  # [B,3] (checker even)
    scale: Optional[torch.Tensor]  # [B] (noise)


class HitDetail(NamedTuple):
    point: torch.Tensor  # [B,3]
    normal: torch.Tensor  # [B,3] oriented against the ray
    front_face: torch.Tensor  # [B] bool
    u: torch.Tensor  # [B]
    v: torch.Tensor  # [B]


def shade_pack_layout(static):
    """[(field, width)] float columns of the joined shade pack, specialised
    by the scene's static flags (the JAX package's layout): a field no
    consumer can touch is not packed and comes back None."""
    mats = set(static.mat_types)
    cols = [("p0", 3), ("p1", 3), ("radius", 1)]
    if static.has_motion:
        cols += [("time0", 1), ("time1", 1)]
    if static.has_media:
        cols += [("neg_inv_density", 1)]
    if static.has_ray_xform:
        cols += [("rot", 9), ("trans", 3)]
    if MT_METAL in mats:
        cols += [("fuzz", 1), ("albedo", 3)]
    if MT_DIELECTRIC in mats:
        cols += [("ior", 1)]
    cols += [("color1", 3)]
    if static.has_checker_tex:
        cols += [("color2", 3)]
    if static.has_noise_tex:
        cols += [("scale", 1)]
    return cols


def pack_prim_shade(arrays, static):
    """One float row and one int row per primitive, with the material and
    texture tables joined in, so the winner's fields come from ONE gather
    of each dtype per bounce.  ``arrays`` is a SceneArrays of tensors.
    Returns (fpack [P, F] float32, ipack [P, 7] int32: ptype, stable_id,
    material, axis, mtype, ttype, image_id)."""
    geom = arrays.geom
    mats, texs = arrays.materials, arrays.textures
    mi = geom.material.long()
    ti = mats.texture[mi].long()
    src = {
        "p0": geom.p0,
        "p1": geom.p1,
        "radius": geom.radius[:, None],
        "time0": geom.time0[:, None],
        "time1": geom.time1[:, None],
        "neg_inv_density": geom.neg_inv_density[:, None],
        "rot": geom.rot.reshape(-1, 9),
        "trans": geom.trans,
        "fuzz": mats.fuzz[mi][:, None],
        "albedo": mats.albedo[mi],
        "ior": mats.ior[mi][:, None],
        "color1": texs.color1[ti],
        "color2": texs.color2[ti],
        "scale": texs.scale[ti][:, None],
    }
    f = torch.cat([src[name] for name, _ in shade_pack_layout(static)],
                  dim=-1).contiguous()
    i = torch.stack([geom.ptype, geom.stable_id, geom.material, geom.axis,
                     mats.mtype[mi], texs.ttype[ti], texs.image_id[ti]],
                    dim=-1).contiguous()
    return f, i


def gather_prim_shade_packed(fpack, ipack, idx, static):
    """Row-gather the joined pack: (PrimFields, ShadeFields).  The float
    rows go through ``gather.gather_rows``, whose backward sums each
    primitive's cotangent rows in one fixed order (K3 on the card), so a
    train step's gradients are reproducible; autograd's backward of
    ``fpack[idx]`` sums each primitive's rows in one thread, which on the
    card serialises the hundreds of thousands of lanes that hit one
    primitive (PERF.md §6)."""
    g = gather_rows(fpack, idx)
    gi = ipack[idx]
    vals = {}
    off = 0
    for name, w in shade_pack_layout(static):
        vals[name] = g[..., off] if w == 1 else g[..., off:off + w]
        off += w
    rot = vals.get("rot")
    if rot is not None:
        rot = rot.reshape(*g.shape[:-1], 3, 3)
    pf = PrimFields(
        p0=vals["p0"], p1=vals["p1"], radius=vals["radius"],
        time0=vals.get("time0"), time1=vals.get("time1"),
        ptype=gi[..., 0], stable_id=gi[..., 1], axis=gi[..., 3],
        neg_inv_density=vals.get("neg_inv_density"),
        rot=rot, trans=vals.get("trans"),
    )
    sf = ShadeFields(
        mtype=gi[..., 4], ttype=gi[..., 5], image_id=gi[..., 6],
        fuzz=vals.get("fuzz"), ior=vals.get("ior"),
        albedo=vals.get("albedo"), color1=vals["color1"],
        color2=vals.get("color2"), scale=vals.get("scale"),
    )
    return pf, sf


def _dot(a, b):
    return (a * b).sum(-1)


def _dot3(a, b):
    """a.b summed left to right, one IEEE operation per step: the order
    the CUDA sweep kernels use, so the two round identically."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _xform_ray(pf: PrimFields, o, d):
    """World ray -> object space: o' = R^T (o - t), d' = R^T d
    (translation.rs:24-30 + rotation.rs:102-116 composed).  R is
    orthogonal, so the hit parameter t is unchanged.  Each component is
    summed left to right over R's rows."""
    rot = pf.rot

    def rt(x):
        return torch.stack([(rot[..., 0, i] * x[..., 0]
                             + rot[..., 1, i] * x[..., 1])
                            + rot[..., 2, i] * x[..., 2] for i in range(3)],
                           dim=-1)

    return rt(o - pf.trans), rt(d)


def sphere_center(pf: PrimFields, time, has_motion: bool):
    """moving_sphere.rs:53-57; static spheres have p1 == p0."""
    if not has_motion:
        return pf.p0
    frac = (time - pf.time0) / (pf.time1 - pf.time0)
    return pf.p0 + frac[..., None] * (pf.p1 - pf.p0)


def sphere_roots(center, radius, o, d):
    """Both quadratic roots (near, far) and the existence mask.  The root
    sees a positive argument on miss lanes and has a capped derivative, so
    a masked-out lane's zero cotangent never meets an infinite one."""
    oc = o - center
    a = _dot3(d, d)
    half_b = _dot3(oc, d)
    c = _dot3(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    exists = disc >= 0.0
    sq = sqrt_capped_grad(torch.where(exists, torch.clamp(disc, min=1e-30),
                                      1.0))
    t_near = (-half_b - sq) / a
    t_far = (-half_b + sq) / a
    return t_near, t_far, exists


def sphere_t(pf: PrimFields, o, d, time, t_min, t_max, has_motion: bool):
    """Nearer-root-first sphere hit (sphere.rs:40-58), BIG on miss."""
    center = sphere_center(pf, time, has_motion)
    t_near, t_far, exists = sphere_roots(center, pf.radius, o, d)
    ok1 = exists & (t_near >= t_min) & (t_near <= t_max)
    ok2 = exists & (t_far >= t_min) & (t_far <= t_max)
    return torch.where(ok1, t_near, torch.where(ok2, t_far, BIG))


def _rect_components(axis, vec):
    """(v[k_axis], v[a_axis], v[b_axis]) by per-lane plane tag
    (rect.rs:54-58): XY -> (z, x, y), YZ -> (x, y, z), ZX -> (y, z, x)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    vk = torch.where(axis == 0, z, torch.where(axis == 1, x, y))
    va = torch.where(axis == 0, x, torch.where(axis == 1, y, z))
    vb = torch.where(axis == 0, y, torch.where(axis == 1, z, x))
    return vk, va, vb


def rect_t(pf: PrimFields, o, d, t_min, t_max, axis=None):
    """Axis-aligned rect hit in object space (rect.rs:53-86), BIG on miss.
    ``axis``: the plane tag shared by every primitive (a plan tile's), else
    None for per-primitive tags."""
    if axis is None:
        ok_, oa, ob = _rect_components(pf.axis, o)
        dk, da, db = _rect_components(pf.axis, d)
    else:
        ki, ai, bi = PLANE_AXES[int(axis)]
        ok_, oa, ob = o[..., ki], o[..., ai], o[..., bi]
        dk, da, db = d[..., ki], d[..., ai], d[..., bi]
    a0, b0, k = pf.p0[..., 0], pf.p0[..., 1], pf.p0[..., 2]
    a1, b1 = pf.p1[..., 0], pf.p1[..., 1]
    # A ray parallel to the plane misses (the reference's inf t).
    parallel = dk == 0.0
    t = (k - ok_) / torch.where(parallel, 1.0, dk)
    a = oa + t * da
    b = ob + t * db
    ok = (~parallel & (t >= t_min) & (t <= t_max)
          & (a >= a0) & (a <= a1) & (b >= b0) & (b <= b1))
    return torch.where(ok, t, BIG)


def _box_slab(p0, p1, o, d):
    """Per-axis slab interval of a box: (t_entry, t_exit).  A |d| below
    1e-20 is floored to 1e-20, so axis-parallel rays stay finite with the
    same slab outcome."""
    d_safe = torch.where(torch.abs(d) < SLAB_FLOOR, SLAB_FLOOR, d)
    inv = 1.0 / d_safe
    t_lo = (p0 - o) * inv
    t_hi = (p1 - o) * inv
    t_entry = torch.minimum(t_lo, t_hi).amax(-1)
    t_exit = torch.maximum(t_lo, t_hi).amin(-1)
    return t_entry, t_exit


def box_t(pf: PrimFields, o, d, t_min, t_max):
    """Solid axis-aligned box hit in object space, BIG on miss: t_entry
    when in range (origin outside), else t_exit when in range (origin
    inside), the closest face-rect hit of the reference's 6-rect cuboid
    (tests/test_box.py)."""
    t_entry, t_exit = _box_slab(pf.p0, pf.p1, o, d)
    exists = t_exit > t_entry
    ok1 = exists & (t_entry >= t_min) & (t_entry <= t_max)
    ok2 = exists & (t_exit >= t_min) & (t_exit <= t_max)
    return torch.where(ok1, t_entry, torch.where(ok2, t_exit, BIG))


def medium_uniform(ray_bits, stable_id):
    """The free-flight uniform of each (ray, medium) pair: the ray's bounce
    word salted with the primitive's insertion-order id."""
    return prng.uniform(ray_bits, prng.P_MEDIUM, stable_id)


def _medium_scatter_t(t_entry, t_exit, nid, d, t_min, t_max, med_u):
    """Exponential free-flight sampling inside [entry, exit]
    (constant_medium.rs:40-76).  The outcome depends on ``t_max``."""
    exists = t_exit >= t_entry + MEDIUM_REHIT_EPS
    t1 = torch.clamp(t_entry, min=t_min)
    t2 = torch.clamp(t_exit, max=t_max)
    exists = exists & (t1 < t2)
    t1 = torch.clamp(t1, min=0.0)
    ray_len = torch.sqrt(_dot3(d, d))
    dist_inside = (t2 - t1) * ray_len
    # ln(U) <= 0 and nid < 0, so hit_dist >= 0; U == 0 gives +inf, a miss.
    hit_dist = nid * torch.log(med_u)
    exists = exists & (hit_dist <= dist_inside)
    t = t1 + hit_dist / ray_len
    return torch.where(exists, t, BIG)


def medium_sphere_t(pf: PrimFields, o, d, t_min, t_max, med_u):
    t_near, t_far, exists = sphere_roots(pf.p0, pf.radius, o, d)
    t = _medium_scatter_t(t_near, t_far, pf.neg_inv_density, d, t_min,
                          t_max, med_u)
    return torch.where(exists, t, BIG)


def medium_box_t(pf: PrimFields, o, d, t_min, t_max, med_u):
    """Slab entry/exit: the reference's two closest-rect hits through a
    cuboid boundary."""
    t_entry, t_exit = _box_slab(pf.p0, pf.p1, o, d)
    exists = t_exit > t_entry
    t = _medium_scatter_t(t_entry, t_exit, pf.neg_inv_density, d, t_min,
                          t_max, med_u)
    return torch.where(exists, t, BIG)


def prim_hit_t(ptype: int, pf: PrimFields, o, d, time, t_min, t_max,
               ray_bits, *, has_motion: bool, has_xform: bool,
               rect_axis=None):
    """Hit distances of primitives that are all of type ``ptype`` (a plan
    tile of the typed sweep), BIG on miss: the JAX package's
    ``make_prim_intersector(types={ptype}, assume_pure=True)``.
    ``ray_bits``: the per-ray bounce word the media's uniform comes from."""
    if has_xform:
        o, d = _xform_ray(pf, o, d)
    if ptype == PT_SPHERE:
        return sphere_t(pf, o, d, time, t_min, t_max, has_motion)
    if ptype == PT_RECT:
        return rect_t(pf, o, d, t_min, t_max, axis=rect_axis)
    if ptype == PT_BOX:
        return box_t(pf, o, d, t_min, t_max)
    med_u = medium_uniform(ray_bits, pf.stable_id)
    if ptype == PT_MEDIUM_SPHERE:
        return medium_sphere_t(pf, o, d, t_min, t_max, med_u)
    if ptype == PT_MEDIUM_BOX:
        return medium_box_t(pf, o, d, t_min, t_max, med_u)
    raise ValueError(f"unknown primitive type {ptype}")


def prim_hit_t_lanes(pf: PrimFields, o, d, time, t_min, t_max, ray_bits,
                     static):
    """Hit distances of primitives of any of the scene's types, one per
    lane (the winners of a trace), BIG on miss: the JAX package's
    ``make_prim_intersector(static)`` (``ops/intersect.py:439-510``), a
    ``where`` chain over every type the scene holds, keyed on each lane's
    ``pf.ptype``, with the scene-wide motion and transform flags and each
    rect's own plane tag.  Differentiable in ``pf``'s float fields and
    the ray."""
    if static.has_ray_xform:
        o, d = _xform_ray(pf, o, d)
    t = torch.where(pf.ptype == PT_SPHERE,
                    sphere_t(pf, o, d, time, t_min, t_max, static.has_motion),
                    BIG)
    t = torch.where(pf.ptype == PT_RECT, rect_t(pf, o, d, t_min, t_max), t)
    if static.has_boxes:
        t = torch.where(pf.ptype == PT_BOX, box_t(pf, o, d, t_min, t_max), t)
    if static.has_media:
        med_u = medium_uniform(ray_bits, pf.stable_id)
        t = torch.where(pf.ptype == PT_MEDIUM_SPHERE,
                        medium_sphere_t(pf, o, d, t_min, t_max, med_u), t)
        t = torch.where(pf.ptype == PT_MEDIUM_BOX,
                        medium_box_t(pf, o, d, t_min, t_max, med_u), t)
    return t


def aabb_hit(box_min, box_max, o, inv_d, t_min, t_max):
    """Slab test of a BVH node (aabb.rs:20-47; the JAX package's
    ``ops/intersect.py:aabb_hit``): strict overlap of the ray's slab
    interval with [t_min, t_max].  ``inv_d`` is 1 / d with no floor: an
    axis-parallel ray's ±inf meets a bound plane through its origin as
    0 * inf = NaN, and every min and max here propagates it, so such a
    node is missed, as with ``jnp``'s."""
    return aabb_entry(box_min, box_max, o, inv_d, t_min, t_max)[0]


def aabb_entry(box_min, box_max, o, inv_d, t_min, t_max):
    """``aabb_hit`` and the entry distance it compares: (hit, t_lo), t_lo
    the slab interval's start clamped to ``t_min`` (NaN where a slab
    distance is; then hit is False)."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tmin_all = torch.clamp(lo.amax(-1), min=t_min)
    tmax_all = torch.minimum(hi.amin(-1), t_max)
    return tmax_all > tmin_all, tmin_all


def _sphere_uv(outward):
    """sphere.rs:31-36: theta = acos(-y), phi = atan2(-z, x) + pi, clipped
    a hair inside [-1, 1] exactly as the JAX package and the oracle do."""
    theta = torch.acos(torch.clamp(-outward[..., 1], -(1.0 - 1e-7),
                                   1.0 - 1e-7))
    x = outward[..., 0]
    z = outward[..., 2]
    x = torch.where((x == 0.0) & (z == 0.0), 1e-20, x)
    phi = torch.atan2(-z, x) + float(np.float32(np.pi))
    return (phi * float(np.float32(0.5 / np.pi)),
            theta * float(np.float32(1.0 / np.pi)))


def _axis_vector(ax):
    """The unit vector e_ax [B,3] for per-lane axis indices."""
    return torch.stack([(ax == i).to(torch.float32) for i in range(3)],
                       dim=-1)


def hit_detail(pf: PrimFields, o, d, time, t, static) -> HitDetail:
    """Hit point, oriented normal and uv of the winning primitives (the
    JAX package's ``make_hit_detailer``).  Spheres work in the world frame
    (their transforms are baked), rects and boxes in the object frame.
    Media keep a zero normal and front_face false
    (constant_medium.rs:67-75)."""
    point = o + t[..., None] * d
    if static.has_ray_xform:
        o_obj, d_obj = _xform_ray(pf, o, d)
    else:
        o_obj, d_obj = o, d
    point_obj = o_obj + t[..., None] * d_obj

    # Selected by the type tag: a medium sphere must not take this branch.
    is_sphere = pf.ptype == PT_SPHERE
    is_rect = pf.ptype == PT_RECT

    # Sphere branch (world frame).
    center = sphere_center(pf, time, static.has_motion)
    safe_r = torch.where(pf.radius == 0.0, 1.0, pf.radius)
    outward_s = (point - center) / safe_r[..., None]
    su, sv = _sphere_uv(outward_s)

    # Rect branch (object frame).
    _, oa, ob = _rect_components(pf.axis, o_obj)
    _, da, db = _rect_components(pf.axis, d_obj)
    a0, b0 = pf.p0[..., 0], pf.p0[..., 1]
    a1, b1 = pf.p1[..., 0], pf.p1[..., 1]
    ru = (oa + t * da - a0) / torch.where(a1 > a0, a1 - a0, 1.0)
    rv = (ob + t * db - b0) / torch.where(b1 > b0, b1 - b0, 1.0)
    # Outward normal: +1 on the k axis (rect.rs:81-83).
    outward_r = _axis_vector(torch.where(pf.axis == 0, 2, pf.axis - 1))
    if static.has_ray_xform:
        outward_r = (pf.rot * outward_r[..., None, :]).sum(-1)

    outward = torch.where(is_sphere[..., None], outward_s,
                          torch.where(is_rect[..., None], outward_r, 0.0))
    u = torch.where(is_sphere, su, torch.where(is_rect, ru, 0.0))
    v = torch.where(is_sphere, sv, torch.where(is_rect, rv, 0.0))

    if static.has_boxes:
        # Box branch (object frame): the face is the one of the six slab
        # t's (recomputed with box_t's arithmetic) that equals the winning
        # t, so the argmin is exact, not a tolerance test.
        is_box = pf.ptype == PT_BOX
        d_safe = torch.where(torch.abs(d_obj) < SLAB_FLOOR, SLAB_FLOOR,
                             d_obj)
        inv = 1.0 / d_safe
        t_lo = (pf.p0 - o_obj) * inv
        t_hi = (pf.p1 - o_obj) * inv
        cand = torch.cat([torch.minimum(t_lo, t_hi),
                          torch.maximum(t_lo, t_hi)], dim=-1)  # [B,6]
        face_ax = torch.argmin(torch.abs(cand - t[..., None]), dim=-1) % 3
        # +1 on the face axis at both faces (rect.rs:81-83); the face uv
        # follows the cuboid.rs face list: z-faces (x,y), y-faces (z,x),
        # x-faces (y,z).
        outward_b = _axis_vector(face_ax)
        if static.has_ray_xform:
            outward_b = (pf.rot * outward_b[..., None, :]).sum(-1)
        span = pf.p1 - pf.p0
        span = torch.where(span > 0.0, span, 1.0)  # pad/degenerate lanes
        rel = (point_obj - pf.p0) / span
        rx, ry, rz = rel[..., 0], rel[..., 1], rel[..., 2]
        bu = torch.where(face_ax == 0, ry, torch.where(face_ax == 1, rz, rx))
        bv = torch.where(face_ax == 0, rz, torch.where(face_ax == 1, rx, ry))
        outward = torch.where(is_box[..., None], outward_b, outward)
        u = torch.where(is_box, bu, u)
        v = torch.where(is_box, bv, v)

    # set_face_normal (hit_record.rs:22-29).
    front = _dot(d, outward) < 0.0
    normal = torch.where(front[..., None], outward, -outward)
    return HitDetail(point=point, normal=normal, front_face=front, u=u, v=v)
