"""Sphere intersection, the winner's row gather and its hit detail
(the sphere subset of ``hyper_ray_tracer_tpu/ops/intersect.py``).

Semantics: sphere.rs:40-75 (half-b quadratic, nearer root first,
inclusive [t_min, t_max] bounds) and moving_sphere.rs:53-95 (center lerped
at the ray's time; a static sphere is stored with p1 == p0).  A negative
radius is a hollow shell: its outward normal ``(p - c) / r`` points inward,
which is what flips refraction inside the glass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.scene import MT_DIELECTRIC, MT_METAL

BIG = float(np.float32(3.0e38))  # sentinel "miss" distance (finite)


class PrimFields(NamedTuple):
    """Per-ray gathered primitive fields (sphere subset)."""

    p0: torch.Tensor  # [B,3]
    p1: torch.Tensor  # [B,3]
    radius: torch.Tensor  # [B]
    time0: Optional[torch.Tensor]  # [B]; None when the scene has no motion
    time1: Optional[torch.Tensor]


class ShadeFields(NamedTuple):
    """Per-ray material+texture fields, star-joined into the prim rows;
    a field the scene cannot use is None."""

    mtype: torch.Tensor  # [B] int32
    ttype: torch.Tensor  # [B] int32
    fuzz: Optional[torch.Tensor]  # [B]
    ior: Optional[torch.Tensor]  # [B]
    albedo: Optional[torch.Tensor]  # [B,3] (metal)
    color1: torch.Tensor  # [B,3] (solid / checker odd)
    color2: Optional[torch.Tensor]  # [B,3] (checker even)


class HitDetail(NamedTuple):
    point: torch.Tensor  # [B,3]
    normal: torch.Tensor  # [B,3] oriented against the ray
    front_face: torch.Tensor  # [B] bool
    u: torch.Tensor  # [B]
    v: torch.Tensor  # [B]


def shade_pack_layout(static):
    """[(field, width)] float columns of the joined shade pack, specialised
    by the scene's static flags (the JAX package's layout, restricted to
    the fields a sphere-only scene with solid or checker textures reads)."""
    mats = set(static.mat_types)
    cols = [("p0", 3), ("p1", 3), ("radius", 1)]
    if static.has_motion:
        cols += [("time0", 1), ("time1", 1)]
    if MT_METAL in mats:
        cols += [("fuzz", 1), ("albedo", 3)]
    if MT_DIELECTRIC in mats:
        cols += [("ior", 1)]
    cols += [("color1", 3)]
    if static.has_checker_tex:
        cols += [("color2", 3)]
    return cols


def pack_prim_shade(arrays, static):
    """One float row and one int row per primitive, with the material and
    texture tables joined in, so the winner's fields come from ONE gather
    of each dtype per bounce.  ``arrays`` is a SceneArrays of tensors.
    Returns (fpack [P, F] float32, ipack [P, 2] int32: material and
    texture type)."""
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
        "fuzz": mats.fuzz[mi][:, None],
        "albedo": mats.albedo[mi],
        "ior": mats.ior[mi][:, None],
        "color1": texs.color1[ti],
        "color2": texs.color2[ti],
    }
    f = torch.cat([src[name] for name, _ in shade_pack_layout(static)],
                  dim=-1).contiguous()
    i = torch.stack([mats.mtype[mi], texs.ttype[ti]], dim=-1).contiguous()
    return f, i


def gather_prim_shade_packed(fpack, ipack, idx, static):
    """Row-gather the joined pack: (PrimFields, ShadeFields)."""
    g = fpack[idx]
    gi = ipack[idx]
    vals = {}
    off = 0
    for name, w in shade_pack_layout(static):
        vals[name] = g[..., off] if w == 1 else g[..., off:off + w]
        off += w
    pf = PrimFields(
        p0=vals["p0"],
        p1=vals["p1"],
        radius=vals["radius"],
        time0=vals.get("time0"),
        time1=vals.get("time1"),
    )
    sf = ShadeFields(
        mtype=gi[..., 0],
        ttype=gi[..., 1],
        fuzz=vals.get("fuzz"),
        ior=vals.get("ior"),
        albedo=vals.get("albedo"),
        color1=vals["color1"],
        color2=vals.get("color2"),
    )
    return pf, sf


def _dot(a, b):
    return (a * b).sum(-1)


def sphere_center(pf: PrimFields, time, has_motion: bool):
    """moving_sphere.rs:53-57; static spheres have p1 == p0."""
    if not has_motion:
        return pf.p0
    frac = (time - pf.time0) / (pf.time1 - pf.time0)
    return pf.p0 + frac[..., None] * (pf.p1 - pf.p0)


def _dot3(a, b):
    """a.b summed left to right, one IEEE operation per step: the order
    the CUDA sweep kernel uses, so the two round identically."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def sphere_roots(center, radius, o, d):
    """Both quadratic roots (near, far) and the existence mask."""
    oc = o - center
    a = _dot3(d, d)
    half_b = _dot3(oc, d)
    c = _dot3(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    exists = disc >= 0.0
    sq = torch.sqrt(torch.where(exists, torch.clamp(disc, min=1e-30), 1.0))
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


def sphere_hit_detail(pf: PrimFields, o, d, time, t,
                      has_motion: bool) -> HitDetail:
    """Hit point, oriented normal and uv of the winning sphere
    (the sphere branch of the JAX ``make_hit_detailer``)."""
    point = o + t[..., None] * d
    center = sphere_center(pf, time, has_motion)
    safe_r = torch.where(pf.radius == 0.0, 1.0, pf.radius)
    outward = (point - center) / safe_r[..., None]
    u, v = _sphere_uv(outward)
    # set_face_normal (hit_record.rs:22-29).
    front = _dot(d, outward) < 0.0
    normal = torch.where(front[..., None], outward, -outward)
    return HitDetail(point=point, normal=normal, front_face=front, u=u, v=v)
