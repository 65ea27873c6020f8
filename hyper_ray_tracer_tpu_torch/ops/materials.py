"""Masked branch-free material shading
(``hyper_ray_tracer_tpu/ops/materials.py:40-152``).

All five materials are computed over the whole wavefront and selected by
tag, pruned by ``SceneStatic.mat_types``.  Random draws come from the same
named counter-based streams as the JAX package, keyed by the
per-(pixel, sample, bounce) base word, so both consume identical samples.

Semantics:
  lambertian    lambertian.rs:27-38  (normal + unit vector, near-zero fallback)
  metal         metal.rs:29-42       (fuzzy reflect, absorb when scattered
                                      leaves the surface)
  dielectric    dielectric.rs:31-55  (front_face ratio, TIR, Schlick vs U)
  diffuse_light diffuse_light.rs:21-27 (no scatter; emits texture value)
  isotropic     isotropic.rs:27-33   (uniform-in-ball direction)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import (
    MT_DIELECTRIC,
    MT_DIFFUSE_LIGHT,
    MT_ISOTROPIC,
    MT_LAMBERTIAN,
    MT_METAL,
)
from . import math as m
from . import rng as prng
from .textures import texture_value


class ScatterResult(NamedTuple):
    emitted: torch.Tensor  # [B,3]
    attenuation: torch.Tensor  # [B,3]
    direction: torch.Tensor  # [B,3] (unnormalised, like the reference)
    did_scatter: torch.Tensor  # [B] bool


def shade(sf, hit, d, bb, static) -> ScatterResult:
    """Shade one wavefront bounce.

    sf: ShadeFields of the winning primitives;  hit: HitDetail;
    d: [B,3] incoming ray directions;  bb: [B] per-(pixel,sample,bounce)
    RNG base words.
    """
    mtype = sf.mtype
    tex_color = texture_value(sf, hit.point, static)

    zero3 = torch.zeros_like(hit.point)
    emitted = zero3
    attenuation = zero3
    direction = zero3
    did_scatter = torch.zeros_like(mtype, dtype=torch.bool)

    present = set(static.mat_types)
    normal = hit.normal

    if MT_LAMBERTIAN in present:
        u1 = prng.uniform(bb, prng.P_LAMBERT_A)
        u2 = prng.uniform(bb, prng.P_LAMBERT_B)
        sdir = normal + m.unit_vector_from_uniforms(u1, u2)
        sdir = torch.where(m.near_zero(sdir), normal, sdir)
        sel_m = mtype == MT_LAMBERTIAN
        sel = sel_m[..., None]
        direction = torch.where(sel, sdir, direction)
        attenuation = torch.where(sel, tex_color, attenuation)
        did_scatter = did_scatter | sel_m

    if MT_METAL in present or MT_ISOTROPIC in present:
        # Both draw from the shared in-unit-sphere stream (a material is
        # never both, so the streams cannot collide on one ray).
        s1 = prng.uniform(bb, prng.P_SPHERE_A)
        s2 = prng.uniform(bb, prng.P_SPHERE_B)
        s3 = prng.uniform(bb, prng.P_SPHERE_C)
        in_sphere = m.in_unit_sphere_from_uniforms(s1, s2, s3)

    if MT_METAL in present:
        reflected = m.reflect(m.normalize(d), normal)
        sdir = reflected + sf.fuzz[..., None] * in_sphere
        ok = (sdir * normal).sum(-1) > 0.0  # metal.rs:37-41 absorption
        sel_m = mtype == MT_METAL
        sel = sel_m[..., None]
        direction = torch.where(sel, sdir, direction)
        attenuation = torch.where(sel, sf.albedo, attenuation)
        did_scatter = torch.where(sel_m, ok, did_scatter)

    if MT_DIELECTRIC in present:
        ior = sf.ior
        ratio = torch.where(hit.front_face, 1.0 / ior, ior)
        unit_d = m.normalize(d)
        cos_theta = torch.clamp((-unit_d * normal).sum(-1), max=1.0)
        sin2 = torch.clamp(1.0 - cos_theta * cos_theta, min=0.0)
        cannot_refract = (ratio * ratio * sin2) > 1.0
        u = prng.uniform(bb, prng.P_DIELECTRIC)
        use_reflect = cannot_refract | (m.reflectance(cos_theta, ratio) > u)
        refl = m.reflect(unit_d, normal)
        refr = m.refract(unit_d, normal, ratio[..., None])
        sdir = torch.where(use_reflect[..., None], refl, refr)
        sel_m = mtype == MT_DIELECTRIC
        sel = sel_m[..., None]
        direction = torch.where(sel, sdir, direction)
        attenuation = torch.where(sel, torch.ones_like(tex_color),
                                  attenuation)
        did_scatter = did_scatter | sel_m

    if MT_DIFFUSE_LIGHT in present:
        sel_m = mtype == MT_DIFFUSE_LIGHT
        emitted = torch.where(sel_m[..., None], tex_color, emitted)
        did_scatter = did_scatter & ~sel_m

    if MT_ISOTROPIC in present:
        sel_m = mtype == MT_ISOTROPIC
        sel = sel_m[..., None]
        direction = torch.where(sel, in_sphere, direction)
        attenuation = torch.where(sel, tex_color, attenuation)
        did_scatter = did_scatter | sel_m

    return ScatterResult(emitted=emitted, attenuation=attenuation,
                         direction=direction, did_scatter=did_scatter)
