"""Optics helpers and closed-form sampling on torch tensors
(``hyper_ray_tracer_tpu/ops/math.py:71-151``).

Shapes are ``(..., 3)`` for vectors.  Conventions follow the reference:
reflect (math.rs:47-49), refract (math.rs:51-56, Snell with clamped cos),
reflectance (math.rs:58-62, Schlick).  Rejection sampling is replaced by
closed-form transforms of counter-based uniforms, as in the JAX package.

The capped-gradient sqrt (a ``jax.custom_vjp``) is not here: this slice is
forward-only, so plain ``torch.sqrt`` is exact.
"""

from __future__ import annotations

import numpy as np
import torch

NEAR_ZERO_EPS = 1e-8
_TWO_PI = float(np.float32(2.0 * np.pi))  # the JAX package's f32 constant


def dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def normalize(v):
    return v / torch.sqrt(dot(v, v))


def reflect(v, n):
    """v - 2 (v.n) n   (math.rs:47-49)."""
    return v - 2.0 * dot(v, n) * n


def refract(uv, n, etai_over_etat):
    """Snell refraction (math.rs:51-56).  ``uv`` must be unit length;
    ``etai_over_etat`` broadcasts against ``uv[..., :1]``."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    r_out_parallel = -torch.sqrt(torch.clamp(
        torch.abs(1.0 - dot(r_out_perp, r_out_perp)), min=1e-12)) * n
    return r_out_perp + r_out_parallel


def reflectance(cosine, refraction_index):
    """Schlick approximation (math.rs:58-62)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    return r0 + (1.0 - r0) * one_minus * one_minus * one_minus * one_minus \
        * one_minus


def near_zero(v):
    """True where every component's |.| < 1e-8 (math.rs:42-45)."""
    return torch.all(torch.abs(v) < NEAR_ZERO_EPS, dim=-1, keepdim=True)


def unit_vector_from_uniforms(u1, u2):
    """Uniform direction on the unit sphere from two uniforms in [0,1)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = _TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere_from_uniforms(u1, u2, u3):
    """Uniform point in the unit ball: a uniform direction scaled by
    radius u3^(1/3).

    torch has no ``cbrt``; ``u ** (1/3)`` (pow with a float32 exponent)
    differs from the JAX package's ``jnp.cbrt`` by a few ulps, so a point
    agrees to ~1e-6 relative, not bit for bit.
    """
    direction = unit_vector_from_uniforms(u1, u2)
    radius = u3 ** (1.0 / 3.0)
    return direction * radius[..., None]


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform point in the unit disk (z=0) from two uniforms; (..., 2)."""
    r = torch.sqrt(u1)
    phi = _TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
