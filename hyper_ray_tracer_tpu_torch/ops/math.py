"""Optics helpers and closed-form sampling on torch tensors
(``hyper_ray_tracer_tpu/ops/math.py:71-151``).

Shapes are ``(..., 3)`` for vectors.  Conventions follow the reference:
reflect (math.rs:47-49), refract (math.rs:51-56, Snell with clamped cos),
reflectance (math.rs:58-62, Schlick).  Rejection sampling is replaced by
closed-form transforms of counter-based uniforms, as in the JAX package.

``sqrt_capped_grad`` is the JAX package's capped-gradient sqrt
(``ops/math.py:27-68``, a ``jax.custom_vjp``) as a
``torch.autograd.Function``: the sphere roots go through it so that a
grazing ray's gradient stays finite.
"""

from __future__ import annotations

import numpy as np
import torch

NEAR_ZERO_EPS = 1e-8
SQRT_GRAD_CAP = 1.0e5  # the JAX package's _SQRT_GRAD_CAP
_TWO_PI = float(np.float32(2.0 * np.pi))  # the JAX package's f32 constant


def dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def sqrt_rn(x):
    """float32 sqrt rounded to nearest on every device.  torch's
    vectorised CPU sqrt is off by one ulp on ~1% of inputs; the float64
    root of a float32 rounds back to the correctly rounded float32 root
    (53 >= 2 * 24 + 2 bits), which is what CUDA's sqrt and ``__fsqrt_rn``
    give."""
    return torch.sqrt(x.double()).float()


def div_rn(x, c: float):
    """``x / c`` correctly rounded on every device.  torch's CUDA division
    by a Python number (or any CPU scalar) multiplies by the number's
    float32 reciprocal instead (ATen's ``div_true_kernel_cuda``), an ulp
    off the quotient on many lanes, where the CPU divides; a divisor that
    lies on ``x``'s own device is divided on both."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


class _SqrtCappedGrad(torch.autograd.Function):
    """sqrt whose derivative is clipped to ``SQRT_GRAD_CAP``.

    At a silhouette the discriminant crosses zero and d sqrt / dx -> inf,
    which overflows the gradient of every lane within ~1e-7 of tangency.
    The primal is the correctly rounded root, so no forward value changes;
    only the VJP is clipped: ``g * min(0.5 / max(y, 1e-30), 1e5)``.  On
    the card that root is ``torch.sqrt`` (one launch); on the CPU, whose
    vectorised sqrt is not correctly rounded, it is ``sqrt_rn``, so the
    CPU's roots are the card's and the JAX package's.

    It also runs under ``torch.func`` (``vmap``, ``jacfwd``): the vmap
    rule is generated, and the JVP takes the VJP's capped slope.  (The
    JAX package's is a ``custom_vjp``, which forward mode refuses; its
    silhouette sampler differentiates forward only along curve
    parameters that never reach the root, ``ops/edges.py``.)"""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return sqrt_rn(x) if x.device.type == "cpu" else torch.sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def _slope(y):
        return torch.clamp(0.5 / torch.clamp(y, min=1e-30),
                           max=SQRT_GRAD_CAP)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * _SqrtCappedGrad._slope(y)

    @staticmethod
    def jvp(ctx, x_t):
        (y,) = ctx.saved_tensors
        return x_t * _SqrtCappedGrad._slope(y)


def sqrt_capped_grad(x):
    """Exact sqrt; derivative clipped against silhouette blow-up."""
    return _SqrtCappedGrad.apply(x)


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
