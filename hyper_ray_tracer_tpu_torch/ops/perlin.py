"""Perlin gradient noise on torch tensors, bit for bit the JAX package's
``hyper_ray_tracer_tpu/ops/perlin.py``.

The permutations and gradient vectors are seed-keyed bijective 8-bit hash
functions (the reference's ``perlin_noise.rs`` fills its tables with
``thread_rng``).  ``make_tables(seed)`` materialises them into the classic
table form, which ``SceneBuilder.finalize`` stores in every
``SceneArrays``; the table-form ``noise`` reads them.  The renderer's form
is ``turbulence_xyz``, which computes the same hashes per lane instead of
gathering from the tables (``ops/turbulence.py`` wraps it, with its CUDA
kernel).

Reference quirks kept (perlin_noise.rs): three independent axis
permutations XORed into the lattice hash, cube-corner-biased gradients
``normalize(uniform(-1,1)^3)``, the Hermite-smoothed fraction used both in
the lerp weights AND in the dot-product weight vector, and
``turbulence = |sum_k 0.5^k noise(2^k p)|``.

Words are int64 tensors (or Python ints) holding values in [0, 2**32),
as in ``ops/rng.py``: torch's ``uint32`` has no shifts on the CPU.  Every
float step is one IEEE operation in the JAX package's order, so the CUDA
kernel (``csrc/turbulence.cu``) can round identically.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .math import sqrt_rn

POINT_COUNT = 256
TURBULENCE_DEPTH = 7  # textures/noise_texture.rs:28 passes depth=7

MASK = 0xFFFFFFFF
_GRAD_SALTS = (0x68E31DA4, 0xB5297A4D, 0x334D4C65)
_INV32 = float(np.float32(2.0 ** -32))


def _mix32(h):
    """Avalanche mixer on 32-bit words from adds/xors/shifts only."""
    h = h ^ (h >> 16)
    h = (h + 0x9E3779B9) & MASK
    h = h ^ ((h << 13) & MASK)
    h = h ^ (h >> 17)
    h = h ^ ((h << 5) & MASK)
    h = h ^ (h >> 16)
    return h


def _perm8(x, k1, k2):
    """Seed-keyed bijection on 0..255 (x in range; k1, k2 8-bit keys).

    Every round is invertible on 8 bits (xor/add constants, shift-add
    multiplication by odd 9/5/3, x ^= x >> k), so the map is a permutation.
    """
    x = (x ^ k1) & 0xFF
    x = (x + (x << 3)) & 0xFF  # * 9
    x = x ^ (x >> 4)
    x = (x + k2) & 0xFF
    x = (x + (x << 2)) & 0xFF  # * 5
    x = x ^ (x >> 3)
    x = (x + (x << 1)) & 0xFF  # * 3
    x = x ^ (x >> 2)
    return x


def _grad_xyz(h, gseed):
    """Gradient components (gx, gy, gz) float32 for lattice hashes ``h``
    (int64 in 0..255): normalize(uniform(-1,1)^3), the three uniforms drawn
    from ARX hashes of (h, axis)."""
    # Spread the 8 lattice bits across the word before mixing.
    hh = (h | (h << 8) | (h << 16) | (h << 24)) ^ gseed
    gx, gy, gz = (2.0 * (_mix32(hh ^ salt).to(torch.float32) * _INV32) - 1.0
                  for salt in _GRAD_SALTS)
    inv = 1.0 / sqrt_rn(torch.clamp(gx * gx + gy * gy + gz * gz,
                                    min=1e-12))
    return gx * inv, gy * inv, gz * inv


class PerlinKeys(NamedTuple):
    """Seed-derived hash keys (all uint32 scalars)."""

    kx1: np.ndarray
    kx2: np.ndarray
    ky1: np.ndarray
    ky2: np.ndarray
    kz1: np.ndarray
    kz2: np.ndarray
    gseed: np.ndarray


class PerlinTables(NamedTuple):
    """Hash keys + their materialised table form: ``vectors``/``perm_*``
    are exactly ``_grad_xyz``/``_perm8`` evaluated on 0..255."""

    keys: PerlinKeys
    vectors: np.ndarray  # [256, 3] float32 gradient vectors
    perm_x: np.ndarray  # [256] int32
    perm_y: np.ndarray  # [256] int32
    perm_z: np.ndarray  # [256] int32


def make_keys(seed: int = 0) -> PerlinKeys:
    s = (int(seed) & MASK) ^ 0x05E11A57
    ks = [_mix32((s + (i * 0x9E3779B9 & MASK)) & MASK) for i in range(7)]
    u32 = [np.asarray(k, np.uint32) for k in ks]  # 0-d arrays
    return PerlinKeys(
        kx1=u32[0] & np.uint32(0xFF), kx2=u32[1] & np.uint32(0xFF),
        ky1=u32[2] & np.uint32(0xFF), ky2=u32[3] & np.uint32(0xFF),
        kz1=u32[4] & np.uint32(0xFF), kz2=u32[5] & np.uint32(0xFF),
        gseed=u32[6],
    )


def key_ints(keys) -> tuple:
    """The seven keys as Python ints (from NumPy scalars or 0-d tensors)."""
    return tuple(int(k) for k in keys)


def make_tables(seed: int = 0) -> PerlinTables:
    keys = make_keys(seed)
    kx1, kx2, ky1, ky2, kz1, kz2, gseed = key_ints(keys)
    idx = torch.arange(POINT_COUNT, dtype=torch.int64)
    g = torch.stack(_grad_xyz(idx, gseed), dim=-1)
    return PerlinTables(
        keys=keys,
        vectors=g.numpy(),
        perm_x=_perm8(idx, kx1, kx2).to(torch.int32).numpy(),
        perm_y=_perm8(idx, ky1, ky2).to(torch.int32).numpy(),
        perm_z=_perm8(idx, kz1, kz2).to(torch.int32).numpy(),
    )


def _smooth(u):
    """Hermite smoothing u*u*(3-2u), applied first (perlin_noise.rs:105)."""
    return u * u * (3.0 - 2.0 * u)


def _corner_weight(s, d: int):
    """The lerp weight of corner offset ``d`` along one axis."""
    return s if d else 1.0 - s


def noise(tables: PerlinTables, point):
    """Table-form gradient noise at ``point`` [..., 3] (perlin_noise.rs:
    81-123), the JAX package's ``noise``: gathers from the materialised
    tables; the same values as one octave of ``turbulence_xyz``."""
    vectors = torch.as_tensor(tables.vectors)
    perms = [torch.as_tensor(p).long() for p in
             (tables.perm_x, tables.perm_y, tables.perm_z)]
    pf = torch.floor(point)
    ijk = pf.to(torch.int64)
    s = _smooth(point - pf)
    acc = None
    for dx in (0, 1):
        px = perms[0][(ijk[..., 0] + dx) & 0xFF]
        for dy in (0, 1):
            py = perms[1][(ijk[..., 1] + dy) & 0xFF]
            for dz in (0, 1):
                pz = perms[2][(ijk[..., 2] + dz) & 0xFF]
                g = vectors[px ^ py ^ pz]
                wv_dot = (g[..., 0] * (s[..., 0] - dx)
                          + g[..., 1] * (s[..., 1] - dy)) \
                    + g[..., 2] * (s[..., 2] - dz)
                lerp_w = (_corner_weight(s[..., 0], dx)
                          * _corner_weight(s[..., 1], dy)) \
                    * _corner_weight(s[..., 2], dz)
                term = lerp_w * wv_dot
                acc = term if acc is None else acc + term
    return acc


def _noise_xyz(keys, x, y, z):
    """One octave of computed-hash gradient noise on coordinate tensors;
    ``keys`` are the seven Python-int keys of ``key_ints``."""
    kx1, kx2, ky1, ky2, kz1, kz2, gseed = keys
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    sx, sy, sz = _smooth(x - fx), _smooth(y - fy), _smooth(z - fz)

    def axis_perms(f, k1, k2):
        # int64 & 0xFF wraps negative lattice coordinates as two's
        # complement, the same low byte as the JAX package's int32.
        i = f.to(torch.int64)
        return _perm8(i & 0xFF, k1, k2), _perm8((i + 1) & 0xFF, k1, k2)

    px = axis_perms(fx, kx1, kx2)
    py = axis_perms(fy, ky1, ky2)
    pz = axis_perms(fz, kz1, kz2)
    acc = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                gx, gy, gz = _grad_xyz(px[dx] ^ py[dy] ^ pz[dz], gseed)
                wv_dot = (gx * (sx - dx) + gy * (sy - dy)) + gz * (sz - dz)
                lerp_w = (_corner_weight(sx, dx) * _corner_weight(sy, dy)) \
                    * _corner_weight(sz, dz)
                term = lerp_w * wv_dot
                acc = term if acc is None else acc + term
    return acc


def turbulence_sum_xyz(keys, x, y, z, depth: int = TURBULENCE_DEPTH):
    """sum_k 0.5^k noise(2^k p) on coordinate tensors, octaves summed in
    order (perlin_noise.rs:66-78); ``keys`` as in ``_noise_xyz``."""
    acc = None
    for k in range(depth):
        sc = float(2.0 ** k)
        term = float(0.5 ** k) * _noise_xyz(keys, x * sc, y * sc, z * sc)
        acc = term if acc is None else acc + term
    return acc


def turbulence_xyz(keys, x, y, z, depth: int = TURBULENCE_DEPTH):
    """|turbulence_sum_xyz|: the turbulence."""
    return torch.abs(turbulence_sum_xyz(keys, x, y, z, depth))
