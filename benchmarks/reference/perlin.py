"""Perlin tables of a scene: a frozen copy of the table half of the JAX
package's ``hyper_ray_tracer_tpu/ops/perlin.py`` (its lines 33-165 at commit
``7eb49fb``: the hash functions and ``make_tables``), so that the
reference builds a scene's tables itself.  Only the docstring was cut.

Three independent axis permutations and gradient vectors
``normalize(uniform(-1, 1)^3)``, defined as bijective 8-bit hash
functions of a seed and materialised on 0..255 (perlin_noise.rs:24-64).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

POINT_COUNT = 256
TURBULENCE_DEPTH = 7  # textures/noise_texture.rs:28 passes depth=7

_U32 = np.uint32
_MASK8 = np.int32(POINT_COUNT - 1)


def _mix32(h):
    """Avalanche mixer on uint32 built from adds/xors/shifts only.

    32-bit integer multiplies are the slow op on the TPU VPU (measured:
    they dominated the murmur-based turbulence); xorshift rounds with a
    golden-ratio add run at full vector rate.  Quality only needs to spread
    8 bits of lattice entropy over the uniform bits — far below a
    general-purpose hash bar.
    """
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        h = h ^ (h >> _U32(16))
        h = h + _U32(0x9E37_79B9)
        h = h ^ (h << _U32(13))
        h = h ^ (h >> _U32(17))
        h = h ^ (h << _U32(5))
        h = h ^ (h >> _U32(16))
    return h


def _perm8(x, k1, k2):
    """Seed-keyed bijection on 0..255 (inputs uint32 in-range).

    Every round is invertible on 8 bits: xor/add constants, shift-add
    multiplication by odd 9/5/3 (x + (x<<k) mod 256 — no integer multiply
    instruction), and x ^= x >> k (triangular).  Composition is therefore a
    permutation.
    """
    m8 = _U32(0xFF)
    x = (x ^ k1) & m8
    x = (x + (x << _U32(3))) & m8  # * 9
    x = x ^ (x >> _U32(4))
    x = (x + k2) & m8
    x = (x + (x << _U32(2))) & m8  # * 5
    x = x ^ (x >> _U32(3))
    x = (x + (x << _U32(1))) & m8  # * 3
    x = x ^ (x >> _U32(2))
    return x


def _grad_xyz(h, gseed, xp):
    """Gradient components for lattice hash ``h`` as three separate
    arrays: normalize(uniform(-1,1)^3), the reference's cube-corner-biased
    distribution (perlin_noise.rs:26-34), with the three uniforms drawn
    from ARX hashes of (h, axis).  Component form (no trailing size-3
    axis) keeps every intermediate in the natural (sublane, lane) layout —
    required inside Pallas kernels, harmless under plain XLA."""
    with np.errstate(over="ignore"):
        h32 = h.astype(_U32)
        # Spread the 8 lattice bits across the word before mixing.
        h32 = h32 | (h32 << _U32(8)) | (h32 << _U32(16)) | (h32 << _U32(24))
        hh = h32 ^ gseed
    comps = []
    for salt in (_U32(0x68E3_1DA4), _U32(0xB529_7A4D), _U32(0x334D_4C65)):
        bits = _mix32(hh ^ salt)
        u = bits.astype(np.float32) * np.float32(2.0 ** -32)
        comps.append(2.0 * u - 1.0)
    gx, gy, gz = comps
    inv = 1.0 / xp.sqrt(xp.maximum(gx * gx + gy * gy + gz * gz, 1e-12))
    return gx * inv, gy * inv, gz * inv


def _grad(h, gseed, xp):
    """Stacked-form ``_grad_xyz`` ([..., 3]); kept for make_tables and the
    stacked turbulence path (values identical: the sum over a 3-long axis
    reduces left-to-right, exactly the component expression)."""
    gx, gy, gz = _grad_xyz(h, gseed, xp)
    return xp.stack([gx, gy, gz], axis=-1)


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
    """Pytree: hash keys + their materialised table form.

    ``vectors``/``perm_*`` are exactly ``_grad``/``_perm8`` evaluated on
    0..255 — the gather-based ``noise()`` (oracle, tests) and the computed
    ``turbulence()`` (renderer) agree by construction.
    """

    keys: PerlinKeys
    vectors: np.ndarray  # [256, 3] float32 gradient vectors
    perm_x: np.ndarray  # [256] int32
    perm_y: np.ndarray  # [256] int32
    perm_z: np.ndarray  # [256] int32


def make_keys(seed: int = 0) -> PerlinKeys:
    # 0-d arrays (not NumPy scalars): array uint32 arithmetic wraps silently.
    s = np.asarray(seed, _U32) ^ _U32(0x05E1_1A57)
    ks = [_mix32(s + np.asarray(i * 0x9E37_79B9 & 0xFFFF_FFFF, _U32))
          for i in range(7)]
    return PerlinKeys(
        kx1=ks[0] & _U32(0xFF), kx2=ks[1] & _U32(0xFF),
        ky1=ks[2] & _U32(0xFF), ky2=ks[3] & _U32(0xFF),
        kz1=ks[4] & _U32(0xFF), kz2=ks[5] & _U32(0xFF),
        gseed=ks[6],
    )


def make_tables(seed: int = 0) -> PerlinTables:
    keys = make_keys(seed)
    idx = np.arange(POINT_COUNT, dtype=_U32)
    return PerlinTables(
        keys=keys,
        vectors=np.asarray(_grad(idx, keys.gseed, np), np.float32),
        perm_x=_perm8(idx, keys.kx1, keys.kx2).astype(np.int32),
        perm_y=_perm8(idx, keys.ky1, keys.ky2).astype(np.int32),
        perm_z=_perm8(idx, keys.kz1, keys.kz2).astype(np.int32),
    )
