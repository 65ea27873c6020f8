"""The counter-based RNG spec of the path tracer, on int64 torch tensors.

Every random draw is a pure function of (seed, pixel, sample, bounce,
purpose[, salt]).  A 32-bit word is held in an int64 tensor in
[0, 2**32); products split the right operand into 16-bit halves so that
no partial product overflows.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF

P_CAM_JITTER_U = 0x01
P_CAM_JITTER_V = 0x02
P_LENS_U = 0x03
P_LENS_V = 0x04
P_TIME = 0x05
P_LAMBERT_A = 0x10
P_LAMBERT_B = 0x11
P_SPHERE_A = 0x12
P_SPHERE_B = 0x13
P_SPHERE_C = 0x14
P_DIELECTRIC = 0x15
P_MEDIUM = 0x20

_GOLDEN = 0x9E3779B9
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mul32(x, y):
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def fmix32(h):
    h = _u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def hash_words(seed, *words):
    h = _u32(seed) ^ 0x9747B28C
    for w in words:
        k = _mul32(_u32(w), _C1)
        k = _rotl(k, 15)
        k = _mul32(k, _C2)
        h = h ^ k
        h = _rotl(h, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & MASK
    return fmix32(h)


def ray_base(seed, pixel_id, sample_id):
    return hash_words(seed, pixel_id, sample_id)


def bounce_base(base, bounce):
    return fmix32((_u32(base) + _mul32(_u32(bounce), _C2)) & MASK)


def uniform(base, purpose, salt=0, dtype=torch.float32):
    """Uniform in [0, 1) from the top 24 bits of the stream's word."""
    mixed = (_u32(base) + _mul32(_u32(purpose), _GOLDEN)
             + _mul32(_u32(salt), _F1)) & MASK
    return ((fmix32(mixed) >> 8).to(torch.float32)
            * (1.0 / (1 << 24))).to(dtype)
