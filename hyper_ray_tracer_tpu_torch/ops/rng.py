"""Counter-based, stateless RNG on torch tensors, bit for bit the JAX
package's ``hyper_ray_tracer_tpu/ops/rng.py``.

Every random draw is a pure function of where it is used,

    u = uniform(seed, pixel_id, sample_id, bounce, purpose[, salt])

so a render is reproducible and the port's samples line up draw for draw
with the JAX renderer and the NumPy oracle.

Word representation: torch's ``uint32`` lacks shifts and additions on the
CPU, so a 32-bit word is an ``int64`` tensor holding a value in
[0, 2**32), and every operation that can leave that range is masked with
``& MASK``.  A product of two full words (up to 2**64) would overflow
int64, so ``_mul32`` splits the right operand into 16-bit halves and every
partial product stays below 2**49.  RNG words stay integer tensors end to
end; they are never carried through a float tensor.

Python ints are accepted wherever a tensor is (they follow the same
arithmetic), so constants and scalar seeds need no conversion.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF

# Stream / purpose identifiers: part of the RNG spec shared with the JAX
# package and the oracle (same values as hyper_ray_tracer_tpu.ops.rng).
P_CAM_JITTER_U = 0x01
P_CAM_JITTER_V = 0x02
P_LENS_U = 0x03
P_LENS_V = 0x04
P_TIME = 0x05
P_LAMBERT_A = 0x10
P_LAMBERT_B = 0x11
P_SPHERE_A = 0x12  # random_in_unit_sphere (metal fuzz / isotropic): 3 draws
P_SPHERE_B = 0x13
P_SPHERE_C = 0x14
P_DIELECTRIC = 0x15
P_MEDIUM = 0x20

_GOLDEN = 0x9E3779B9
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35
_INV24 = 1.0 / (1 << 24)  # exact in float32


def _u32(x):
    """A word: int64 tensor (or Python int) reduced mod 2**32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mul32(x, y):
    """x * y mod 2**32 for words x, y without int64 overflow."""
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def fmix32(h):
    """xxhash/murmur3 avalanche finaliser (word in, word out)."""
    h = _u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    h = h ^ (h >> 16)
    return h


def hash_words(seed, *words):
    """Combine words into one well-mixed word (murmur3-style)."""
    h = _u32(seed) ^ 0x9747B28C
    for w in words:
        k = _mul32(_u32(w), _C1)
        k = _rotl(k, 15)
        k = _mul32(k, _C2)
        h = h ^ k
        h = _rotl(h, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & MASK
    return fmix32(h)


def bits_to_uniform(bits):
    """Word -> float32 uniform in [0, 1) from the top 24 bits (exact)."""
    return (_u32(bits) >> 8).to(torch.float32) * _INV24


def ray_base(seed, pixel_id, sample_id):
    """Per-(pixel, sample) base hash; all camera + bounce draws derive from it."""
    return hash_words(seed, pixel_id, sample_id)


def stream_bits(base, purpose, salt=0):
    """Derive one word from a base hash, a purpose constant, and a salt."""
    mixed = (_u32(base) + _mul32(_u32(purpose), _GOLDEN)
             + _mul32(_u32(salt), _F1)) & MASK
    return fmix32(mixed)


def uniform(base, purpose, salt=0):
    """float32 uniform in [0,1) for a named stream."""
    return bits_to_uniform(stream_bits(base, purpose, salt))


def bounce_base(base, bounce):
    """Fold the bounce index into a per-(pixel,sample) base hash."""
    return fmix32((_u32(base) + _mul32(_u32(bounce), _C2)) & MASK)
