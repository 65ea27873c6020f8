"""The noise texture's branch of ``texture_value``: the marble value
(Perlin turbulence) on noise lanes, the incoming value elsewhere.

Two implementations of one contract:

* ``noise_texture``: the wrapper of the hand-written Hopper kernel
  ``csrc/turbulence.cu``, which replaces the TPU kernel
  ``tools/prof_tex.py::make_pallas_turb`` (the block-sparse marble) and
  the eager operations around it in one launch.  It reads the Perlin
  tables from shared memory and compacts the noise lanes inside each
  block; the design note is at the top of the CUDA source.
* ``noise_texture_plain``: the same function in plain torch, the eager
  branch (``marble_plain`` on the pre-scaled point, then ``where``).  CPU
  tensors take it; on the card it is only the reference the kernel is
  checked against.

Contract: ``ttype`` [N] int32 and ``scale`` [N] float32, any stride (the
columns of the gathered shade rows); ``point`` and ``value`` [N, 3]
float32 with contiguous columns; ``tables`` the scene's
``textures.TextureTables`` (its Perlin keys for the plain version, its
Perlin tables for the kernel).  Returns [N, 3] float32:
``0.5 * (1 + sin(z + 10 * turbulence(x, y, z)))`` in all three channels,
with ``(x, y, z) = scale * point``, where ``ttype == TT_NOISE``, and
``value`` elsewhere.  The two agree bit for bit: the kernel performs the
plain version's IEEE operations in the same order, with the same
``sinf``, and its tables hold exactly the plain version's hashes.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.scene import TT_NOISE
from ..utils import cuda_build
from .perlin import POINT_COUNT, turbulence_xyz


def _marble_formula(z, turb):
    return 0.5 * (1.0 + torch.sin(z + 10.0 * turb))


def marble_plain(mask, x, y, z, keys):
    """Plain-torch marble of the pre-scaled point (x, y, z) on the masked
    lanes, 0 elsewhere; ``keys`` the seven Perlin keys as Python ints."""
    out = torch.zeros_like(x)
    idx = mask.nonzero().squeeze(1)
    if idx.numel():
        xs, ys, zs = x[idx], y[idx], z[idx]
        out[idx] = _marble_formula(zs, turbulence_xyz(keys, xs, ys, zs))
    return out


def noise_texture_plain(ttype, scale, point, value, tables):
    """The noise branch in plain torch: marble on noise lanes, ``value``
    elsewhere."""
    is_noise = ttype == TT_NOISE
    sp = scale[..., None] * point
    m = marble_plain(is_noise, *(sp[..., c].contiguous() for c in range(3)),
                     tables.perlin_keys)
    return torch.where(is_noise[..., None], m[..., None].expand_as(value),
                       value)


def _bind(lib):
    fn = lib.hrt_noise_texture
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, i64] * 4 + [ptr] * 4 + [ctypes.c_int] * 2 \
        + [ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def _view_stride(name, x, shape, dtype, device):
    """Raise unless ``x`` is on ``device`` with ``dtype`` and ``shape``
    ([n], or [n, 3] with contiguous columns); return its row stride, as
    the kernel indexes it."""
    if x.device != device:
        raise ValueError(f"noise_texture: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"noise_texture: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"noise_texture: {name} has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if len(shape) == 2 and x.stride(1) != 1:
        raise ValueError(f"noise_texture: {name}'s columns are not "
                         "contiguous")
    return x.stride(0)


def noise_texture(ttype, scale, point, value, tables):
    """The noise branch of ``texture_value`` [N, 3].  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (building it on
    first use) or raises.  Counts its kernel launches in
    ``noise_texture.launches``."""
    device = point.device
    if device.type == "cpu":
        return noise_texture_plain(ttype, scale, point, value, tables)
    if device.type != "cuda":
        raise ValueError(f"noise_texture: unsupported device {device}")
    n = point.shape[0]
    views = []
    for name, x, shape, dtype in (
            ("ttype", ttype, (n,), torch.int32),
            ("scale", scale, (n,), torch.float32),
            ("point", point, (n, 3), torch.float32),
            ("value", value, (n, 3), torch.float32)):
        views += [x.data_ptr(), _view_stride(name, x, shape, dtype, device)]
    perlin = tables.perlin
    cuda_build.check_arg("noise_texture", "vectors", perlin.vectors,
                         (POINT_COUNT, 3), torch.float32, device)
    for name in ("perm_x", "perm_y", "perm_z"):
        cuda_build.check_arg("noise_texture", name, getattr(perlin, name),
                             (POINT_COUNT,), torch.int32, device)
    if n >= 2**31:
        raise ValueError(f"noise_texture: {n} lanes exceed 32-bit indexing")
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    if n == 0:
        return out
    fn = _bind(cuda_build.load("turbulence"))
    cuda_build.launch("noise_texture", fn, device, *views,
                      perlin.vectors.data_ptr(), perlin.perm_x.data_ptr(),
                      perlin.perm_y.data_ptr(), perlin.perm_z.data_ptr(),
                      TT_NOISE, n, out.data_ptr())
    noise_texture.launches += 1
    return out


noise_texture.launches = 0
