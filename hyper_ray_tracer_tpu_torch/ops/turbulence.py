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

Its backward is a second kernel in the same source, K2b
(``noise_texture_grad``; the JAX package differentiates this branch
through XLA, ``ops/textures.py:65-70`` and ``ops/perlin.py:203-254``).
For the cotangent ``grad_out`` [N, 3] it returns (grad_point [N, 3],
grad_scale [N], grad_value [N, 3]): on noise lanes ``scale * g``,
``<point, g>`` and 0, with ``g = (sum_c grad_out_c) d marble / d sp``;
elsewhere 0, 0 and ``grad_out``.  Its plain version is autograd through
``noise_texture_plain`` (``noise_texture_grad_plain``).  They agree to
rounding, not bit for bit: the kernel sums the analytic derivative of
each octave (contracted into FMAs), autograd the chain rule of each
operation.  K2b reads what K2 saved of the forward
(``noise_texture_saved``; ``noise_texture_saved_plain`` is its plain
version, bit for bit): the noise flags as a bitmask (int32 words, bit
``l`` of word ``w`` the flag of lane ``32 w + l``) and each noise lane's
signed turbulence sum S (``ops/perlin.turbulence_sum_xyz``; other lanes
unwritten on the card, 0 in the plain version).  K2 writes them only
when the branch's output requires grad.

Tracing (``utils/profiling.py``): each launch runs in the span ``K2``
or ``K2b`` and counts in ``K2.launches`` / ``K2b.launches`` and its
lanes in ``K2.lanes`` / ``K2b.lanes``; a K2 launch that saves also in
``K2.saves``.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.scene import TT_NOISE, TT_SOLID
from ..utils import cuda_build
from ..utils.profiling import count
from .perlin import POINT_COUNT, turbulence_sum_xyz, turbulence_xyz


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


def noise_texture_saved_plain(ttype, scale, point, value, tables):
    """(out, (mask, turb)): ``noise_texture_plain``'s value and what K2
    saves for K2b, in plain torch."""
    is_noise = ttype == TT_NOISE
    n = is_noise.shape[0]
    bits = torch.zeros(-(-n // 32) * 32, dtype=torch.int64,
                       device=is_noise.device)
    bits[:n] = is_noise.long()
    words = (bits.view(-1, 32) << torch.arange(
        32, device=bits.device)).sum(1)
    mask = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    sp = scale[..., None] * point
    turb = torch.zeros_like(scale)
    idx = is_noise.nonzero().squeeze(1)
    if idx.numel():
        turb[idx] = turbulence_sum_xyz(tables.perlin_keys,
                                       *(sp[idx, c] for c in range(3)))
    return noise_texture_plain(ttype, scale, point, value, tables), \
        (mask, turb)


def noise_texture_grad_plain(ttype, scale, point, grad_out, tables):
    """The noise branch's VJP in plain torch: autograd through
    ``noise_texture_plain``.  Returns (grad_point [N, 3], grad_scale [N],
    grad_value [N, 3])."""
    with torch.enable_grad():
        s = scale.detach().requires_grad_()
        p = point.detach().requires_grad_()
        v = torch.zeros_like(grad_out, requires_grad=True)
        out = noise_texture_plain(ttype, s, p, v, tables)
        return torch.autograd.grad(out, (p, s, v), grad_out)


def _bind(lib, name):
    fn = getattr(lib, name)
    ptr, i64, c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "hrt_noise_texture":
        fn.argtypes = [ptr, i64] * 4 + [ptr] * 4 + [c_int] * 2 + [ptr] * 4
    else:
        fn.argtypes = [ptr, ptr] + [ptr, i64] * 2 + [ptr] * 5 + [c_int] \
            + [ptr] * 4
    fn.restype = c_int
    return fn


def _view_stride(kernel, name, x, shape, dtype, device):
    """Raise unless ``x`` is on ``device`` with ``dtype`` and ``shape``
    ([n], or [n, 3] with contiguous columns); return its row stride, as
    the kernel indexes it."""
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if len(shape) == 2 and x.stride(1) != 1:
        raise ValueError(f"{kernel}: {name}'s columns are not "
                         "contiguous")
    return x.stride(0)


def _lane_views(kernel, device, n, **named):
    """[pointer, row stride] of each named input (ttype, scale, point or
    value, in the entry point's order), validated."""
    kinds = {"ttype": ((n,), torch.int32), "scale": ((n,), torch.float32)}
    views = []
    for name, x in named.items():
        shape, dtype = kinds.get(name, ((n, 3), torch.float32))
        views += [x.data_ptr(),
                  _view_stride(kernel, name, x, shape, dtype, device)]
    return views


def _table_ptrs(kernel, tables, device):
    perlin = tables.perlin
    cuda_build.check_arg(kernel, "vectors", perlin.vectors,
                         (POINT_COUNT, 3), torch.float32, device)
    for name in ("perm_x", "perm_y", "perm_z"):
        cuda_build.check_arg(kernel, name, getattr(perlin, name),
                             (POINT_COUNT,), torch.int32, device)
    return [perlin.vectors.data_ptr(), perlin.perm_x.data_ptr(),
            perlin.perm_y.data_ptr(), perlin.perm_z.data_ptr()]


def _launch_marble(ttype, scale, point, value, tables, save):
    """K2 on CUDA tensors: (the noise branch's value [N, 3], and with
    ``save`` the (mask, turb) that K2b reads, else None)."""
    device = point.device
    n = point.shape[0]
    views = _lane_views("noise_texture", device, n, ttype=ttype,
                        scale=scale, point=point, value=value)
    ptrs = _table_ptrs("noise_texture", tables, device)
    if n >= 2**31:
        raise ValueError(f"noise_texture: {n} lanes exceed 32-bit indexing")
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    saved = None
    if save:
        saved = (torch.empty((-(-n // 32),), dtype=torch.int32,
                             device=device),
                 torch.empty((n,), dtype=torch.float32, device=device))
    if n == 0:
        return out, saved
    fn = _bind(cuda_build.load("turbulence"), "hrt_noise_texture")
    cuda_build.launch("noise_texture", fn, device, *views, *ptrs, TT_NOISE,
                      n, out.data_ptr(),
                      *((x.data_ptr() for x in saved) if save
                        else (None, None)), tag="K2", lanes=n)
    if save:
        count("K2.saves")
    return out, saved


def noise_texture_saved(ttype, scale, point, value, tables):
    """(out, (mask, turb)): the noise branch's value and what K2b reads
    of the forward.  A CPU tensor takes the plain version; a CUDA tensor
    launches K2 with its save (traced as ``K2``, counted in ``K2.saves``)
    or raises."""
    device = point.device
    if device.type == "cpu":
        return noise_texture_saved_plain(ttype, scale, point, value, tables)
    if device.type != "cuda":
        raise ValueError(f"noise_texture: unsupported device {device}")
    return _launch_marble(ttype, scale, point, value, tables, save=True)


def noise_texture_grad(scale, point, grad_out, tables, saved):
    """The VJP of the noise branch for the cotangent ``grad_out`` [N, 3]
    at the lanes that ``saved``, the (mask, turb) that
    ``noise_texture_saved`` returned for them, marks as noise:
    (grad_point [N, 3], grad_scale [N], grad_value [N, 3]).  A CPU tensor
    takes the plain version (on the saved mask; it recomputes the sums);
    a CUDA tensor launches the kernel K2b (building it on first use) on
    the saved mask and sums, or raises.  A launch is traced as ``K2b``
    (``cuda_build.launch``)."""
    device = point.device
    if device.type == "cpu":
        n = point.shape[0]
        bits = (saved[0][:, None] >> torch.arange(32)) & 1
        ttype = torch.where(bits.flatten()[:n] == 1, TT_NOISE, TT_SOLID)
        return noise_texture_grad_plain(ttype, scale, point, grad_out,
                                        tables)
    if device.type != "cuda":
        raise ValueError(f"noise_texture_grad: unsupported device {device}")
    n = point.shape[0]
    mask, turb = saved
    grad_out = grad_out.contiguous()
    cuda_build.check_arg("noise_texture_grad", "mask", mask, (-(-n // 32),),
                         torch.int32, device)
    cuda_build.check_arg("noise_texture_grad", "turb", turb, (n,),
                         torch.float32, device)
    views = _lane_views("noise_texture_grad", device, n, scale=scale,
                        point=point)
    cuda_build.check_arg("noise_texture_grad", "grad_out", grad_out, (n, 3),
                         torch.float32, device)
    ptrs = _table_ptrs("noise_texture_grad", tables, device)
    if n >= 2**31:
        raise ValueError(f"noise_texture_grad: {n} lanes exceed 32-bit "
                         "indexing")
    grad_point = torch.empty((n, 3), dtype=torch.float32, device=device)
    grad_scale = torch.empty((n,), dtype=torch.float32, device=device)
    grad_value = torch.empty((n, 3), dtype=torch.float32, device=device)
    if n == 0:
        return grad_point, grad_scale, grad_value
    fn = _bind(cuda_build.load("turbulence"), "hrt_noise_texture_grad")
    cuda_build.launch("noise_texture_grad", fn, device, mask.data_ptr(),
                      turb.data_ptr(), *views, grad_out.data_ptr(), *ptrs,
                      n, grad_point.data_ptr(), grad_scale.data_ptr(),
                      grad_value.data_ptr(), tag="K2b", lanes=n)
    return grad_point, grad_scale, grad_value


class _NoiseTexture(torch.autograd.Function):
    """K2 forward with its save, K2b backward."""

    @staticmethod
    def forward(ctx, ttype, scale, point, value, tables):
        out, (mask, turb) = _launch_marble(ttype, scale, point, value,
                                           tables, save=True)
        ctx.save_for_backward(scale, point, mask, turb)
        ctx.tables = tables
        return out

    @staticmethod
    def backward(ctx, grad_out):
        scale, point, mask, turb = ctx.saved_tensors
        grad_point, grad_scale, grad_value = noise_texture_grad(
            scale, point, grad_out, ctx.tables, (mask, turb))
        return None, grad_scale, grad_point, grad_value, None


def noise_texture(ttype, scale, point, value, tables):
    """The noise branch of ``texture_value`` [N, 3], differentiable in
    ``scale``, ``point`` and ``value``.  A CPU tensor takes the plain
    version (autograd through it); a CUDA tensor launches K2 (building it
    on first use) or raises.  When the output requires grad, K2 also
    saves what K2b, its backward, reads; otherwise it writes the value
    alone.  A launch is traced as ``K2`` (``cuda_build.launch``), one that
    saved also counted in ``K2.saves``."""
    device = point.device
    if device.type == "cpu":
        return noise_texture_plain(ttype, scale, point, value, tables)
    if device.type != "cuda":
        raise ValueError(f"noise_texture: unsupported device {device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (scale, point, value)):
        return _NoiseTexture.apply(ttype, scale, point, value, tables)
    return _launch_marble(ttype, scale, point, value, tables,
                          save=False)[0]
