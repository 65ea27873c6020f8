"""The fused forward shading of a bounce, K6 (``csrc/shade.cu``).

``render.shade_hits`` launches it for a forward-only wavefront on the
card: one launch a bounce in place of the eager path's hundreds of
elementwise launches (the background, the winner's row gather,
``intersect.hit_detail``, ``textures.texture_value`` with K2's marble,
``materials.shade`` and its RNG draws, the radiance and throughput
update).  It has no backward; the eager path stays the CPU's, the train
step's and the twin that K6 is held to on the card, lane for lane and
bit for bit (``tests/test_torch_shade.py``).

One library serves every scene: a lane branches on its winner's
primitive, texture and material tags, and three flags of the scene
(``shade_flags``) come with each launch.  The host reads the joined
float row's columns from ``intersect.shade_pack_layout``
(``pack_columns``), the same layout the eager gather cuts.  The launch
runs inside a torch operator of its own (``torch.ops.hrt_torch.shade``):
the profiler links a kernel to the operator that launched it, so K6's
device time lands in the ``shade`` span of a profile, where a launch
from plain ctypes is linked to nothing, whichever CUDA runtime the
library is built against.

Contract of ``shade_lanes``: the wavefront's o, d [N, 3], time [N], the
bounce words bb [N] int64, the trace's t_hit [N] float32 and prim [N]
int32, alive [N] bool, throughput and radiance [N, 3], all float32
unless named, contiguous, on one CUDA device; returns (o, d, alive,
throughput, radiance) as ``shade_hits`` would with ``differentiable``
false.  Tracing: each launch runs in the span ``K6`` and counts
``K6.launches`` and its lanes in ``K6.lanes`` (``cuda_build.launch``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .intersect import shade_pack_layout
from .perlin import POINT_COUNT

# The flag bits of csrc/shade.cu: the branches every lane of a scene
# takes or skips alike.
FLAG_XFORM = 1  # rotated rects and boxes: the ray into object space
FLAG_MOTION = 2  # moving spheres: the center's lerp
FLAG_NOISE = 4  # the noise texture: the Perlin tables in shared memory

# The fields of csrc/shade.cu's Cols after the row width, in its order.
PACK_FIELDS = ("p0", "p1", "radius", "time0", "time1", "rot", "trans",
               "fuzz", "albedo", "ior", "color1", "color2", "scale")


def shade_flags(static) -> int:
    """The scene's flags as K6 reads them (``SceneStatic``)."""
    return ((FLAG_XFORM if static.has_ray_xform else 0)
            | (FLAG_MOTION if static.has_motion else 0)
            | (FLAG_NOISE if static.has_noise_tex else 0))


def pack_columns(static) -> tuple:
    """(row width, then each of ``PACK_FIELDS``' first column in the
    joined float row, -1 where the scene packs no such field)."""
    offsets, off = {}, 0
    for name, w in shade_pack_layout(static):
        offsets[name] = off
        off += w
    return (off, *(offsets.get(name, -1) for name in PACK_FIELDS))


def _bind(lib):
    fn = lib.hrt_shade
    ptr, c_int, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ctypes.c_uint] + [ptr] * 9 + [i64] + [ptr] * 5
                   + [c_int] * 3 + [ptr] * 4 + [c_int, ptr] + [ptr] * 5
                   + [ptr])
    fn.restype = c_int
    return fn


_LIB = torch.library.Library("hrt_torch", "DEF")
_LIB.define(
    "shade(int flags, Tensor o, Tensor d, Tensor time, Tensor bb, "
    "Tensor t_hit, Tensor prim, Tensor alive, Tensor throughput, "
    "Tensor radiance, Tensor fpack, Tensor ipack, int[] cols, "
    "Tensor images, Tensor image_wh, Tensor vectors, Tensor perm_x, "
    "Tensor perm_y, Tensor perm_z, int sky, float[] bg) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def _shade_cuda(flags, o, d, time, bb, t_hit, prim, alive, throughput,
                radiance, fpack, ipack, cols, images, image_wh, vectors,
                perm_x, perm_y, perm_z, sky, bg):
    """The operator's CUDA kernel: K6's launch on validated tensors."""
    device, n = o.device, o.shape[0]
    f32 = torch.float32
    outs = (torch.empty((n, 3), dtype=f32, device=device),
            torch.empty((n, 3), dtype=f32, device=device),
            torch.empty((n,), dtype=torch.bool, device=device),
            torch.empty((n, 3), dtype=f32, device=device),
            torch.empty((n, 3), dtype=f32, device=device))
    if n == 0:
        return outs
    ni, ih, iw, _ = images.shape
    fn = _bind(cuda_build.load("shade"))
    o_out, d_out, alive_out, thr_out, rad_out = outs
    cuda_build.launch(
        "shade", fn, device, flags, o.data_ptr(), d.data_ptr(),
        time.data_ptr(), bb.data_ptr(), t_hit.data_ptr(), prim.data_ptr(),
        alive.data_ptr(), throughput.data_ptr(), radiance.data_ptr(), n,
        fpack.data_ptr(), ipack.data_ptr(),
        (ctypes.c_int * len(cols))(*cols), images.data_ptr(),
        image_wh.data_ptr(), ni, ih, iw, vectors.data_ptr(),
        perm_x.data_ptr(), perm_y.data_ptr(), perm_z.data_ptr(), sky,
        (ctypes.c_float * len(bg))(*bg), o_out.data_ptr(), d_out.data_ptr(),
        thr_out.data_ptr(), rad_out.data_ptr(), alive_out.data_ptr(),
        tag="K6", lanes=n)
    return outs


_LIB.impl("shade", _shade_cuda, "CUDA")


def shade_lanes(scene, o, d, time, bb, t_hit, prim, alive, throughput,
                radiance, background, sky):
    """K6 over the wavefront (the module's contract): (o, d, alive,
    throughput, radiance) after the bounce.  ``scene``: the
    ``SceneTensors``; ``background``: the scene's constant color, or None
    for the gradient sky whose two colors are ``sky`` (white, blue).
    Raises unless every tensor is as the contract says."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"shade: K6 runs on CUDA tensors, not {device}")
    static, tables = scene.static, scene.tables
    n = o.shape[0]
    cols = pack_columns(static)
    p = scene.fpack.shape[0]
    ni, ih, iw, _ = tables.images.shape
    f32, i32 = torch.float32, torch.int32
    perlin = tables.perlin
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("bb", bb, (n,), torch.int64),
            ("t_hit", t_hit, (n,), f32), ("prim", prim, (n,), i32),
            ("alive", alive, (n,), torch.bool),
            ("throughput", throughput, (n, 3), f32),
            ("radiance", radiance, (n, 3), f32),
            ("fpack", scene.fpack, (p, cols[0]), f32),
            ("ipack", scene.ipack, (p, 7), i32),
            ("images", tables.images, (ni, ih, iw, 3), f32),
            ("image_wh", tables.image_wh, (ni, 2), i32),
            ("vectors", perlin.vectors, (POINT_COUNT, 3), f32),
            *((name, getattr(perlin, name), (POINT_COUNT,), i32)
              for name in ("perm_x", "perm_y", "perm_z"))):
        cuda_build.check_arg("shade", name, x, shape, dtype, device)
    colors = tuple(sky) if background is None else (tuple(background),) * 2
    return torch.ops.hrt_torch.shade(
        shade_flags(static), o, d, time, bb, t_hit, prim, alive,
        throughput, radiance, scene.fpack, scene.ipack, list(cols),
        tables.images, tables.image_wh, perlin.vectors, perlin.perm_x,
        perlin.perm_y, perlin.perm_z, int(background is None),
        [float(x) for c in colors for x in c])
