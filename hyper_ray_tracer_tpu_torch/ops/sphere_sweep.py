"""The sphere sweep: closest hit of every ray over every sphere.

This is the trace step of sphere-only scenes (the CLI's default ``random``
scene among them).  Two implementations of one contract:

* ``sphere_sweep``: the wrapper of the hand-written Hopper kernel
  ``csrc/sphere_sweep.cu``, which replaces the TPU kernel
  ``hyper_ray_tracer_tpu/ops/pallas_sweep.py::_kernel``.  The kernel is
  bound by FP32 ALU work per ray-sphere pair; it keeps one thread per ray
  and stages 128 spheres at a time in shared memory (the design note is at
  the top of the CUDA source).
* ``sphere_sweep_plain``: the same function in plain torch, tiled over
  spheres so memory stays bounded.  It follows the JAX package's
  ``sphere_t`` and ``scan_all`` fold.  CPU tensors take it; on the card it
  is only the reference the kernel is checked against.

Contract (``pallas_sweep.py:1-22,38-103``, ``ops/bvh.py:310-318,399``):
rays ``o`` [N,3], unnormalised ``d`` [N,3], ``time`` [N] float32 and
``active`` [N] bool; spheres ``p0``, ``p1`` [P,3], ``time0``, ``time1``,
``radius`` [P] float32 (a static sphere has p1 == p0, time0=0, time1=1).
Returns ``t_best`` [N] float32 and ``best`` [N] int32: the closest hit in
[t_min, inf) and its sphere index, ties to the lowest index, (BIG, -1) for
a miss or an inactive ray.

The two agree bit for bit: the kernel performs the plain version's IEEE
operations in the same order, with no FMA contraction and true divisions.
Without that, near-tangent discriminants and self-hits at the t_min
boundary round to different decisions, and ~1e-4 of the rays of the
`random` scene change winner by far more than a near-tie.
"""

from __future__ import annotations

import ctypes

import torch

from .intersect import BIG, PrimFields, sphere_t

PLAIN_TILE = 128  # spheres per step of the plain version


def sphere_sweep_plain(p0, p1, time0, time1, radius, o, d, time, active,
                       t_min: float = 1.0e-3):
    """Plain-torch sweep; the fold is ``scan_all``'s: per tile of spheres,
    candidate t's against the running best as inclusive bound, the first
    in-tile minimum, and a strict < across tiles."""
    n = o.shape[0]
    t_best = torch.where(active, BIG, -BIG).to(torch.float32)
    best = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    o_b, d_b, time_b = o[:, None, :], d[:, None, :], time[:, None]
    for start in range(0, p0.shape[0], PLAIN_TILE):
        sl = slice(start, start + PLAIN_TILE)
        pf = PrimFields(p0=p0[None, sl], p1=p1[None, sl],
                        radius=radius[None, sl],
                        time0=time0[None, sl], time1=time1[None, sl])
        # has_motion=True is exact for static spheres too: p1 - p0 == 0.
        t = sphere_t(pf, o_b, d_b, time_b, t_min, t_best[:, None],
                     has_motion=True)  # [N, tile]
        tt, j = torch.min(t, dim=1)  # first index of the minimum
        upd = tt < t_best
        t_best = torch.where(upd, tt, t_best)
        best = torch.where(upd, (start + j).to(torch.int32), best)
    return torch.where(active, t_best, BIG), best


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"sphere_sweep: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"sphere_sweep: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"sphere_sweep: {name} has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"sphere_sweep: {name} is not contiguous")


def _bind(lib):
    fn = lib.hrt_sphere_sweep
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, c_int,
                   ptr, ptr, ptr, ptr, ptr, c_int, ctypes.c_float,
                   ptr, ptr, ptr]
    fn.restype = c_int
    return fn


def sphere_sweep(p0, p1, time0, time1, radius, o, d, time, active,
                 t_min: float = 1.0e-3):
    """Closest sphere hit per ray.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (building it on first use) or
    raises.  Counts its kernel launches in ``sphere_sweep.launches``."""
    device = o.device
    if device.type == "cpu":
        return sphere_sweep_plain(p0, p1, time0, time1, radius, o, d, time,
                                  active, t_min)
    if device.type != "cuda":
        raise ValueError(f"sphere_sweep: unsupported device {device}")
    n, p = o.shape[0], p0.shape[0]
    f32 = torch.float32
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("active", active, (n,), torch.bool),
            ("p0", p0, (p, 3), f32), ("p1", p1, (p, 3), f32),
            ("time0", time0, (p,), f32), ("time1", time1, (p,), f32),
            ("radius", radius, (p,), f32)):
        _check(name, x, shape, dtype, device)
    if p == 0:
        raise ValueError("sphere_sweep: no spheres")
    if n >= 2**31 // 3:
        raise ValueError(f"sphere_sweep: {n} rays exceed the kernel's "
                         "32-bit indexing")
    t_best = torch.empty(n, dtype=f32, device=device)
    best = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return t_best, best
    from ..utils import cuda_build

    fn = _bind(cuda_build.load("sphere_sweep"))
    # The same operations sphere_t applies (p1 - p0, time1 - time0).
    dp = (p1 - p0).contiguous()
    dt = (time1 - time0).contiguous()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), time.data_ptr(),
                 active.data_ptr(), n, p0.data_ptr(), dp.data_ptr(),
                 time0.data_ptr(), dt.data_ptr(), radius.data_ptr(), p,
                 float(t_min), t_best.data_ptr(), best.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sphere_sweep kernel launch failed: CUDA error "
                           f"{err}")
    sphere_sweep.launches += 1
    return t_best, best


sphere_sweep.launches = 0
