"""The sphere sweep: closest hit of every ray over every sphere.

This is the trace step of sphere-only scenes (the CLI's default ``random``
scene among them).  Two implementations of one contract:

* ``sphere_sweep``: the wrapper of the hand-written Hopper kernel
  ``csrc/sphere_sweep.cu``, which replaces the TPU kernel
  ``hyper_ray_tracer_tpu/ops/pallas_sweep.py::_kernel``.  The kernel is
  bound by FP32 issue per ray-sphere pair; it carries a packet of rays per
  thread and streams packed sphere records through a double-buffered
  shared-memory ring (the design note is at the top of the
  CUDA source).  The records are packed once per scene
  (``sphere_records``) and cached on the sphere tensors.
* ``sphere_sweep_plain``: the same function in plain torch, tiled over
  spheres so memory stays bounded.  It follows the JAX package's
  ``sphere_t`` and ``scan_all`` fold.  CPU tensors take it; on the card it
  is only the reference the kernel is checked against.

Contract (``pallas_sweep.py:1-22,38-103``, ``ops/bvh.py:310-318,399``):
rays ``o`` [N,3], unnormalised ``d`` [N,3], ``time`` [N] float32 and
``active`` [N] bool; spheres ``p0``, ``p1`` [P,3], ``time0``, ``time1``,
``radius`` [P] float32.
Returns ``t_best`` [N] float32 and ``best`` [N] int32: the closest hit in
[t_min, inf) and its sphere index, ties to the lowest index, (BIG, -1) for
a miss or an inactive ray.  The partitioned form (``mask``, ``groups``:
at most 2 partition groups of ``ops/partition.py``, each lane's uint8
mask with bit G-1-i for group i): a lane folds group i's spheres only
when its mask has that bit, and every other sphere as before; since the
masks are conservative, it returns what the plain form does.

The two agree bit for bit: the kernel performs the plain version's IEEE
operations in the same order, with no FMA contraction and true divisions.
Without that, near-tangent discriminants and self-hits at the t_min
boundary round to different decisions, and ~1e-4 of the rays of the
`random` scene change winner by far more than a near-tie.

Tracing (``utils/profiling.py``): each launch of K1 runs in the span
``K1`` and counts in ``K1.launches`` and its rays in ``K1.lanes``; one
of the partitioned form also in ``K1.partitioned``.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils import cuda_build
from ..utils.profiling import count, host_sync
from .intersect import BIG, PrimFields, sphere_t
from .partition import check_mask, group_bit, group_bounds

PLAIN_TILE = 128  # spheres per step of the plain version


class SphereRecords(NamedTuple):
    """The packed sphere records the kernels stage (csrc/sweep_sphere.cuh),
    NumPy: ``geo`` [P,4] float32 (center p0, r*r), ``aux`` [P,4] float32
    (p1 - p0, the shutter slot's int32 bits), ``shutter`` [S,2] float32
    (time0, time1 - time0 per slot; one (0, 1) row when no sphere has a
    slot), ``has_motion``: some sphere has a slot."""

    geo: np.ndarray
    aux: np.ndarray
    shutter: np.ndarray
    has_motion: bool


def sphere_records(p0, p1, time0, time1, radius, lerp=None) -> SphereRecords:
    """Pack spheres (NumPy float32 arrays) into the kernels' records.

    ``lerp`` [P] bool marks the spheres whose center the plain version
    lerps (default: all, as ``sphere_sweep_plain`` does).  p1 - p0, r * r
    and time1 - time0 are the plain version's IEEE operations, so the
    kernel reads the values the plain version computes.  A lerped sphere
    gets the slot of its (time0, time1 - time0) in the shutter table,
    unless its center cannot move (p1 == p0, time0 = 0, time1 = 1: then
    p0 + f * 0 == p0 for every finite lerp factor f), which keeps slot -1.
    """
    p0, p1 = np.asarray(p0, np.float32), np.asarray(p1, np.float32)
    time0 = np.asarray(time0, np.float32)
    time1 = np.asarray(time1, np.float32)
    radius = np.asarray(radius, np.float32)
    n = p0.shape[0]
    dp = p1 - p0
    dt = time1 - time0
    fixed = (dp == 0).all(1) & (time0 == 0) & (time1 == 1)
    moves = ~fixed if lerp is None else np.asarray(lerp, bool) & ~fixed
    slot = np.full(n, -1, np.int32)
    shutter = np.array([[0.0, 1.0]], np.float32)
    if moves.any():
        shutter, inv = np.unique(np.stack([time0, dt], 1)[moves], axis=0,
                                 return_inverse=True)
        slot[moves] = inv.reshape(-1)
    geo = np.concatenate([p0, (radius * radius)[:, None]], 1)
    aux = np.concatenate([dp, slot.view(np.float32)[:, None]], 1)
    return SphereRecords(geo=np.ascontiguousarray(geo),
                         aux=np.ascontiguousarray(aux),
                         shutter=np.ascontiguousarray(shutter, np.float32),
                         has_motion=bool(moves.any()))


# Device records per sphere set, keyed by its p0 tensor and checked
# against the other four tensors and every tensor's version counter, so
# that a scene's spheres are packed once, not on every launch.
_device_records = WeakIdKeyDictionary()


def device_sphere_records(p0, p1, time0, time1, radius):
    """``sphere_records`` of the five sphere tensors, as tensors on their
    device, packed on first use and cached on the tensors."""
    fields = (p0, p1, time0, time1, radius)
    versions = tuple(x._version for x in fields)
    hit = _device_records.get(p0)
    if hit is not None:
        refs, seen, rec = hit
        if seen == versions and all(r() is x for r, x in zip(refs, fields)):
            return rec
    host = sphere_records(*(host_sync(x.detach().cpu()).numpy()
                            for x in fields))
    rec = host._replace(**{k: host_sync(torch.from_numpy(getattr(host, k))
                                        .to(p0.device))
                           for k in ("geo", "aux", "shutter")})
    _device_records[p0] = (tuple(weakref.ref(x) for x in fields), versions,
                           rec)
    return rec


def _segments(p: int, groups):
    """[0, p) cut at the bounds of ``groups``: (start, end, group index or
    -1) in order."""
    cuts = sorted({0, p} | {c for g in groups for c in (g.start, g.end)
                            if 0 < c < p})
    return [(a, b, next((i for i, g in enumerate(groups)
                         if g.start <= a < g.end), -1))
            for a, b in zip(cuts[:-1], cuts[1:])]


def sphere_sweep_plain(p0, p1, time0, time1, radius, o, d, time, active,
                       t_min: float = 1.0e-3, mask=None, groups=()):
    """Plain-torch sweep; the fold is ``scan_all``'s: per tile of spheres,
    candidate t's against the running best as inclusive bound, the first
    in-tile minimum, and a strict < across tiles.  The partitioned form
    (``mask`` uint8 [N] with ``groups``, ``ops/partition.py``): the tiles
    are cut at the groups' bounds, and a tile of group i updates only the
    lanes whose mask has group i's bit."""
    n = o.shape[0]
    check_mask("sphere_sweep_plain", mask, groups, n)
    t_best = torch.where(active, BIG, -BIG).to(torch.float32)
    best = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    o_b, d_b, time_b = o[:, None, :], d[:, None, :], time[:, None]
    p = p0.shape[0]
    for a, b, group in (_segments(p, groups) if mask is not None
                        else [(0, p, -1)]):
        lanes = None
        if group >= 0:
            lanes = (mask & group_bit(len(groups), group)) != 0
        for start in range(a, b, PLAIN_TILE):
            sl = slice(start, min(start + PLAIN_TILE, b))
            pf = PrimFields(p0=p0[None, sl], p1=p1[None, sl],
                            radius=radius[None, sl],
                            time0=time0[None, sl], time1=time1[None, sl])
            # has_motion=True is exact for static spheres too: p1 - p0 == 0.
            t = sphere_t(pf, o_b, d_b, time_b, t_min, t_best[:, None],
                         has_motion=True)  # [N, tile]
            tt, j = torch.min(t, dim=1)  # first index of the minimum
            upd = tt < t_best
            if lanes is not None:
                upd = upd & lanes
            t_best = torch.where(upd, tt, t_best)
            best = torch.where(upd, (start + j).to(torch.int32), best)
    return torch.where(active, t_best, BIG), best


def _bind(lib):
    fn = lib.hrt_sphere_sweep
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, c_int, ptr, ptr, c_int, ptr, c_int,
                   ctypes.c_float, ptr, c_int, c_int, c_int, c_int, c_int,
                   ptr, ptr, ptr]
    fn.restype = c_int
    return fn


def sphere_sweep(p0, p1, time0, time1, radius, o, d, time, active,
                 t_min: float = 1.0e-3, mask=None, groups=()):
    """Closest sphere hit per ray.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (building it on first use) or
    raises.  ``mask`` / ``groups``: the partitioned form (see
    ``sphere_sweep_plain``); one without the other raises.  A launch is
    traced as ``K1`` (``cuda_build.launch``), one of the partitioned form
    also counted in ``K1.partitioned``."""
    device = o.device
    n, p = o.shape[0], p0.shape[0]
    check_mask("sphere_sweep", mask, groups, n)
    if groups and mask is None:
        raise ValueError("sphere_sweep: partition groups without a mask")
    if device.type == "cpu":
        return sphere_sweep_plain(p0, p1, time0, time1, radius, o, d, time,
                                  active, t_min, mask, groups)
    if device.type != "cuda":
        raise ValueError(f"sphere_sweep: unsupported device {device}")
    f32 = torch.float32
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("active", active, (n,), torch.bool),
            ("p0", p0, (p, 3), f32), ("p1", p1, (p, 3), f32),
            ("time0", time0, (p,), f32), ("time1", time1, (p,), f32),
            ("radius", radius, (p,), f32),
            *((("mask", mask, (n,), torch.uint8),) if mask is not None
              else ())):
        cuda_build.check_arg("sphere_sweep", name, x, shape, dtype, device)
    if p == 0:
        raise ValueError("sphere_sweep: no spheres")
    if n >= 2**31 // 3:
        raise ValueError(f"sphere_sweep: {n} rays exceed the kernel's "
                         "32-bit indexing")
    t_best = torch.empty(n, dtype=f32, device=device)
    best = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return t_best, best
    fn = _bind(cuda_build.load("sphere_sweep"))
    rec = device_sphere_records(p0, p1, time0, time1, radius)
    cuda_build.launch(
        "sphere_sweep", fn, device, o.data_ptr(), d.data_ptr(),
        time.data_ptr(), active.data_ptr(), n, rec.geo.data_ptr(),
        rec.aux.data_ptr(), p, rec.shutter.data_ptr(), int(rec.has_motion),
        float(t_min), None if mask is None else mask.data_ptr(),
        len(groups), *group_bounds(groups), t_best.data_ptr(),
        best.data_ptr(), tag="K1", lanes=n)
    if mask is not None:
        count("K1.partitioned")
    return t_best, best
