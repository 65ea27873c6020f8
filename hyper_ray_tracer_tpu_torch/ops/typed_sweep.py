"""The typed sweep: closest hit of every ray over every primitive type.

This is the trace step of every scene that is not sphere-only (rects,
solid boxes, media, transforms; the bench scene `final` among them).  Two
implementations of one contract:

* ``typed_sweep``: the wrapper of the hand-written Hopper kernel
  ``csrc/typed_sweep.cu``.  The JAX package traces these scenes with an
  XLA sweep, not a Pallas kernel; the kernel follows that sweep.  It is
  bound by FP32 issue per ray-primitive pair; it reads each primitive as
  packed 16-byte records (``typed_records``, built by ``sweep_scene``
  once per scene, and once per forward in a train step); the design
  note is at the top of the CUDA source.
* ``typed_sweep_plain``: the same function in plain torch.  CPU tensors
  take it; on the card it is only the reference the kernel is checked
  against.

Contract: the JAX package's planned ``scan_all``
(``hyper_ray_tracer_tpu/ops/bvh.py:273-400``) over the primitive
intersector (``ops/intersect.py:439-510``).  The primitives, in the
scene's canonical order, are cut into the tiles of a host-side plan
(``tile_plan``): each tile holds one primitive type (one plane axis for
rects) and at most ``SCAN_TILE`` primitives, with its motion and
transform flags.  For each tile in order, every ray computes the tile's
candidate t's with the best t it held at the tile's START as the
inclusive ``t_max``, takes the first in-tile minimum, and replaces its
best only with a strictly smaller t.  The stale bound matters for media:
a medium's free-flight hit compares against ``min(t_exit, t_max)``, so
its outcome depends on the bound.  Media draw their uniform from the
ray's bounce word salted with the primitive's ``stable_id``.

Rays: ``o``, ``d`` [N,3] and ``time`` [N] float32, ``active`` [N] bool,
``bits`` [N] int64 bounce words (values below 2**32).  Returns ``t_best``
[N] float32 and ``best`` [N] int32, (BIG, -1) for a miss or an inactive
ray.  The two implementations agree bit for bit.

The partitioned form (``mask``, the partitioned sweep of
``ops/partition.py``): the plan is cut at the bounds of the scene's
partition groups (``SweepScene.groups``, at most 2), each tile tagged
with its group, and each lane carries a uint8 mask whose bit G-1-i says
that it may meet group i.  A lane folds group i's tiles only when that
bit is set; every other tile it folds as before (tiles outside every
group, media with their tile-start bound, ties to the lowest index).
``mask=None`` is the plain sweep.  A mask on a scene without groups
raises.  Since a lane whose mask lacks a group's bit cannot hit that
group (``overlap_masks`` is conservative), the partitioned form returns
what the plain form does on every lane.

The bf16 form (``bf16=True``; ``RenderSettings.bf16_hits``, the JAX
package's ``make_scan_intersector(..., bf16=True)``,
``hyper_ray_tracer_tpu/ops/bvh.py:47-104, 254-366``): a plan tile of
static, untransformed spheres (``bf16_tile``) computes its candidate t's
in bfloat16 (``sphere_t_bf16``), takes the first minimum and replaces a
lane's float32 best only with a strictly smaller upcast value; every
other tile folds in float32 as before.  Winners near a tie or at a
silhouette may differ from the float32 sweep's; the renderer recomputes
the winner's t in float32.  ``bf16_engages`` says whether a scene has a
bf16 tile at all.

Tracing (``utils/profiling.py``): each launch of K1b runs in the span
``K1b`` and counts in ``K1b.launches`` and its rays in ``K1b.lanes``;
one of the partitioned form also in ``K1b.partitioned``, of the bf16
form in ``K1b.bf16``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.profiling import count, host_sync
from ..models.scene import (
    PT_BOX,
    PT_MEDIUM_BOX,
    PT_MEDIUM_SPHERE,
    PT_NONE,
    PT_RECT,
    PT_SPHERE,
)
from .intersect import BIG, PrimFields, prim_hit_t
from .math import sqrt_rn
from .partition import check_mask, group_bit, group_bounds
from .sphere_sweep import sphere_records

SCAN_TILE = 512  # primitives per plan tile (the JAX package's tile width)
PLAIN_TILE = 128  # primitives per step of the plain version
# A plan row as the kernel reads it: 8 int32 (two int4 loads).
PLAN_COLUMNS = ("start", "width", "ptype", "motion", "xform", "rect_axis",
                "xf_offset", "group")


def _prim_flags(geom, n_prims: int):
    """Per primitive of the canonical order: (PT_* type, plane axis, has a
    ray transform, is a sphere that moves, the run key (type, transform,
    rect plane axis))."""
    pt = np.asarray(geom.ptype)[:n_prims]
    rot = np.asarray(geom.rot)[:n_prims]
    trans = np.asarray(geom.trans)[:n_prims]
    p0 = np.asarray(geom.p0)[:n_prims]
    p1 = np.asarray(geom.p1)[:n_prims]
    axis = np.asarray(geom.axis)[:n_prims]
    eye = np.eye(3, dtype=rot.dtype)
    has_xf = np.any(rot != eye, axis=(1, 2)) | np.any(trans != 0, axis=1)
    moving = (pt == PT_SPHERE) & np.any(p0 != p1, axis=-1)
    key = (pt.astype(np.int64) * 8 + has_xf * 4
           + np.where(pt == PT_RECT, axis, 0))
    return pt, axis, has_xf, moving, key


def type_runs(geom, n_prims: int):
    """The maximal runs of the canonical primitive order that share type,
    transform presence and (for rects) plane axis, with each run's flags:
    [(start, end, types, motion, xform, rect_axis)], ``motion`` and
    ``xform`` set when some primitive of the run moves or is transformed.
    The JAX package's ``ops/bvh.py:type_runs``, copied.  ``geom``: a
    GeometrySoA of NumPy arrays."""
    pt, axis, has_xf, moving, key = _prim_flags(geom, n_prims)
    bounds = [0] + (np.flatnonzero(key[1:] != key[:-1]) + 1).tolist() \
        + [n_prims]
    runs = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        types = frozenset(int(v) for v in np.unique(pt[a:b])) - {PT_NONE}
        rect_axis = None
        if types == {PT_RECT} and np.unique(axis[a:b]).size == 1:
            rect_axis = int(axis[a])
        runs.append((a, b, types, bool(moving[a:b].any()),
                     bool(has_xf[a:b].any()), rect_axis))
    return runs


def tile_plan(geom, n_prims: int, max_tile: int = SCAN_TILE, cuts=()):
    """The plan of the sweep: each of ``type_runs``' runs cut at the
    primitive indices ``cuts`` (the partition groups' bounds: a tile
    belongs to at most one group) and into tiles of at most ``max_tile``
    primitives, each tile with its own motion and transform flags.  The
    JAX package's ``ops/bvh.py:_tile_plan``, copied.  Returns [(start,
    width, types, motion, xform, rect_axis)] covering [0, n_prims).
    Unlike the JAX package, the port always follows the plan (it is
    data, not unrolled code), however many tiles it has."""
    _, _, has_xf, moving, _ = _prim_flags(geom, n_prims)
    plan = []
    for a, b, types, _, _, rect_axis in type_runs(geom, n_prims):
        bounds = sorted({a, b} | {c for c in cuts if a < c < b})
        for a2, b2 in zip(bounds[:-1], bounds[1:]):
            for s in range(a2, b2, max_tile):
                sl = slice(s, min(s + max_tile, b2))
                plan.append((s, sl.stop - s, types, bool(moving[sl].any()),
                             bool(has_xf[sl].any()), rect_axis))
    return plan


# The bf16 form's miss value, bf16(3.0e38) = 3.0045e38: above float32's
# BIG, so a tile a lane misses never updates it.
BF16_BIG = float(torch.tensor(3.0e38).to(torch.bfloat16).float())


def bf16_tile(tile) -> bool:
    """Whether a plan tile folds in bf16 under the bf16 form: static,
    untransformed spheres only (``hyper_ray_tracer_tpu/ops/bvh.py:254-256``;
    a rect's interval tests in bf16 were measured there to jitter edges)."""
    return tile.ptype == PT_SPHERE and not tile.motion and not tile.xform


def bf16_engages(sw) -> bool:
    """Whether the bf16 form changes anything on the SweepScene ``sw``:
    some plan tile is a ``bf16_tile`` (``ops/bvh.py:270``'s ``use_bf16``)."""
    return sw is not None and any(bf16_tile(t) for t in sw.plan)


def dot3_bf16(a, b):
    """The three-term dot of bfloat16 vectors ``a``, ``b`` [..., 3] as
    the JAX package's jitted XLA computes it: each product exact in
    float32 (8 + 8 bits), the sum left to right in float32, rounded to
    bfloat16 once."""
    ax, ay, az = a.float().unbind(-1)
    bx, by, bz = b.float().unbind(-1)
    return ((ax * bx + ay * by) + az * bz).to(torch.bfloat16)


def bf16_ray_terms(d):
    """The bf16 form's per-ray terms of directions ``d`` [..., 3]: (d16,
    a16 = d16.d16 (``dot3_bf16``), inv_a16 = 1 / a16, a float32 division,
    then rounded), bfloat16 tensors."""
    d16 = d.to(torch.bfloat16)
    a16 = dot3_bf16(d16, d16)
    return d16, a16, (1.0 / a16.float()).to(torch.bfloat16)


def sphere_t_bf16(center, rr16, o, d16, a16, inv_a16, t_min16, t_max16):
    """The bf16 candidate t of spheres (``center`` [..., 3] float32,
    ``rr16`` = bf16(bf16(r)^2)) against rays ``o`` (float32) with
    ``bf16_ray_terms`` (d16, a16, inv_a16), inclusive [t_min16, t_max16]
    (bfloat16): the JAX package's ``_sphere_bf16_core``
    (``ops/bvh.py:74-99``) as the JAX package's jitted sweep rounds it:
    ``oc = o - c`` in float32, then rounded; the three-term dots
    ``dot3_bf16`` (one rounding each); every other product, sum or
    difference one correctly rounded bf16 operation (torch computes it in
    float32 and rounds once, exact here: 24 >= 2 * 8 + 2 bits); the square
    root ``sqrt_rn`` in float32, then rounded.  ``BF16_BIG`` on a miss.
    Returns a bfloat16 tensor."""
    oc = (o - center).to(torch.bfloat16)
    half_b = dot3_bf16(oc, d16)
    c = dot3_bf16(oc, oc) - rr16
    disc = half_b * half_b - a16 * c
    sq = sqrt_rn(torch.clamp(disc.float(), min=0.0)).to(torch.bfloat16)
    t_near = (-half_b - sq) * inv_a16
    t_far = (-half_b + sq) * inv_a16
    exists = disc >= 0.0
    ok1 = exists & (t_near >= t_min16) & (t_near <= t_max16)
    ok2 = exists & (t_far >= t_min16) & (t_far <= t_max16)
    return torch.where(ok1, t_near, torch.where(ok2, t_far, BF16_BIG))


def bf16_radius_sq(radius):
    """bf16(bf16(r) * bf16(r)) per primitive as float32 (the bf16 form's
    squared radius; the same on every device)."""
    r16 = radius.to(torch.bfloat16)
    return (r16 * r16).float().contiguous()


def bf16_records(p0, radius):
    """The bf16 form's record per primitive, [P, 4] float32: its center
    ``p0`` and ``bf16_radius_sq(radius)``, the one 16-byte record the
    kernel stages for a sphere of a bf16 tile.  Built on the tensors'
    device."""
    return torch.cat([p0, bf16_radius_sq(radius)[:, None]], 1).contiguous()


class PlanTile(NamedTuple):
    start: int
    width: int
    ptype: int  # the tile's one PT_* type
    motion: bool
    xform: bool
    rect_axis: int  # plane tag of a rect tile, else -1
    group: int = -1  # the partition group the tile belongs to, else -1


class SweepScene(NamedTuple):
    """The typed sweep's view of a scene on one device."""

    plan: tuple  # PlanTile per tile, host side
    plan_rows: torch.Tensor  # [T, 8] int32, PLAN_COLUMNS per tile
    prims: PrimFields  # [P] fields of the first n_prims primitives (plain)
    geo: torch.Tensor  # [P, 4] float32 records (typed_records)
    aux: torch.Tensor  # [P, 4] float32
    xf: torch.Tensor  # [X, 12] float32, the transformed tiles' primitives
    shutter: torch.Tensor  # [S, 2] float32 (time0, time1 - time0) per slot
    # The partition groups (ops/partition.PartGroup) whose bounds cut the
    # plan; the tiles of group i carry group = i.
    groups: tuple = ()
    # [P, 4] float32, (p0, bf16(bf16(r)^2)) per primitive: the bf16 form's
    # records (bf16_records).
    geo16: Optional[torch.Tensor] = None


def prim_records(geom_np, n_prims: int, lerp):
    """The packed per-type records of the first ``n_prims`` primitives of
    the NumPy geometry ``geom_np`` (layout: csrc/typed_sweep.cu; a rect's
    aux also carries its plane tag, which K4 reads and K1b does not).
    Returns (geo [P, 4], aux [P, 4], shutter [S, 2] float32).  Spheres
    are packed by ``sphere_records``, lerped where ``lerp`` [P] is set."""
    g = geom_np
    n = n_prims
    pt = np.asarray(g.ptype)[:n]
    p0 = np.asarray(g.p0, np.float32)[:n]
    p1 = np.asarray(g.p1, np.float32)[:n]
    nid = np.asarray(g.neg_inv_density, np.float32)[:n]
    sid = np.asarray(g.stable_id).astype(np.int32)[:n].view(np.float32)
    axis = np.asarray(g.axis).astype(np.int32)[:n].view(np.float32)
    zero = np.zeros(n, np.float32)
    sph = sphere_records(p0, p1, np.asarray(g.time0)[:n],
                         np.asarray(g.time1)[:n], np.asarray(g.radius)[:n],
                         lerp)
    col = np.stack
    by_type = {
        PT_SPHERE: (sph.geo, sph.aux),
        PT_MEDIUM_SPHERE: (sph.geo, col([nid, sid, zero, zero], 1)),
        PT_RECT: (col([p0[:, 0], p0[:, 1], p0[:, 2], p1[:, 0]], 1),
                  col([p1[:, 1], axis, zero, zero], 1)),
        PT_BOX: (np.concatenate([p0, zero[:, None]], 1),
                 np.concatenate([p1, zero[:, None]], 1)),
        PT_MEDIUM_BOX: (np.concatenate([p0, nid[:, None]], 1),
                        np.concatenate([p1, sid[:, None]], 1)),
    }
    geo = np.zeros((n, 4), np.float32)
    aux = np.zeros((n, 4), np.float32)
    for ptype, (g_rec, a_rec) in by_type.items():
        sel = pt == ptype
        geo[sel] = g_rec[sel]
        aux[sel] = a_rec[sel]
    return geo, aux, sph.shutter


def typed_records(geom_np, plan, n_prims: int):
    """The kernel's packed records of the first ``n_prims`` primitives of
    the NumPy geometry ``geom_np`` (layout: csrc/typed_sweep.cu).  Returns
    (plan rows [T, 8] int32, geo [P, 4], aux [P, 4], xf [X, 12], shutter
    [S, 2] float32).  Spheres are lerped only in the plan's motion tiles,
    as ``prim_hit_t`` lerps them; ``xf`` holds R row-major and t of every
    primitive of a transformed tile, tile by tile (one zero row when
    there is none)."""
    g = geom_np
    n = n_prims
    lerp = np.zeros(n, bool)
    for t in plan:
        lerp[t.start:t.start + t.width] = t.ptype == PT_SPHERE and t.motion
    geo, aux, shutter = prim_records(g, n, lerp)
    xform = np.concatenate([np.asarray(g.rot, np.float32)[:n].reshape(n, 9),
                            np.asarray(g.trans, np.float32)[:n]], 1)
    rows, xf = [], []
    n_xf = 0
    for t in plan:
        rows.append([t.start, t.width, t.ptype, int(t.motion), int(t.xform),
                     t.rect_axis, n_xf if t.xform else 0, t.group])
        if t.xform:
            xf.append(xform[t.start:t.start + t.width])
            n_xf += t.width
    xf = np.concatenate(xf) if xf else np.zeros((1, 12), np.float32)
    return (np.asarray(rows, np.int32), geo, aux,
            np.ascontiguousarray(xf, np.float32), shutter)


def sweep_plan(geom_np, n_prims: int, groups=()) -> tuple:
    """The plan of ``tile_plan`` as PlanTiles (every tile of one type),
    cut at the bounds of the partition groups ``groups`` and each tile
    tagged with the group it lies in."""
    cuts = tuple(c for g in groups for c in (g.start, g.end))
    plan = []
    for s, w, types, motion, xform, rect_axis in tile_plan(
            geom_np, n_prims, cuts=cuts):
        if len(types) != 1:
            raise ValueError(f"plan tile at {s} holds types {set(types)}")
        group = next((i for i, g in enumerate(groups)
                      if g.start <= s < g.end), -1)
        plan.append(PlanTile(s, w, next(iter(types)), motion, xform,
                             -1 if rect_axis is None else rect_axis, group))
    return tuple(plan)


def sweep_scene(geom_np, geom, n_prims: int, plan=None,
                groups=()) -> SweepScene:
    """Build the kernel's records from the NumPy geometry ``geom_np`` and
    slice the device tensors ``geom`` (the same GeometrySoA as tensors).
    ``plan``: the PlanTiles to follow, by default ``sweep_plan`` of
    ``geom_np`` cut at the partition groups ``groups``; a train step
    passes the plan of the scene as built, so that each tile keeps its
    motion and transform flags while the geometry moves."""
    if plan is None:
        plan = sweep_plan(geom_np, n_prims, groups)
    device = geom.p0.device
    rows, geo, aux, xf, shutter = (
        host_sync(torch.from_numpy(x).to(device))
        for x in typed_records(geom_np, plan, n_prims))
    prims = PrimFields(
        p0=geom.p0[:n_prims], p1=geom.p1[:n_prims],
        radius=geom.radius[:n_prims], time0=geom.time0[:n_prims],
        time1=geom.time1[:n_prims], ptype=geom.ptype[:n_prims],
        stable_id=geom.stable_id[:n_prims], axis=geom.axis[:n_prims],
        neg_inv_density=geom.neg_inv_density[:n_prims],
        rot=geom.rot[:n_prims], trans=geom.trans[:n_prims])
    prims = PrimFields(*(x.contiguous() for x in prims))
    return SweepScene(plan=tuple(plan), plan_rows=rows, prims=prims,
                      geo=geo, aux=aux, xf=xf, shutter=shutter,
                      groups=tuple(groups),
                      geo16=bf16_records(prims.p0.detach(),
                                         prims.radius.detach()))


def typed_sweep_plain(sw: SweepScene, o, d, time, active, bits,
                      t_min: float = 1.0e-3, mask=None, bf16: bool = False):
    """Plain-torch typed sweep: ``scan_all``'s fold over the plan tiles,
    each tile in steps of ``PLAIN_TILE`` primitives so memory stays
    bounded (the steps of one tile share its start bound).  ``mask``
    (uint8 [N], ``ops/partition.group_mask``): a tile of group i updates
    only the lanes whose mask has group i's bit.  ``bf16``: the bf16
    form, the ``bf16_tile`` tiles through ``sphere_t_bf16`` with the
    tile-start best rounded to bf16 as their t_max (a step's first
    minimum, upcast, against the running best: the same winner as the
    JAX package's per-tile argmin)."""
    n = o.shape[0]
    check_mask("typed_sweep_plain", mask, sw.groups, n)
    t_best = torch.where(active, BIG, -BIG).to(torch.float32)
    best = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    o_b, d_b, time_b, bits_b = o[:, None], d[:, None], time[:, None], \
        bits[:, None]
    if bf16:
        d16, a16, inv_a16 = bf16_ray_terms(d[:, None])
        t_min16 = float(torch.tensor(t_min).to(torch.bfloat16))
        rr16 = sw.geo16[:, 3].to(torch.bfloat16)
    for tile in sw.plan:
        bound = t_best[:, None]  # the tile's stale t_max
        low = bf16 and bf16_tile(tile)
        if low:
            bound = bound.to(torch.bfloat16)
        end = tile.start + tile.width
        lanes = None
        if mask is not None and tile.group >= 0:
            lanes = (mask & group_bit(len(sw.groups), tile.group)) != 0
        for s in range(tile.start, end, PLAIN_TILE):
            sl = slice(s, min(s + PLAIN_TILE, end))
            pf = PrimFields(*(x[None, sl] for x in sw.prims))
            if low:
                t = sphere_t_bf16(pf.p0, rr16[None, sl], o_b, d16, a16,
                                  inv_a16, t_min16, bound).float()
            else:
                t = prim_hit_t(tile.ptype, pf, o_b, d_b, time_b, t_min,
                               bound, bits_b, has_motion=tile.motion,
                               has_xform=tile.xform,
                               rect_axis=None if tile.rect_axis < 0
                               else tile.rect_axis)
            tt, j = torch.min(t, dim=1)  # first index of the minimum
            upd = tt < t_best
            if lanes is not None:
                upd = upd & lanes
            t_best = torch.where(upd, tt, t_best)
            best = torch.where(upd, (s + j).to(torch.int32), best)
    return torch.where(active, t_best, BIG), best


def bf16_sqrt_plain(x):
    """bf16(sqrt_rn(max(x, 0))) as float32, the bf16 form's square root of
    a discriminant ``x`` (float32 [N]), as ``sphere_t_bf16`` takes it."""
    return sqrt_rn(torch.clamp(x, min=0.0)).to(torch.bfloat16).float()


def bf16_sqrt(x):
    """The bf16 form's square root as its kernel computes it: MUFU's
    approximate root of a float32 [N] ``x`` on the card, rounded to bf16
    (``csrc/typed_sweep.cu`` sqrt_of_bf16), where a CUDA tensor launches
    ``hrt_bf16_sqrt``; ``bf16_sqrt_plain`` on the CPU.  The kernel relies
    on the two agreeing on every non-negative bf16 value, +0 to +inf,
    which the card tests and ``chip_smoke.py`` check on all 32,641."""
    if x.device.type == "cpu":
        return bf16_sqrt_plain(x)
    n = x.shape[0]
    cuda_build.check_arg("bf16_sqrt", "x", x, (n,), torch.float32, x.device)
    out = torch.empty_like(x)
    if n:
        fn = cuda_build.load("typed_sweep").hrt_bf16_sqrt
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cuda_build.launch("bf16_sqrt", fn, x.device, x.data_ptr(),
                          out.data_ptr(), n, tag="bf16_sqrt", lanes=n)
    return out


def _bind(lib):
    fn = lib.hrt_typed_sweep
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 5 + [c_int] + [ptr] * 4 + [c_int, c_int, ptr]
                   + [c_int, ctypes.c_float, ptr, c_int] + [c_int] * 4
                   + [ptr, ptr, ptr, ptr])
    fn.restype = c_int
    return fn


def typed_sweep(sw: SweepScene, o, d, time, active, bits,
                t_min: float = 1.0e-3, mask=None, bf16: bool = False):
    """Closest hit per ray over every primitive type.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (building it on
    first use) or raises.  ``mask``: the partitioned form (see
    ``typed_sweep_plain``), which needs a scene whose plan has groups.
    ``bf16``: the bf16 form (the module's notes).  A launch is traced as
    ``K1b`` (``cuda_build.launch``), one of the partitioned form also
    counted in ``K1b.partitioned`` and one of the bf16 form in
    ``K1b.bf16``."""
    device = o.device
    n = o.shape[0]
    check_mask("typed_sweep", mask, sw.groups, n)
    if device.type == "cpu":
        return typed_sweep_plain(sw, o, d, time, active, bits, t_min, mask,
                                 bf16)
    if device.type != "cuda":
        raise ValueError(f"typed_sweep: unsupported device {device}")
    p, f32, i32 = sw.geo.shape[0], torch.float32, torch.int32
    n_xf = sw.xf.shape[0]
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("active", active, (n,), torch.bool),
            ("bits", bits, (n,), torch.int64),
            ("geo", sw.geo, (p, 4), f32), ("aux", sw.aux, (p, 4), f32),
            ("xf", sw.xf, (n_xf, 12), f32),
            ("plan_rows", sw.plan_rows, (len(sw.plan), len(PLAN_COLUMNS)),
             i32),
            ("shutter", sw.shutter, (sw.shutter.shape[0], 2), f32),
            *((("mask", mask, (n,), torch.uint8),) if mask is not None
              else ()),
            *((("geo16", sw.geo16, (p, 4), f32),) if bf16 else ())):
        cuda_build.check_arg("typed_sweep", name, x, shape, dtype, device)
    if p == 0 or not sw.plan:
        raise ValueError("typed_sweep: no primitives")
    if n >= 2**31 // 3:
        raise ValueError(f"typed_sweep: {n} rays exceed the kernel's "
                         "32-bit indexing")
    t_best = torch.empty(n, dtype=f32, device=device)
    best = torch.empty(n, dtype=i32, device=device)
    if n == 0:
        return t_best, best
    fn = _bind(cuda_build.load("typed_sweep"))
    has_xf = any(t.xform for t in sw.plan)
    groups = sw.groups if mask is not None else ()
    cuda_build.launch(
        "typed_sweep", fn, device, o.data_ptr(), d.data_ptr(),
        time.data_ptr(), active.data_ptr(), bits.data_ptr(), n,
        sw.geo.data_ptr(), sw.aux.data_ptr(), sw.xf.data_ptr(),
        sw.plan_rows.data_ptr(), len(sw.plan), p, sw.shutter.data_ptr(),
        int(has_xf), float(t_min),
        None if mask is None else mask.data_ptr(), len(groups),
        *group_bounds(groups), sw.geo16.data_ptr() if bf16 else None,
        t_best.data_ptr(), best.data_ptr(), tag="K1b", lanes=n)
    if mask is not None:
        count("K1b.partitioned")
    if bf16:
        count("K1b.bf16")
    return t_best, best
