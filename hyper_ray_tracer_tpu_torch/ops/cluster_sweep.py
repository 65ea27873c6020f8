"""Cluster mode's trace step: the closest hit of every ray over the
geometry in the padded cluster order of ``models/clusters.py``.

Named after the JAX module it ports (``hyper_ray_tracer_tpu/ops/
cluster_sweep.py``, ``make_cluster_intersector`` and
``make_coherence_key``).  Two implementations of one contract:

* ``cluster_sweep``: the wrapper of the hand-written Hopper kernel K5,
  ``csrc/cluster_sweep.cu`` (a warp a ray; the design note and the
  contract are at the top of the CUDA source).  It reads the layout as
  tail groups, run rows and cluster boxes, and the padded geometry as the
  packed, type-tagged records K4 also reads (``cluster_scene``).
* ``cluster_sweep_plain``: the same function in plain torch, vectorised
  over lanes: per window, every lane's entries sorted, then one step a
  position of that order.  CPU tensors take it; on the card it is only
  the reference the kernel is checked against.

Contract, per active ray (per-ray nearest first):
1. the tail first, group by group, slot by slot;
2. then each run in layout order, in windows of ``WINDOW`` clusters in
   layout order.  In a window, every cluster whose box the slab test
   admits geometrically (slab distances ``(b - o) * (1 / d)``, ``hi >
   max(lo, t_min)``, a NaN distance missing) is visited in ascending
   ``(lo, cluster index)`` order (a stable sort of the entries ``lo``);
   a cluster whose ``lo`` exceeds the running best at its turn ends the
   window for that ray, since the entries ascend;
3. each slot is tested with the running best as the inclusive ``t_max``,
   and wins with a smaller t, or an equal t and a lower slot index (K4's
   rule; the JAX package folds with a strict ``<`` in its per-tile
   nearest-first order).  A medium's slots are tested one by one with the
   running best; any other type's slots may be tested at once with the
   bound at the cluster's start, which gives the same result.
The primitive tests are the typed sweep's with each tail group's or run's
flags (``ops/intersect.py prim_hit_t``).  Every run is one level: the JAX
package's super boxes (``SUPER_MIN_CLUSTERS``) are unions of their
members' boxes, so testing them first culls nothing the members would
admit.

Rays: ``o``, ``d`` [N,3] and ``time`` [N] float32, ``active`` [N] bool,
``bits`` [N] int64 bounce words (values below 2**32).  Returns ``t_best``
[N] float32 and ``best`` [N] int32, slots of the padded geometry, (BIG,
-1) for a miss or an inactive ray.  The kernel and ``cluster_sweep_plain``
agree bit for bit.

``make_coherence_key`` is the JAX package's default ``octant-cell`` key,
in integer tensors: a render in cluster mode orders each compaction's
survivors by it.

Tracing (``utils/profiling.py``): each launch of K5 runs in the span
``K5`` and counts in ``K5.launches`` and its rays in ``K5.lanes``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.clusters import ClusterLayout
from ..models.scene import (
    PT_BOX,
    PT_MEDIUM_BOX,
    PT_MEDIUM_SPHERE,
    PT_NONE,
    PT_RECT,
    PT_SPHERE,
)
from ..utils import cuda_build
from ..utils.profiling import host_sync
from .intersect import BIG, PrimFields, prim_hit_t
from .typed_sweep import prim_records

# A run is tested super box first from this many clusters in the JAX
# package; here it only picks the coherence key's leading field.
SUPER_MIN_CLUSTERS = 512
CELL_BITS = 4  # Morton bits per axis of the coherence key
# Clusters a ray orders at once: a run is taken in windows of this many
# clusters in layout order, each window nearest first.  K5's kWindow must
# equal it; the wrapper raises when it does not.
WINDOW = 256
# Ray-slot pairs a step of the plain version holds at most, and
# ray-cluster entries a block of its lanes sorts at once, by device.
PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 24}
PLAIN_ENTRIES = {"cpu": 1 << 22, "cuda": 1 << 26}
MEDIA = (PT_MEDIUM_SPHERE, PT_MEDIUM_BOX)
# The PrimFields a test of each type reads (ops/intersect.py prim_hit_t),
# besides time0 / time1 with motion and rot / trans with a transform.
READS = {PT_SPHERE: ("p0", "radius"), PT_RECT: ("p0", "p1", "axis"),
         PT_BOX: ("p0", "p1"),
         PT_MEDIUM_SPHERE: ("p0", "radius", "neg_inv_density", "stable_id"),
         PT_MEDIUM_BOX: ("p0", "p1", "neg_inv_density", "stable_id")}


class Group(NamedTuple):
    """Slots the contract tests together, with the flags of their tests:
    a tail group, or one cluster of a run."""

    start: int
    width: int
    ptype: int
    motion: bool
    xform: bool
    rect_axis: Optional[int]


class ClusterScene(NamedTuple):
    """Cluster mode's view of a scene on one device."""

    layout: ClusterLayout  # host side
    tail: tuple  # Group per tail group
    runs: tuple  # Group per run, its start and width those of cluster 0
    tail_rows: torch.Tensor  # [T, 4] int32: start, width, xform, medium
    run_rows: torch.Tensor  # [R, 8] int32: base, clusters, width, xform,
    # first box row, type, motion, 0
    boxes: torch.Tensor  # [C, 8] float32: cmin, 0, cmax, 0 per cluster
    prims: PrimFields  # [S] every field of the padded geometry (plain)
    geo: torch.Tensor  # [S, 4] float32 (ops/typed_sweep.prim_records)
    aux: torch.Tensor  # [S, 4] float32
    tag: torch.Tensor  # [S] int32, the PT_* type (PT_NONE on a pad)
    xf: torch.Tensor  # [S, 12] float32 (R row-major, t), [1, 12] without
    shutter: torch.Tensor  # [K, 2] float32 (time0, time1 - time0)
    key: Optional[Callable]  # make_coherence_key's, None without runs


def _groups(layout: ClusterLayout):
    tail = tuple(Group(s, w, next(iter(t)), m, x, ra)
                 for s, w, t, m, x, ra in layout.tail)
    runs = tuple(Group(r.base, r.width, next(iter(r.types)), r.has_motion,
                       r.has_xform, r.rect_axis) for r in layout.runs)
    return tail, runs


def cluster_scene(layout: ClusterLayout, geom_np, geom) -> ClusterScene:
    """Cluster mode's scene from the layout and the padded NumPy geometry
    ``geom_np`` (``models/clusters.build_clusters``), with ``geom`` the
    same geometry as tensors on the target device."""
    device = geom.p0.device
    tail, runs = _groups(layout)
    tail_rows = np.zeros((len(tail), 4), np.int32)
    for k, g in enumerate(tail):
        tail_rows[k] = g.start, g.width, g.xform, g.ptype in MEDIA
    run_rows = np.zeros((len(runs), 8), np.int32)
    boxes = np.zeros((sum(r.n_clusters for r in layout.runs), 8),
                     np.float32)
    first = 0
    for k, r in enumerate(layout.runs):
        run_rows[k, :7] = (r.base, r.n_clusters, r.width, r.has_xform,
                           first, runs[k].ptype, r.has_motion)
        boxes[first:first + r.n_clusters, 0:3] = r.cmin
        boxes[first:first + r.n_clusters, 4:7] = r.cmax
        first += r.n_clusters
    if layout.n_slots >= 2**31 or boxes.shape[0] >= 2**30:
        raise ValueError("cluster_scene: the layout exceeds K5's 32-bit "
                         "indexing")

    def dev(x):
        return host_sync(torch.from_numpy(np.ascontiguousarray(x))
                         .to(device))

    scene = ClusterScene(
        layout=layout, tail=tail, runs=runs, tail_rows=dev(tail_rows),
        run_rows=dev(run_rows), boxes=dev(boxes), prims=None, geo=None,
        aux=None, tag=None, xf=None, shutter=None,
        key=make_coherence_key(layout, device=device) if layout.runs
        else None)
    return cluster_records(scene, geom_np, geom)


def cluster_records(scene: ClusterScene, geom_np, geom) -> ClusterScene:
    """``scene`` with its slots' records (``prims`` and K5's ``geo``,
    ``aux``, ``tag``, ``xf``, ``shutter``) taken from the padded geometry
    ``geom_np`` (NumPy) and ``geom`` (the same as tensors).  The layout
    and its boxes stay as they are: a train step moves the primitives,
    not the boxes, as the JAX package's boxes are constants of its
    trace."""
    device = geom.p0.device
    n = scene.layout.n_slots
    pt = np.asarray(geom_np.ptype)
    lerp = np.zeros(n, bool)
    xform = np.zeros(n, bool)
    for g in scene.tail:
        lerp[g.start:g.start + g.width] = g.motion
        xform[g.start:g.start + g.width] = g.xform
    for g, r in zip(scene.runs, scene.layout.runs):
        span = slice(r.base, r.base + r.n_clusters * r.width)
        lerp[span] = g.motion
        xform[span] = g.xform
    # The plain version lerps every sphere of a motion group.
    geo, aux, shutter = prim_records(geom_np, n, lerp & (pt == PT_SPHERE))
    geo[pt == PT_NONE] = np.nan  # a pad misses K5's still-sphere test
    if xform.any():
        xf = np.concatenate(
            [np.asarray(geom_np.rot, np.float32).reshape(n, 9),
             np.asarray(geom_np.trans, np.float32)], 1)
    else:
        xf = np.zeros((1, 12), np.float32)

    def dev(x, dtype=None):
        return host_sync(torch.from_numpy(np.ascontiguousarray(x, dtype))
                         .to(device))

    prims = PrimFields(
        p0=geom.p0, p1=geom.p1, radius=geom.radius, time0=geom.time0,
        time1=geom.time1, ptype=geom.ptype, stable_id=geom.stable_id,
        axis=geom.axis, neg_inv_density=geom.neg_inv_density, rot=geom.rot,
        trans=geom.trans)
    return scene._replace(prims=PrimFields(*(x.contiguous() for x in prims)),
                          geo=dev(geo), aux=dev(aux), tag=dev(pt, np.int32),
                          xf=dev(xf), shutter=dev(shutter))


def _fields(cs: ClusterScene, g: Group, pick):
    """The PrimFields a test of g's type and flags reads, each ``pick``ed
    from the padded geometry's field; None for the others."""
    need = set(READS[g.ptype])
    if g.motion:
        need |= {"p1", "time0", "time1"}
    if g.xform:
        need |= {"rot", "trans"}
    return PrimFields(*(pick(x) if k in need else None
                        for k, x in zip(PrimFields._fields, cs.prims)))


def _fold(cs: ClusterScene, g: Group, lanes, o, d, time, bits, t_min,
          t_best, best, starts=None):
    """Test g.width slots for the lanes ``lanes`` (indices into the
    compacted rays) and fold them into (t_best, best): slots g.start ..
    g.start + g.width - 1 for every lane, or with ``starts`` ([lanes]
    int64, one cluster of g's run a lane) starts[i] .. starts[i] +
    g.width - 1 for lane i.  A medium's free flight depends on its bound,
    so a medium is tested slot by slot with the running best; any other
    type's hit does not (a t beyond the bound comes back BIG either way),
    so its slots are tested at once with the bound at the start, and the
    smallest (t, slot) wins: the same result as slot by slot."""
    w = 1 if g.ptype in MEDIA else g.width
    step = max(1, PLAIN_PAIRS.get(o.device.type, 1 << 22) // w)
    span = torch.arange(w, device=o.device)
    for j0 in range(0, g.width, w):
        for c in range(0, lanes.numel(), step):
            sel = lanes[c:c + step]
            if starts is None:
                first = g.start + j0
                pf = _fields(cs, g, lambda x: x[None, first:first + w])
            else:
                first = starts[c:c + step] + j0
                idx = first[:, None] + span
                pf = _fields(cs, g, lambda x: x[idx])
            bound = t_best[sel]
            t = prim_hit_t(g.ptype, pf, o[sel, None], d[sel, None],
                           time[sel, None], t_min, bound[:, None],
                           bits[sel, None], has_motion=g.motion,
                           has_xform=g.xform, rect_axis=g.rect_axis)
            tt, j = torch.min(t, dim=1)  # first index of the minimum
            slot = (first + j).to(torch.int32)
            b = best[sel]
            upd = (tt < bound) | ((tt == bound) & (slot < b))
            t_best[sel] = torch.where(upd, tt, bound)
            best[sel] = torch.where(upd, slot, b)


def _window(cs: ClusterScene, g: Group, base: int, boxes, args, inv_d,
            stats):
    """One window of a run: the clusters of ``boxes`` ([m, 8], the rows
    of the window's clusters, the first at slot ``base``), each lane's
    admitted clusters visited in ascending (entry, cluster) order while
    the entry is at or below the lane's running best."""
    o, t_best = args[0], args[5]
    n, m = o.shape[0], boxes.shape[0]
    block = max(1, PLAIN_ENTRIES.get(o.device.type, 1 << 22) // m)
    for b0 in range(0, n, block):
        lane = torch.arange(b0, min(n, b0 + block), device=o.device)
        t0 = (boxes[:, 0:3] - o[lane, None]) * inv_d[lane, None]
        t1 = (boxes[:, 4:7] - o[lane, None]) * inv_d[lane, None]
        lo = torch.minimum(t0, t1).amax(-1)
        hi = torch.maximum(t0, t1).amin(-1)
        # Not admitted (a NaN distance among them): +inf, after every
        # admitted entry; + 0.0 makes a -0.0 entry 0.0, so the two tie.
        entry = torch.where(hi > torch.clamp(lo, min=args[4]), lo + 0.0,
                            float("inf"))
        entry, order = torch.sort(entry, dim=1, stable=True)
        del t0, t1, lo, hi
        live = torch.arange(lane.numel(), device=o.device)
        if stats is not None:
            stats["box_tests"] += lane.numel() * m
        for k in range(m):
            live = live[entry[live, k] <= t_best[lane[live]]]
            if not live.numel():
                break
            c = order[live, k]
            _fold(cs, g, lane[live], *args, starts=base + c * g.width)
            if stats is not None:
                stats["cluster_visits"] += live.numel()
                stats["prim_tests"][base:base + m * g.width].view(
                    m, g.width).add_(torch.bincount(c, minlength=m)[:, None])


def cluster_sweep_plain(cs: ClusterScene, o, d, time, active, bits,
                        t_min: float = 1.0e-3, stats=None):
    """Plain-torch cluster sweep of the contract above.  ``stats``: a dict
    that gets the work these rays need: ``box_tests`` and
    ``cluster_visits`` (ints) and ``prim_tests`` ([S] int64, the tests of
    each slot, pads included)."""
    n = o.shape[0]
    dev = o.device
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lane = active.nonzero().squeeze(1)
    o, d, time, bits = (x[lane] for x in (o, d, time, bits))
    m = lane.numel()
    t_best = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    best = torch.full((m,), -1, dtype=torch.int32, device=dev)
    if stats is not None:
        stats.update(box_tests=0, cluster_visits=0, prim_tests=torch.zeros(
            cs.layout.n_slots, dtype=torch.int64, device=dev))
    args = (o, d, time, bits, t_min, t_best, best)
    every = torch.arange(m, device=dev)
    for g in cs.tail:
        _fold(cs, g, every, *args)
        if stats is not None:
            stats["prim_tests"][g.start:g.start + g.width] += m
    inv_d = 1.0 / d
    row = 0
    for g, r in zip(cs.runs, cs.layout.runs):
        for c0 in range(0, r.n_clusters, WINDOW):
            k = min(WINDOW, r.n_clusters - c0)
            _window(cs, g, r.base + c0 * r.width,
                    cs.boxes[row + c0:row + c0 + k], args, inv_d, stats)
        row += r.n_clusters
    t_out[lane] = t_best
    best_out[lane] = best
    return t_out, best_out


def cut_run(cs: ClusterScene, n_clusters: int) -> ClusterScene:
    """The ClusterScene ``cs`` (one run, no tail) with its run cut to its
    first ``n_clusters`` clusters: the slots past them are never read."""
    r = cs.layout.runs[0]
    rows = cs.run_rows.clone()
    rows[0, 1] = n_clusters
    run = r._replace(n_clusters=n_clusters, cmin=r.cmin[:n_clusters],
                     cmax=r.cmax[:n_clusters])
    return cs._replace(layout=cs.layout._replace(runs=(run,)), run_rows=rows,
                       boxes=cs.boxes[:n_clusters])


def make_coherence_key(layout: ClusterLayout, cell_bits: int = CELL_BITS,
                       device="cpu"):
    """key(o, d) -> [N] int64 (values below 2**32): the JAX package's
    ``make_coherence_key(layout)`` (its default ``octant-cell`` scheme),
    equal bit for bit.  The key joins the origin's Morton cell (cell
    bounds from the clusters whose diagonal is within 8x the median, so
    that one outlier such as a ground sphere does not stretch the grid)
    and the direction's octant; the octant leads unless a run has
    ``SUPER_MIN_CLUSTERS`` clusters or more.  A render orders each
    compaction's survivors by it (a pure permutation)."""
    octant_leads = not any(r.n_clusters >= SUPER_MIN_CLUSTERS
                           for r in layout.runs)
    allmin = np.concatenate([r.cmin for r in layout.runs])
    allmax = np.concatenate([r.cmax for r in layout.runs])
    diag = np.linalg.norm(allmax - allmin, axis=-1)
    keep = diag <= 8.0 * max(float(np.median(diag)), 1e-20)
    if not keep.any():
        keep = np.ones_like(keep)
    bmin = allmin[keep].min(0)
    bmax = allmax[keep].max(0)
    n_cells = 1 << cell_bits
    scale = host_sync(torch.from_numpy(np.float32(
        (n_cells - 1e-3) / np.maximum(bmax - bmin, 1e-20))).to(device))
    bmin = host_sync(torch.from_numpy(np.float32(bmin)).to(device))

    def key(o, d):
        q = torch.clamp((o - bmin) * scale, 0.0,
                        float(n_cells - 1)).to(torch.int64)
        m = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
        for b in range(cell_bits):
            m = m | (((q[..., 0] >> b) & 1) << (3 * b + 2)) \
                | (((q[..., 1] >> b) & 1) << (3 * b + 1)) \
                | (((q[..., 2] >> b) & 1) << (3 * b))
        oc = ((d[..., 0] < 0.0).to(torch.int64) * 4
              + (d[..., 1] < 0.0).to(torch.int64) * 2
              + (d[..., 2] < 0.0).to(torch.int64))
        if octant_leads:
            return (oc << (3 * cell_bits)) | m
        return (m << 3) | oc

    return key


def _bind(lib):
    window = lib.hrt_cluster_sweep_window()
    if window != WINDOW:
        raise RuntimeError(f"cluster_sweep: the kernel's window is {window} "
                           f"clusters, the plain version's WINDOW {WINDOW}")
    fn = lib.hrt_cluster_sweep
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 5 + [c_int, ptr, c_int, ptr, c_int] + [ptr] * 6
                   + [ctypes.c_float, ptr, ptr, ptr])
    fn.restype = c_int
    return fn


def cluster_sweep(cs: ClusterScene, o, d, time, active, bits,
                  t_min: float = 1.0e-3):
    """Closest hit per ray over the cluster layout.  A CPU tensor takes the
    plain version; a CUDA tensor launches K5 (building it on first use)
    or raises.  A launch is traced as ``K5`` (``cuda_build.launch``)."""
    device = o.device
    if device.type == "cpu":
        return cluster_sweep_plain(cs, o, d, time, active, bits, t_min)
    if device.type != "cuda":
        raise ValueError(f"cluster_sweep: unsupported device {device}")
    n, f32, i32 = o.shape[0], torch.float32, torch.int32
    p = cs.layout.n_slots
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("active", active, (n,), torch.bool),
            ("bits", bits, (n,), torch.int64),
            ("tail_rows", cs.tail_rows, (len(cs.tail), 4), i32),
            ("run_rows", cs.run_rows, (len(cs.runs), 8), i32),
            ("boxes", cs.boxes, (cs.boxes.shape[0], 8), f32),
            ("geo", cs.geo, (p, 4), f32), ("aux", cs.aux, (p, 4), f32),
            ("tag", cs.tag, (p,), i32),
            ("xf", cs.xf, (cs.xf.shape[0], 12), f32),
            ("shutter", cs.shutter, (cs.shutter.shape[0], 2), f32)):
        cuda_build.check_arg("cluster_sweep", name, x, shape, dtype, device)
    if cs.xf.shape[0] not in (1, p):
        raise ValueError("cluster_sweep: xf holds neither one row nor one "
                         "a slot")
    if n >= 2**31 // 3:
        raise ValueError(f"cluster_sweep: {n} rays exceed the kernel's "
                         "32-bit indexing")
    t_best = torch.empty(n, dtype=f32, device=device)
    best = torch.empty(n, dtype=i32, device=device)
    if n == 0:
        return t_best, best
    fn = _bind(cuda_build.load("cluster_sweep"))
    cuda_build.launch(
        "cluster_sweep", fn, device, o.data_ptr(), d.data_ptr(),
        time.data_ptr(), active.data_ptr(), bits.data_ptr(), n,
        cs.tail_rows.data_ptr(), len(cs.tail), cs.run_rows.data_ptr(),
        len(cs.runs), cs.boxes.data_ptr(), cs.geo.data_ptr(),
        cs.aux.data_ptr(), cs.tag.data_ptr(), cs.xf.data_ptr(),
        cs.shutter.data_ptr(), float(t_min), t_best.data_ptr(),
        best.data_ptr(), tag="K5", lanes=n)
    return t_best, best
