"""BVH mode's trace step: the closest hit of every ray through the
skip-threaded BVH of ``models/bvh_build.py``.

Named after the JAX module whose traversal it ports
(``hyper_ray_tracer_tpu/ops/bvh.py:make_bvh_traverser``, the ``'bvh'``
mode of ``make_intersector``).  Two implementations of one contract:

* ``bvh_traverse``: the wrapper of the hand-written Hopper kernel K4,
  ``csrc/bvh_traverse.cu`` (one thread walks one ray; the design note is
  at the top of the CUDA source).  It reads the tree as packed node
  records and the reordered geometry as packed, type-tagged primitive
  records (``bvh_scene``).
* ``bvh_traverse_plain``: the same function in plain torch.  CPU tensors
  take it; on the card it is only the reference the kernel is checked
  against.

Contract.  Every active ray carries a node cursor that starts at the
root (node 0); an inactive ray starts past the end.  At each step the
node's slab test (``ops/intersect.aabb_hit``) runs with ``t_min`` and the
ray's running best as ``t_max``.  On a hit of a leaf, its slots
``j < leaf_count`` are tested in index order by the scene-wide primitive
intersector ``prim_hit_t_lanes`` with the running best as the inclusive
``t_max``; a slot replaces the best only with a strictly smaller t.  The
next node is ``node + 1`` after a hit on an inner node, else
``skip[node]``; the walk ends past the last node.  The left-then-right
DFS order puts the leaves in index order along the walk, so ties go to
the lowest index.  A medium's free flight is bounded by the running
best (the typed sweep bounds it by the best at its plan tile's start, so
the two modes may differ on a few lanes of a scene with media).

Rays: ``o``, ``d`` [N,3] and ``time`` [N] float32, ``active`` [N] bool,
``bits`` [N] int64 bounce words (values below 2**32).  Returns ``t_best``
[N] float32 and ``best`` [N] int32, indices into the reordered geometry,
(BIG, -1) for a miss or an inactive ray.  The two implementations agree
bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models.scene import PT_SPHERE, SceneStatic
from ..utils import cuda_build
from .intersect import BIG, PrimFields, aabb_hit, prim_hit_t_lanes
from .typed_sweep import prim_records

# A leaf's word in K4's node record: first slot << LEAF_SHIFT | count.
LEAF_SHIFT = 4
MAX_LEAF_SIZE = 8


class BVHTree(NamedTuple):
    """The flattened tree (``models/bvh_build.BVHArrays``) as tensors."""

    bounds_min: torch.Tensor  # [Nn,3] float32
    bounds_max: torch.Tensor  # [Nn,3] float32
    leaf_first: torch.Tensor  # [Nn] int64, -1 for inner nodes
    leaf_count: torch.Tensor  # [Nn] int64
    skip: torch.Tensor  # [Nn] int64; == Nn ends the walk


class BVHScene(NamedTuple):
    """BVH mode's view of a scene on one device."""

    tree: BVHTree
    prims: PrimFields  # [P] every field of the reordered geometry (plain)
    static: SceneStatic  # the scene-wide flags of the primitive test
    nodes: torch.Tensor  # [Nn, 8] float32: (bmin, skip), (bmax, leaf word)
    geo: torch.Tensor  # [P, 4] float32 (ops/typed_sweep.prim_records)
    aux: torch.Tensor  # [P, 4] float32
    tag: torch.Tensor  # [P] int32, the PT_* type
    xf: torch.Tensor  # [P, 12] float32 (R row-major, t), [1, 12] without
    shutter: torch.Tensor  # [S, 2] float32 (time0, time1 - time0)


def node_records(bvh) -> np.ndarray:
    """K4's node records of the NumPy tree ``bvh`` (a BVHArrays): two
    float4 per node, (bounds_min, skip) and (bounds_max, leaf word), the
    ints stored as their bits; the leaf word is -1 for an inner node,
    else ``leaf_first << LEAF_SHIFT | leaf_count``."""
    first = np.asarray(bvh.leaf_first, np.int64)
    count = np.asarray(bvh.leaf_count, np.int64)
    if count.max() > MAX_LEAF_SIZE or first.max() >= 2**(31 - LEAF_SHIFT):
        raise ValueError("bvh: a leaf does not fit K4's node record")
    leaf = np.where(first >= 0, first << LEAF_SHIFT | count, -1)

    def bits(x):
        return np.asarray(x, np.int32).view(np.float32)[:, None]

    return np.ascontiguousarray(np.concatenate(
        [np.asarray(bvh.bounds_min, np.float32), bits(bvh.skip),
         np.asarray(bvh.bounds_max, np.float32), bits(leaf)], 1))


def bvh_scene(bvh, geom_np, geom, static: SceneStatic) -> BVHScene:
    """BVH mode's scene from the NumPy tree ``bvh`` and reordered NumPy
    geometry ``geom_np`` (``models/bvh_build.build_bvh``), with ``geom``
    the same geometry as tensors on the target device."""
    device = geom.p0.device

    def dev(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    tree = BVHTree(dev(bvh.bounds_min), dev(bvh.bounds_max),
                   *(dev(x, np.int64) for x in (bvh.leaf_first,
                                                bvh.leaf_count, bvh.skip)))
    n = np.asarray(geom_np.ptype).shape[0]
    pt = np.asarray(geom_np.ptype)
    # prim_hit_t_lanes lerps every sphere of a scene with motion.
    geo, aux, shutter = prim_records(geom_np, n,
                                     (pt == PT_SPHERE) & static.has_motion)
    if static.has_ray_xform:
        xf = np.concatenate(
            [np.asarray(geom_np.rot, np.float32).reshape(n, 9),
             np.asarray(geom_np.trans, np.float32)], 1)
    else:
        xf = np.zeros((1, 12), np.float32)
    prims = PrimFields(
        p0=geom.p0, p1=geom.p1, radius=geom.radius, time0=geom.time0,
        time1=geom.time1, ptype=geom.ptype, stable_id=geom.stable_id,
        axis=geom.axis, neg_inv_density=geom.neg_inv_density, rot=geom.rot,
        trans=geom.trans)
    return BVHScene(tree=tree, prims=PrimFields(*(x.contiguous()
                                                  for x in prims)),
                    static=static, nodes=dev(node_records(bvh)),
                    geo=dev(geo), aux=dev(aux), tag=dev(pt, np.int32),
                    xf=dev(xf), shutter=dev(shutter))


def bvh_traverse_plain(tree: BVHTree, prims: PrimFields, o, d, time,
                       active, bits, t_min, static: SceneStatic,
                       stats=None):
    """Plain-torch traversal: the JAX package's ``while_loop`` over
    per-lane node cursors, stepping only the lanes whose walk goes on
    (each lane's arithmetic is its own, so dropping finished lanes
    changes no result).  ``stats``: a dict that gets the work these rays
    need, ``node_tests`` (an int) and ``prim_tests`` ([P] int64, the leaf
    tests of each primitive)."""
    n = o.shape[0]
    n_nodes = tree.skip.shape[0]
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    best_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    lane = active.nonzero().squeeze(1)
    o, d, time, bits = (x[lane] for x in (o, d, time, bits))
    inv_d = 1.0 / d
    node = torch.zeros_like(lane)
    t_best = t_out[lane]
    best = best_out[lane]
    if stats is not None:
        stats["node_tests"] = 0
        stats["prim_tests"] = torch.zeros(prims.ptype.shape[0],
                                          dtype=torch.int64, device=o.device)
    while lane.numel():
        if stats is not None:
            stats["node_tests"] += lane.numel()
        hit = aabb_hit(tree.bounds_min[node], tree.bounds_max[node], o,
                       inv_d, t_min, t_best)
        first = tree.leaf_first[node]
        count = tree.leaf_count[node]
        at_leaf = hit & (first >= 0)
        slots = int(torch.where(at_leaf, count, 0).max())
        for j in range(slots):
            sel = (at_leaf & (count > j)).nonzero().squeeze(1)
            pid = first[sel] + j
            if stats is not None:
                stats["prim_tests"].index_add_(0, pid, torch.ones_like(pid))
            pf = PrimFields(*(x[pid] for x in prims))
            t_sel = t_best[sel]
            t = prim_hit_t_lanes(pf, o[sel], d[sel], time[sel], t_min, t_sel,
                                 bits[sel], static)
            upd = t < t_sel
            t_best[sel] = torch.where(upd, t, t_sel)
            best[sel] = torch.where(upd, pid.to(torch.int32), best[sel])
        node = torch.where(hit & (first < 0), node + 1, tree.skip[node])
        done = node >= n_nodes
        if bool(done.any()):
            t_out[lane[done]] = t_best[done]
            best_out[lane[done]] = best[done]
            keep = (~done).nonzero().squeeze(1)
            lane, o, d, inv_d, time, bits, node, t_best, best = (
                x[keep] for x in (lane, o, d, inv_d, time, bits, node,
                                  t_best, best))
    return t_out, best_out


def _bind(lib):
    fn = lib.hrt_bvh_traverse
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 5 + [c_int, ptr, c_int] + [ptr] * 5
                   + [c_int, ctypes.c_float, ptr, ptr, ptr])
    fn.restype = c_int
    return fn


def bvh_traverse(bvh: BVHScene, o, d, time, active, bits,
                 t_min: float = 1.0e-3):
    """Closest hit per ray through the BVH.  A CPU tensor takes the plain
    version; a CUDA tensor launches K4 (building it on first use) or
    raises.  Counts its kernel launches in ``bvh_traverse.launches``."""
    device = o.device
    if device.type == "cpu":
        return bvh_traverse_plain(bvh.tree, bvh.prims, o, d, time, active,
                                  bits, t_min, bvh.static)
    if device.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {device}")
    n, f32 = o.shape[0], torch.float32
    n_nodes, p = bvh.nodes.shape[0], bvh.geo.shape[0]
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("active", active, (n,), torch.bool),
            ("bits", bits, (n,), torch.int64),
            ("nodes", bvh.nodes, (n_nodes, 8), f32),
            ("geo", bvh.geo, (p, 4), f32), ("aux", bvh.aux, (p, 4), f32),
            ("tag", bvh.tag, (p,), torch.int32),
            ("xf", bvh.xf, (p if bvh.static.has_ray_xform else 1, 12), f32),
            ("shutter", bvh.shutter, (bvh.shutter.shape[0], 2), f32)):
        cuda_build.check_arg("bvh_traverse", name, x, shape, dtype, device)
    if n >= 2**31 // 3:
        raise ValueError(f"bvh_traverse: {n} rays exceed the kernel's "
                         "32-bit indexing")
    t_best = torch.empty(n, dtype=f32, device=device)
    best = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return t_best, best
    fn = _bind(cuda_build.load("bvh_traverse"))
    cuda_build.launch(
        "bvh_traverse", fn, device, o.data_ptr(), d.data_ptr(),
        time.data_ptr(), active.data_ptr(), bits.data_ptr(), n,
        bvh.nodes.data_ptr(), n_nodes, bvh.geo.data_ptr(),
        bvh.aux.data_ptr(), bvh.tag.data_ptr(), bvh.xf.data_ptr(),
        bvh.shutter.data_ptr(), int(bvh.static.has_ray_xform),
        float(t_min), t_best.data_ptr(), best.data_ptr())
    bvh_traverse.launches += 1
    return t_best, best


bvh_traverse.launches = 0
