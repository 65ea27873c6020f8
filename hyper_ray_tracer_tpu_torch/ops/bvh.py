"""BVH mode's trace step: the closest hit of every ray through the BVH of
``models/bvh_build.py``.

Named after the JAX module whose traversal it ports
(``hyper_ray_tracer_tpu/ops/bvh.py:make_bvh_traverser``, the ``'bvh'``
mode of ``make_intersector``).  Two implementations of one contract:

* ``bvh_traverse``: the wrapper of the hand-written Hopper kernel K4,
  ``csrc/bvh_traverse.cu`` (one thread walks one ray; the design note
  is at the top of the CUDA source).  It reads the tree as
  two-child node records (``node_records``) and the reordered geometry
  as packed, type-tagged primitive records (``bvh_scene``).
* ``bvh_traverse_plain``: the same function in plain torch.  CPU tensors
  take it; on the card it is only the reference the kernel is checked
  against.

Contract: the nearer child first.  An inactive ray, and one that misses
the root's slab test (``ops/intersect.aabb_hit`` with ``t_min`` and BIG),
returns (BIG, -1).  At an inner node n the children are L = n + 1 and
R = skip[n + 1]; both slabs are tested with ``t_min`` and the ray's
running best as ``t_max``.  If both hit, the walk goes to the one whose
entry t_lo (``aabb_entry``) is smaller, L on a tie, and pushes (the
other, its t_lo); if one hits, it goes there; if none, it pops.  At a
leaf its slots ``j < leaf_count`` are tested in index order by the
scene-wide primitive intersector ``prim_hit_t_lanes`` with the running
best as the inclusive ``t_max``; a slot wins with t < best t, or with an
equal t and a lower index, so ties go to the lowest index in any visit
order.  Then it pops: the top (node, t_lo) is visited only if best t >
t_lo (the slab test rerun with the new ``t_max``: its far side already
passed), else popped again; an empty stack ends the walk.  A medium's
free flight is bounded by the running best, so on a scene with media
the result may depend on the visit order: this walk and the JAX
package's may part there, and the typed sweep (bounded by the best at its
plan tile's start) may part from both.

``bvh_traverse_dfs_plain`` is the JAX package's own walk (left then
right, skip-threaded, no stack), kept as the reference the tests hold to
``make_bvh_traverser``.

Rays: ``o``, ``d`` [N,3] and ``time`` [N] float32, ``active`` [N] bool,
``bits`` [N] int64 bounce words (values below 2**32).  Returns ``t_best``
[N] float32 and ``best`` [N] int32, indices into the reordered geometry,
(BIG, -1) for a miss or an inactive ray.  The kernel and
``bvh_traverse_plain`` agree bit for bit.

Tracing (``utils/profiling.py``): each launch of K4 runs in the span
``K4`` and counts in ``K4.launches`` and its rays in ``K4.lanes``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models.scene import PT_NONE, PT_SPHERE, SceneStatic
from ..utils import cuda_build
from ..utils.profiling import host_sync
from .intersect import BIG, PrimFields, aabb_entry, aabb_hit, prim_hit_t_lanes
from .typed_sweep import prim_records

# A leaf's word in a node record: ~(first slot << LEAF_SHIFT | count).
LEAF_SHIFT = 4
MAX_LEAF_SIZE = 8
# Entries of K4's per-thread stack (csrc/bvh_traverse.cu kStack): the
# deepest tree it walks (a walk at a leaf of depth k holds at most k).
STACK_SIZE = 32


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
    nodes: torch.Tensor  # [1 + inner nodes, 16] float32 (node_records)
    geo: torch.Tensor  # [P, 4] float32 (ops/typed_sweep.prim_records)
    aux: torch.Tensor  # [P, 4] float32
    tag: torch.Tensor  # [P] int32, the PT_* type
    xf: torch.Tensor  # [P, 12] float32 (R row-major, t), [1, 12] without
    shutter: torch.Tensor  # [S, 2] float32 (time0, time1 - time0)
    depth: int  # edges from the root to the deepest leaf (tree_depth)
    leaf_size: int  # the build's: build_bvh appends that many empty slots


def node_records(bvh) -> np.ndarray:
    """K4's node records of the NumPy tree ``bvh`` (a BVHArrays): one
    64-byte row per inner node, in the tree's order from row 1, holding
    both children, as four float4 (ints stored as their bits):
    (L.min, L word), (L.max, R word), (R.min, 0), (R.max, 0).  A child's
    word is its row for an inner node, else its leaf word
    ``~(leaf_first << LEAF_SHIFT | leaf_count)`` (negative).  Row 0 holds
    the root: (min, word), (max, 0), zeros."""
    first = np.asarray(bvh.leaf_first, np.int64)
    count = np.asarray(bvh.leaf_count, np.int64)
    skip = np.asarray(bvh.skip, np.int64)
    bmin = np.asarray(bvh.bounds_min, np.float32)
    bmax = np.asarray(bvh.bounds_max, np.float32)
    if count.max() > MAX_LEAF_SIZE or first.max() >= 2**(31 - LEAF_SHIFT):
        raise ValueError("bvh: a leaf does not fit K4's node record")
    inner = np.flatnonzero(first < 0)
    row = np.zeros(first.shape[0], np.int64)
    row[inner] = 1 + np.arange(inner.shape[0])
    word = np.where(first < 0, row, ~(first << LEAF_SHIFT | count))
    rec = np.zeros((1 + inner.shape[0], 16), np.float32)
    bits = rec.view(np.int32)
    rec[0, 0:3], bits[0, 3], rec[0, 4:7] = bmin[0], word[0], bmax[0]
    left = inner + 1
    right = skip[left]
    r = row[inner]
    rec[r, 0:3], bits[r, 3] = bmin[left], word[left]
    rec[r, 4:7], bits[r, 7] = bmax[left], word[right]
    rec[r, 8:11], rec[r, 12:15] = bmin[right], bmax[right]
    return rec


def tree_depth(bvh) -> int:
    """Edges from the root to the deepest leaf of the NumPy tree ``bvh``."""
    first = np.asarray(bvh.leaf_first)
    skip = np.asarray(bvh.skip)
    level, depth = np.zeros(1, np.int64), 0
    while True:
        inner = level[first[level] < 0]
        if inner.size == 0:
            return depth
        level = np.concatenate([inner + 1, skip[inner + 1]])
        depth += 1


def bvh_scene(bvh, geom_np, geom, static: SceneStatic) -> BVHScene:
    """BVH mode's scene from the NumPy tree ``bvh`` and reordered NumPy
    geometry ``geom_np`` (``models/bvh_build.build_bvh``), with ``geom``
    the same geometry as tensors on the target device.  Raises if the
    tree is deeper than K4's stack."""
    depth = tree_depth(bvh)
    if depth > STACK_SIZE:
        raise ValueError(f"bvh: the tree is {depth} deep, deeper than K4's "
                         f"stack of {STACK_SIZE}")
    device = geom.p0.device

    def dev(x, dtype=None):
        return host_sync(torch.from_numpy(np.ascontiguousarray(x, dtype))
                         .to(device))

    tree = BVHTree(dev(bvh.bounds_min), dev(bvh.bounds_max),
                   *(dev(x, np.int64) for x in (bvh.leaf_first,
                                                bvh.leaf_count, bvh.skip)))
    return bvh_leaf_records(
        BVHScene(tree=tree, prims=None, static=static,
                 nodes=dev(node_records(bvh)), geo=None, aux=None,
                 tag=None, xf=None, shutter=None, depth=depth,
                 leaf_size=int((np.asarray(geom_np.ptype) == PT_NONE)
                               .sum())),
        geom_np, geom)


def bvh_leaf_records(scene: BVHScene, geom_np, geom) -> BVHScene:
    """``scene`` with the primitives its leaves hold (``prims`` and K4's
    ``geo``, ``aux``, ``tag``, ``xf``, ``shutter``) taken from the
    reordered geometry ``geom_np`` (NumPy) and ``geom`` (the same as
    tensors).  The tree and its node records stay as they are: a train
    step moves the primitives, not the boxes, as the JAX package's walk
    reads the merged parameters inside the tree built once."""
    static = scene.static
    device = geom.p0.device

    def dev(x, dtype=None):
        return host_sync(torch.from_numpy(np.ascontiguousarray(x, dtype))
                         .to(device))

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
    return scene._replace(prims=PrimFields(*(x.contiguous()
                                             for x in prims)),
                          geo=dev(geo), aux=dev(aux), tag=dev(pt, np.int32),
                          xf=dev(xf), shutter=dev(shutter))


def _test_leaves(tree, prims, sel, node, o, d, time, bits, t_min, static,
                 t_best, best, stats):
    """The slots of leaf ``node`` of each lane ``sel``, in index order, with
    the running best as the inclusive t_max; a slot wins with a smaller t,
    or an equal t and a lower index."""
    first = tree.leaf_first[node]
    count = tree.leaf_count[node]
    for j in range(int(count.max()) if sel.numel() else 0):
        has = count > j
        lanes = sel[has]
        pid = first[has] + j
        if stats is not None:
            stats["prim_tests"].index_add_(0, pid, torch.ones_like(pid))
        pf = PrimFields(*(x[pid] for x in prims))
        t_sel, b_sel = t_best[lanes], best[lanes]
        pid32 = pid.to(torch.int32)
        t = prim_hit_t_lanes(pf, o[lanes], d[lanes], time[lanes], t_min,
                             t_sel, bits[lanes], static)
        upd = (t < t_sel) | ((t == t_sel) & (pid32 < b_sel))
        t_best[lanes] = torch.where(upd, t, t_sel)
        best[lanes] = torch.where(upd, pid32, b_sel)


def bvh_traverse_plain(tree: BVHTree, prims: PrimFields, o, d, time,
                       active, bits, t_min, static: SceneStatic,
                       stats=None):
    """Plain-torch traversal of the contract above, nearer child first,
    over per-lane cursors and stacks.  Each round every lane still walking
    takes its next steps in its own order: an inner node's two slab tests,
    then a leaf's slots if that led to one, then pops until it has a node
    to visit; lanes that end drop out (each lane's arithmetic is its own,
    so the rounds change no result).  ``stats``: a dict that gets the work
    these rays need: ``box_tests`` (the root's and two an inner step),
    ``inner_steps``, ``prim_tests`` ([P] int64, the leaf tests of each
    primitive) and ``max_stack`` (the deepest stack any ray reached)."""
    n = o.shape[0]
    dev = o.device
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lane = active.nonzero().squeeze(1)
    o, d, time, bits = (x[lane] for x in (o, d, time, bits))
    inv_d = 1.0 / d
    t_best = torch.full((lane.numel(),), BIG, dtype=torch.float32,
                        device=dev)
    root, _ = aabb_entry(tree.bounds_min[0], tree.bounds_max[0], o, inv_d,
                         t_min, t_best)
    if stats is not None:
        stats.update(box_tests=lane.numel(), inner_steps=0, max_stack=0,
                     prim_tests=torch.zeros(prims.ptype.shape[0],
                                            dtype=torch.int64, device=dev))
    keep = root.nonzero().squeeze(1)
    lane, o, d, inv_d, time, bits, t_best = (
        x[keep] for x in (lane, o, d, inv_d, time, bits, t_best))
    m = lane.numel()
    node = torch.zeros(m, dtype=torch.int64, device=dev)  # -1: pop
    best = torch.full((m,), -1, dtype=torch.int32, device=dev)
    stack_node = torch.zeros((m, 8), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((m, 8), dtype=torch.float32, device=dev)
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    while lane.numel():
        # An inner node: both children's slab tests.
        sel = (tree.leaf_first[node] < 0).nonzero().squeeze(1)
        if sel.numel():
            left = node[sel] + 1
            right = tree.skip[left]
            ray = (o[sel], inv_d[sel], t_min, t_best[sel])
            h_l, t_l = aabb_entry(tree.bounds_min[left],
                                  tree.bounds_max[left], *ray)
            h_r, t_r = aabb_entry(tree.bounds_min[right],
                                  tree.bounds_max[right], *ray)
            both = h_l & h_r
            r_first = t_r < t_l
            node[sel] = torch.where(
                both, torch.where(r_first, right, left),
                torch.where(h_l, left, torch.where(h_r, right, -1)))
            push = sel[both]
            if push.numel():
                at = sp[push]
                if int(at.max()) >= stack_node.shape[1]:
                    stack_node = torch.cat([stack_node, torch.zeros_like(
                        stack_node)], 1)
                    stack_t = torch.cat([stack_t, torch.zeros_like(
                        stack_t)], 1)
                rf = r_first[both]
                stack_node[push, at] = torch.where(rf, left[both],
                                                   right[both])
                stack_t[push, at] = torch.where(rf, t_l[both], t_r[both])
                sp[push] = at + 1
            if stats is not None:
                stats["box_tests"] += 2 * sel.numel()
                stats["inner_steps"] += sel.numel()
                stats["max_stack"] = max(stats["max_stack"], int(sp.max()))
        # A leaf: its slots, then pop.
        sel = ((node >= 0) & (tree.leaf_first[node.clamp(min=0)] >= 0)
               ).nonzero().squeeze(1)
        _test_leaves(tree, prims, sel, node[sel], o, d, time, bits, t_min,
                     static, t_best, best, stats)
        node[sel] = -1
        # Pop until a node to visit (best t > its t_lo) or an empty stack.
        while True:
            sel = ((node < 0) & (sp > 0)).nonzero().squeeze(1)
            if not sel.numel():
                break
            top = sp[sel] - 1
            sp[sel] = top
            visit = t_best[sel] > stack_t[sel, top]
            node[sel] = torch.where(visit, stack_node[sel, top], -1)
        done = node < 0
        if bool(done.any()):
            t_out[lane[done]] = t_best[done]
            best_out[lane[done]] = best[done]
            keep = (~done).nonzero().squeeze(1)
            (lane, o, d, inv_d, time, bits, node, t_best, best, sp,
             stack_node, stack_t) = (
                x[keep] for x in (lane, o, d, inv_d, time, bits, node,
                                  t_best, best, sp, stack_node, stack_t))
    return t_out, best_out


def bvh_traverse_dfs_plain(tree: BVHTree, prims: PrimFields, o, d, time,
                           active, bits, t_min, static: SceneStatic,
                           stats=None):
    """The JAX package's walk in plain torch (``make_bvh_traverser``): a
    node cursor from the root, each node's slab test with the running
    best as t_max, a hit leaf's slots in index order, then ``node + 1``
    after a hit on an inner node, else ``skip[node]``, until past the last
    node.  The left-then-right order puts the leaves in index order, so
    a strictly smaller t wins, as the JAX package's test has it: the
    lower index of an equal t (``_test_leaves``) was always tested
    first.  It
    steps only the lanes whose walk goes on (each lane's arithmetic is its
    own, so dropping finished lanes changes no result).  ``stats``: a
    dict that gets ``node_tests`` (an int) and ``prim_tests`` ([P]
    int64)."""
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
        sel = (hit & (first >= 0)).nonzero().squeeze(1)
        _test_leaves(tree, prims, sel, node[sel], o, d, time, bits, t_min,
                     static, t_best, best, stats)
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
    fn.argtypes = ([ptr] * 5 + [c_int, ptr] + [ptr] * 5
                   + [c_int, ctypes.c_float, ptr, ptr, ptr])
    fn.restype = c_int
    return fn


def bvh_traverse(bvh: BVHScene, o, d, time, active, bits,
                 t_min: float = 1.0e-3):
    """Closest hit per ray through the BVH.  A CPU tensor takes the plain
    version; a CUDA tensor launches K4 (building it on first use) or
    raises.  A launch is traced as ``K4`` (``cuda_build.launch``)."""
    device = o.device
    if device.type == "cpu":
        return bvh_traverse_plain(bvh.tree, bvh.prims, o, d, time, active,
                                  bits, t_min, bvh.static)
    if device.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {device}")
    n, f32 = o.shape[0], torch.float32
    rows, p = bvh.nodes.shape[0], bvh.geo.shape[0]
    for name, x, shape, dtype in (
            ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
            ("time", time, (n,), f32), ("active", active, (n,), torch.bool),
            ("bits", bits, (n,), torch.int64),
            ("nodes", bvh.nodes, (rows, 16), f32),
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
        bvh.nodes.data_ptr(), bvh.geo.data_ptr(), bvh.aux.data_ptr(),
        bvh.tag.data_ptr(), bvh.xf.data_ptr(), bvh.shutter.data_ptr(),
        int(bvh.static.has_ray_xform), float(t_min), t_best.data_ptr(),
        best.data_ptr(), tag="K4", lanes=n)
    return t_best, best
