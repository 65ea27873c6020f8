"""Host-side flattened-BVH builder (the JAX package's
``models/bvh_build.py``; the port keeps its own copy).  Two builders of
one contract: the C++ one of ``native/bvh_builder.cpp``, which the port
compiles from the checkout and binds itself (``utils/native.py``), and
``_build_numpy``.  Both stable-sort and recurse in one order, so their
arrays are equal; ``build_bvh`` takes the C++ one unless asked not to.

Replicates the reference's construction policy
(``bvh_node.rs:27-100``):

* split axis = axis with the largest total AABB extent over the node's
  objects (bvh_node.rs:28-33, 83-100),
* objects sorted by ``aabb.min + aabb.max`` along that axis (:65-81),
* median split, recursed (:51-61),

but emits a *flattened, skip-pointer (threaded) DFS array* instead of a boxed
recursive enum, so the traversal is a stackless monotone walk:
``hit -> node+1``, ``miss/leaf-done -> skip[node]``.  Leaves hold up to
``leaf_size`` contiguous primitives in a reordered copy of the geometry SoA.
Left-then-right DFS order puts the leaves in primitive-index order along
the walk, which is what makes the walk's closest-hit ties go to the lowest
index.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import numpy as np

from ..utils import native
from .scene import PT_NONE, GeometrySoA


class BVHArrays(NamedTuple):
    """The flattened tree (DFS order, skip-threaded), NumPy."""

    bounds_min: np.ndarray  # [Nn,3] f32
    bounds_max: np.ndarray  # [Nn,3] f32
    leaf_first: np.ndarray  # [Nn] int32, -1 for inner nodes
    leaf_count: np.ndarray  # [Nn] int32
    skip: np.ndarray  # [Nn] int32; == Nn means traversal done


def _build_numpy(aabb_min, aabb_max, leaf_size: int):
    n = aabb_min.shape[0]
    centers2 = aabb_min + aabb_max  # sort key, bvh_node.rs:74-77

    bounds_min, bounds_max = [], []
    leaf_first, leaf_count, skip = [], [], []
    perm: list = []

    def emit(idx: np.ndarray) -> int:
        node_id = len(bounds_min)
        bounds_min.append(aabb_min[idx].min(0))
        bounds_max.append(aabb_max[idx].max(0))
        leaf_first.append(-1)
        leaf_count.append(0)
        skip.append(-1)  # patched after subtree emission

        if len(idx) <= leaf_size:
            leaf_first[node_id] = len(perm)
            leaf_count[node_id] = len(idx)
            perm.extend(idx.tolist())
        else:
            # Widest-extent axis over this node's AABBs (bvh_node.rs:28-33).
            ext = aabb_max[idx].max(0) - aabb_min[idx].min(0)
            axis = int(np.argmax(ext))
            order = np.argsort(centers2[idx, axis], kind="stable")
            idx = idx[order]
            mid = len(idx) // 2
            emit(idx[:mid])
            emit(idx[mid:])
        skip[node_id] = len(bounds_min)
        return node_id

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        emit(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    return (
        np.stack(bounds_min).astype(np.float32),
        np.stack(bounds_max).astype(np.float32),
        np.asarray(leaf_first, np.int32),
        np.asarray(leaf_count, np.int32),
        np.asarray(skip, np.int32),
        np.asarray(perm, np.int64),
    )


def build_bvh(geom: GeometrySoA, leaf_size: int = 4,
              use_native: bool = True) -> Tuple[BVHArrays, GeometrySoA]:
    """Build the flattened BVH over the *real* (non-padding) primitives and
    return it together with the geometry SoA reordered into leaf order and
    padded with ``leaf_size`` PT_NONE slots (``time1 = 1`` there, so a
    motion lerp on a pad slot never divides 0 by 0).  ``use_native``:
    build with the C++ builder (compiled on first use; a missing compiler
    raises), else with NumPy; the trees are equal."""
    real = np.asarray(geom.ptype) != PT_NONE
    n = int(real.sum())
    if n == 0:
        raise ValueError("empty scene")
    idx_real = np.nonzero(real)[0]
    amin = np.asarray(geom.aabb_min)[idx_real]
    amax = np.asarray(geom.aabb_max)[idx_real]
    builder = native.build_bvh_arrays if use_native else _build_numpy
    bmin, bmax, first, count, skip, perm = builder(amin, amax, leaf_size)
    order = idx_real[perm]

    def reorder(a):
        a = np.asarray(a)
        pad = np.zeros((leaf_size, *a.shape[1:]), a.dtype)
        return np.concatenate([a[order], pad], axis=0)

    fields = {k: reorder(getattr(geom, k)) for k in geom._fields}
    fields["ptype"][n:] = PT_NONE
    fields["time1"][n:] = 1.0
    bvh = BVHArrays(bounds_min=bmin, bounds_max=bmax, leaf_first=first,
                    leaf_count=count, skip=skip)
    return bvh, GeometrySoA(**fields)
