"""Spatial primitive clusters for the cluster intersector (the JAX
package's ``models/clusters.py``; the port keeps its own copy).

Primitives are grouped on the host into compact spatial clusters, and the
trace (``ops/cluster_sweep.py``, K5 on the card) tests a ray against a
cluster's box before its primitives.  Build policy, as the reference's BVH
build (``bvh_node.rs:27-100``): recursive median split on the axis with
the widest centroid extent, sorted by ``aabb.min + aabb.max``.  Splitting
happens within each type-pure run of the canonical primitive order
(``ops/typed_sweep.type_runs``), so every cluster holds one type (one
plane axis for rects).  Runs shorter than ``CLUSTER_MIN_RUN`` stay in the
always-swept tail, in their canonical order.

Each run's clusters are padded to one width, a multiple of 8.  Pad slots
carry NaN geometry (every hit test's accept compares False against NaN,
so a pad never hits and never takes a gradient), PT_NONE as type, an
identity rotation and an empty box.  The result equals the JAX package's
``build_clusters`` array for array.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..ops.typed_sweep import type_runs
from .scene import PT_NONE, GeometrySoA

# Runs smaller than this stay in the always-swept tail.
CLUSTER_MIN_RUN = 256
# Target primitives per cluster: each run's cluster count is the power of
# two closest to count / CLUSTER_TARGET_PRIMS, at most
# MAX_CLUSTERS_PER_RUN (the JAX package's values).
CLUSTER_TARGET_PRIMS = 256
MAX_CLUSTERS_PER_RUN = 4096


class ClusterRun(NamedTuple):
    """One type-pure run of clusters in the padded geometry layout."""

    base: int  # first padded slot of this run
    n_clusters: int
    width: int  # padded slots per cluster (multiple of 8)
    types: frozenset  # single PT_* tag
    has_motion: bool
    has_xform: bool
    rect_axis: Optional[int]
    cmin: np.ndarray  # [n_clusters, 3] cluster AABB (world, shutter union)
    cmax: np.ndarray  # [n_clusters, 3]
    rmin_abs: float = 0.0  # smallest |radius| over the run (diagnostic)


class ClusterLayout(NamedTuple):
    runs: Tuple[ClusterRun, ...]
    # Always-swept tail: (start, width, types, motion, xform, rect_axis) in
    # padded-slot coordinates.
    tail: Tuple[tuple, ...]
    n_slots: int  # total padded geometry length
    src: np.ndarray  # [n_slots] canonical-order source index; -1 = pad


def _median_split(ids: np.ndarray, centers2: np.ndarray,
                  max_leaf: int) -> list:
    """Recursive median split until every leaf has <= max_leaf primitives;
    ``centers2`` = aabb_min + aabb_max."""
    out = []

    def rec(sub):
        if sub.shape[0] <= max_leaf:
            out.append(sub)
            return
        ext = centers2[sub]
        axis = int(np.argmax(ext.max(0) - ext.min(0)))  # widest extent
        sub = sub[np.argsort(ext[:, axis], kind="stable")]
        h = sub.shape[0] // 2
        rec(sub[:h])
        rec(sub[h:])

    rec(ids)
    return out


def cluster_eligible(geom: GeometrySoA, n_prims: int) -> bool:
    """True when at least one type run is long enough to be clustered."""
    return any(b - a >= CLUSTER_MIN_RUN
               for a, b, *_ in type_runs(geom, n_prims))


def build_clusters(geom: GeometrySoA,
                   n_prims: int) -> Tuple[GeometrySoA, ClusterLayout]:
    """Re-emit ``geom`` (canonical order, NumPy) in padded cluster order:
    (padded geometry, layout)."""
    amin = np.asarray(geom.aabb_min)[:n_prims]
    amax = np.asarray(geom.aabb_max)[:n_prims]
    centers2 = amin + amax

    runs_out, tail_out, src_parts = [], [], []
    cursor = 0
    for a, b, types, motion, xform, rect_axis in type_runs(geom, n_prims):
        count = b - a
        if count < CLUSTER_MIN_RUN:
            tail_out.append((cursor, count, types, motion, xform, rect_axis))
            src_parts.append(np.arange(a, b, dtype=np.int64))
            cursor += count
            continue
        n_target = 1 << max(0, round(math.log2(
            max(count / CLUSTER_TARGET_PRIMS, 1.0))))
        n_target = min(n_target, MAX_CLUSTERS_PER_RUN)
        max_leaf = -(-count // n_target)
        leaves = _median_split(np.arange(a, b, dtype=np.int64), centers2,
                               max_leaf)
        width = -(-max(len(lv) for lv in leaves) // 8) * 8
        cmin = np.stack([amin[lv].min(0) for lv in leaves])
        cmax = np.stack([amax[lv].max(0) for lv in leaves])
        for lv in leaves:
            src_parts.append(np.concatenate(
                [lv, np.full(width - len(lv), -1, np.int64)]))
        radii = np.abs(np.asarray(geom.radius)[a:b])
        runs_out.append(ClusterRun(
            base=cursor, n_clusters=len(leaves), width=width, types=types,
            has_motion=motion, has_xform=xform, rect_axis=rect_axis,
            cmin=cmin.astype(np.float32), cmax=cmax.astype(np.float32),
            rmin_abs=float(radii.min()) if radii.size else 0.0))
        cursor += len(leaves) * width

    src = np.concatenate(src_parts) if src_parts else np.empty(0, np.int64)
    assert src.shape[0] == cursor
    is_pad = src < 0
    take = np.where(is_pad, 0, src)

    def f32(field):
        out = np.asarray(field)[take].astype(np.float32, copy=True)
        out[is_pad] = np.nan
        return out

    def i32(field, pad_value):
        return np.where(is_pad, pad_value,
                        np.asarray(field)[take]).astype(np.int32)

    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (cursor, 3, 3))
    padded = GeometrySoA(
        ptype=i32(geom.ptype, PT_NONE),
        stable_id=i32(geom.stable_id, 0),
        p0=f32(geom.p0),
        p1=f32(geom.p1),
        radius=f32(geom.radius),
        axis=np.asarray(geom.axis)[take].astype(np.int32, copy=True),
        time0=f32(geom.time0),
        time1=f32(geom.time1),
        neg_inv_density=f32(geom.neg_inv_density),
        material=i32(geom.material, 0),
        rot=np.where(is_pad[:, None, None], eye,
                     np.asarray(geom.rot)[take]).astype(np.float32),
        trans=f32(geom.trans),
        aabb_min=np.where(is_pad[:, None], np.float32(np.inf),
                          np.asarray(geom.aabb_min)[take]).astype(np.float32),
        aabb_max=np.where(is_pad[:, None], np.float32(-np.inf),
                          np.asarray(geom.aabb_max)[take]).astype(np.float32),
    )
    layout = ClusterLayout(runs=tuple(runs_out), tail=tuple(tail_out),
                           n_slots=cursor, src=src)
    return padded, layout
