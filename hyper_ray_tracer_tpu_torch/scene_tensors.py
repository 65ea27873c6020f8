"""Carry a scene's NumPy arrays across to torch tensors on a device.

``to_device`` is the one entry point that turns a ``SceneArrays`` into the
port's tensors.  Its input can come from the port's own ``build_scene`` or
from the JAX package's (``build_scene(name).arrays``): the two are equal
array for array, which is how the tests feed both packages one scene.

In BVH mode (``render.prepare_scene`` with ``intersector='bvh'``) the
arrays come reordered into the tree's leaf order, and ``to_device`` also
uploads the tree and the records K4 reads (``ops/bvh.bvh_scene``); the
sweeps' records are not built then.  In cluster mode the geometry comes
in the padded cluster order (``models/clusters.build_clusters``: more
slots than ``static.n_prims``, NaN geometry on the pads), and
``to_device`` uploads the layout's groups and boxes and the records K5
reads (``ops/cluster_sweep.cluster_scene``); every table indexed by a
primitive (the shade rows, the parameters) has a row per slot.  In sweep
mode ``to_device`` also picks the partitioned sweep's groups
(``ops/partition.partition_groups``), cuts the typed sweep's plan at
their bounds and keeps their baked boxes.

A train step splits the result by what changes.  What stays fixed per
scene: the sweep's plan (taken from the geometry as built, as the JAX
package's host-side plan is), the int shade rows, the Perlin tables and
the image sizes.  What follows the parameters (``PARAM_PATHS``) is
rebuilt by ``bind_params`` once per forward: the joined float shade rows
inside the autograd graph, the sphere fields as views of the parameters,
and the sweeps' packed records (in BVH mode K4's leaf records, in
cluster mode K5's slot records) from their detached current values.  A
BVH's tree (its node boxes) and a cluster layout's boxes stay as built,
as in the JAX package.

Tracing (``utils/profiling.py``): ``to_device`` runs in the span
``upload`` and ``bind_params`` in the span ``bind_params``; each copy
between the host and the card counts in ``syncs``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .models.clusters import ClusterLayout
from .models.scene import PT_SPHERE, GeometrySoA, SceneStatic
from .ops.bvh import BVHScene, bvh_leaf_records, bvh_scene
from .ops.cluster_sweep import ClusterScene, cluster_records, cluster_scene
from .ops.intersect import pack_prim_shade
from .ops.partition import baked_aabbs, device_group_aabbs, partition_groups
from .ops.perlin import key_ints
from .ops.textures import TextureTables
from .ops.typed_sweep import SweepScene, sweep_scene
from .utils.profiling import host_sync, span

# SceneArrays leaves that a train step optimises (the JAX package's
# train.py:32-43); keys are "group.field", "images.None" for the images.
# Everything else (type tags, ids, times, transforms, Perlin tables)
# stays fixed.
PARAM_PATHS = (
    ("geom", "p0"),
    ("geom", "p1"),
    ("geom", "radius"),
    ("materials", "albedo"),
    ("materials", "fuzz"),
    ("materials", "ior"),
    ("textures", "color1"),
    ("textures", "color2"),
    ("textures", "scale"),
    ("images", None),
)


class SphereFields(NamedTuple):
    """The sphere sweep's view of the scene: [P] / [P,3] float32,
    contiguous."""

    p0: torch.Tensor
    p1: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor
    radius: torch.Tensor


class SceneTensors(NamedTuple):
    arrays: object  # SceneArrays with every array leaf a torch tensor
    static: SceneStatic
    sphere_only: bool  # traced by the sphere sweep, else the typed sweep
    spheres: SphereFields  # the first n_prims primitives (every slot in
    # cluster mode)
    sweep: Optional[SweepScene]  # the typed sweep's plan and primitive
    # fields (None in BVH and cluster mode)
    fpack: torch.Tensor  # [P, F] float32 joined shade rows
    ipack: torch.Tensor  # [P, 7] int32
    tables: TextureTables  # images, Perlin keys and tables
    host_geom: GeometrySoA  # the geometry as built, NumPy (the plan's)
    bvh: Optional[BVHScene] = None  # BVH mode's tree and records
    cluster: Optional[ClusterScene] = None  # cluster mode's layout, records
    # Each partition group's (bmin, bmax) float32 [3] tensors (``groups``):
    # as baked into the scene, or after ``bind_params`` from the bound
    # parameters (None there when a group is not ``dynamic_ok``).
    group_aabbs: Optional[tuple] = None

    @property
    def mode(self) -> str:
        """The intersector that traces the scene: 'bvh', 'cluster' or
        'sweep'."""
        if self.bvh is not None:
            return "bvh"
        return "sweep" if self.cluster is None else "cluster"

    @property
    def groups(self) -> tuple:
        """Sweep mode's partition groups (``ops/partition.PartGroup``, at
        most 2; the typed sweep's plan is cut at their bounds), else ()."""
        return () if self.sweep is None else self.sweep.groups


def _tensor(x, device):
    x = np.asarray(x)
    if x.dtype == np.uint32:  # RNG words live in int64 (ops/rng.py)
        x = x.astype(np.int64)
    return host_sync(torch.from_numpy(np.ascontiguousarray(x)).to(device))


def _convert(tree, device):
    """Map every array leaf of a NamedTuple tree to a tensor."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_convert(x, device) for x in tree))
    return _tensor(tree, device)


def sphere_only(static: SceneStatic, ptype) -> bool:
    """True when the sphere sweep can trace the scene: every primitive is
    a sphere, with no media and no ray transforms."""
    kinds = set(np.unique(np.asarray(ptype)[:static.n_prims]).tolist())
    return kinds == {PT_SPHERE} and not static.has_media \
        and not static.has_ray_xform


@span("upload")
def to_device(arrays, static: SceneStatic, device, bvh=None,
              clusters=None) -> SceneTensors:
    """SceneArrays of NumPy arrays -> SceneTensors on ``device``.  ``bvh``:
    the tree (``models/bvh_build.BVHArrays``) of BVH mode, with ``arrays``
    reordered by the same ``build_bvh``; ``clusters``: the layout
    (``models/clusters.ClusterLayout``) of cluster mode, with ``arrays``
    in its padded order; neither traces with the sweeps.  The middle
    value of ``render.prepare_scene`` goes in as ``bvh`` in every mode: a
    layout passed there is taken as ``clusters``."""
    if isinstance(bvh, ClusterLayout):
        bvh, clusters = None, bvh
    device = torch.device(device)
    t = _convert(arrays, device)
    g = t.geom
    n = static.n_prims if clusters is None else clusters.n_slots
    spheres = SphereFields(*(x[:n].contiguous() for x in
                             (g.p0, g.p1, g.time0, g.time1, g.radius)))
    fpack, ipack = pack_prim_shade(t, static)
    tables = TextureTables(images=t.images, image_wh=t.image_wh,
                           perlin_keys=key_ints(arrays.perlin.keys),
                           perlin=t.perlin)
    host = GeometrySoA(*(np.asarray(x) for x in arrays.geom))
    sweep_mode = bvh is None and clusters is None
    groups = partition_groups(host, n) if sweep_mode else ()
    return SceneTensors(
        arrays=t, static=static,
        sphere_only=sphere_only(static, arrays.geom.ptype),
        spheres=spheres,
        sweep=sweep_scene(host, g, n, groups=groups) if sweep_mode else None,
        group_aabbs=baked_aabbs(groups, device),
        fpack=fpack, ipack=ipack, tables=tables, host_geom=host,
        bvh=None if bvh is None else bvh_scene(bvh, host, g, static),
        cluster=(None if clusters is None
                 else cluster_scene(clusters, host, g)))


def extract_params(arrays) -> dict:
    """{"group.field": leaf} of the trainable leaves of ``arrays``."""
    params = {}
    for group, field in PARAM_PATHS:
        node = getattr(arrays, group)
        params[f"{group}.{field}"] = (node if field is None
                                      else getattr(node, field))
    return params


def merge_params(arrays, params):
    """``arrays`` with its trainable leaves replaced by ``params``."""
    for group, field in PARAM_PATHS:
        key = f"{group}.{field}"
        if field is None:
            arrays = arrays._replace(**{group: params[key]})
        else:
            node = getattr(arrays, group)._replace(**{field: params[key]})
            arrays = arrays._replace(**{group: node})
    return arrays


@span("bind_params")
def bind_params(scene_t: SceneTensors, params: dict) -> SceneTensors:
    """``scene_t`` with the parameter tensors ``params`` (keys of
    ``PARAM_PATHS``) in place of its own, for one forward pass.

    The joined float shade rows are packed from ``params`` inside the
    autograd graph, so gradients reach every parameter, and the sphere
    fields are views of them (p1 is p0 for the spheres of tiles planned
    without motion).  The sweeps trace the parameters' current
    values: their packed records are rebuilt from detached NumPy copies
    (equal to ``typed_records`` of those values by construction), on the
    plan of the scene as built.  In BVH mode K4's leaf records are rebuilt
    the same way (``ops/bvh.bvh_leaf_records``) and the tree stays as
    built: neither refit nor rebuilt, as in the JAX package, whose walk
    reads the merged parameters inside the boxes of the tree it was given.
    In cluster mode K5's slot records are rebuilt and the layout's boxes
    kept, likewise.  In sweep mode the partition groups' boxes are
    recomputed from the moved parameters (``ops/partition.
    device_group_aabbs``), so that a partitioned step never reads a
    stale box; None when some group has no such box.  The int rows, the
    plan, the groups and the Perlin tables are ``scene_t``'s own."""
    static = scene_t.static
    n = static.n_prims
    arrays = merge_params(scene_t.arrays, params)
    g = arrays.geom
    fpack, _ = pack_prim_shade(arrays, static)
    moved = {k: params[f"geom.{k}"].detach() for k in ("p0", "p1",
                                                        "radius")}
    host = scene_t.host_geom._replace(
        **{k: host_sync(v.cpu()).numpy() for k, v in moved.items()})
    tables = scene_t.tables._replace(images=params["images.None"])
    if scene_t.bvh is not None:
        spheres = SphereFields(g.p0[:n], g.p1[:n], g.time0[:n],
                               g.time1[:n], g.radius[:n])
        bvh = bvh_leaf_records(scene_t.bvh, host,
                               scene_t.arrays.geom._replace(**moved))
        return scene_t._replace(arrays=arrays, spheres=spheres, bvh=bvh,
                                fpack=fpack, tables=tables)
    if scene_t.cluster is not None:
        spheres = SphereFields(g.p0, g.p1, g.time0, g.time1, g.radius)
        cluster = cluster_records(scene_t.cluster, host,
                                  scene_t.arrays.geom._replace(**moved))
        return scene_t._replace(arrays=arrays, spheres=spheres,
                                cluster=cluster, fpack=fpack, tables=tables)
    # The sphere sweep lerps every sphere whose p1 differs from p0; a
    # sphere of a tile planned without motion traces at p0 however its
    # p1 has moved, as the typed sweep's plan has it.
    lerp = np.zeros(n, bool)
    for t in scene_t.sweep.plan:
        lerp[t.start:t.start + t.width] = t.motion
    p1 = g.p1[:n] if lerp.all() else g.p0[:n] if not lerp.any() else \
        torch.where(host_sync(torch.from_numpy(lerp).to(g.p1.device))[:, None],
                    g.p1[:n], g.p0[:n])
    spheres = SphereFields(g.p0[:n], p1, g.time0[:n], g.time1[:n],
                           g.radius[:n])
    sweep = sweep_scene(host, scene_t.arrays.geom._replace(**moved), n,
                        plan=scene_t.sweep.plan, groups=scene_t.groups)
    aabbs = None
    if all(gr.dynamic_ok for gr in scene_t.groups):
        with torch.no_grad():
            aabbs = device_group_aabbs(
                scene_t.groups, scene_t.arrays.geom._replace(**moved))
    return scene_t._replace(arrays=arrays, spheres=spheres, sweep=sweep,
                            fpack=fpack, tables=tables, group_aabbs=aabbs)
