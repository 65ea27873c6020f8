"""Carry a scene's NumPy arrays across to torch tensors on a device.

``to_device`` is the one entry point that turns a ``SceneArrays`` into the
port's tensors.  Its input can come from the port's own ``build_scene`` or
from the JAX package's (``build_scene(name).arrays``): the two are equal
array for array, which is how the tests feed both packages one scene.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.scene import PT_SPHERE, SceneStatic
from .ops.intersect import pack_prim_shade
from .ops.perlin import key_ints
from .ops.textures import TextureTables
from .ops.typed_sweep import SweepScene, sweep_scene


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
    spheres: SphereFields  # the first n_prims primitives
    sweep: SweepScene  # the typed sweep's plan and primitive fields
    fpack: torch.Tensor  # [P, F] float32 joined shade rows
    ipack: torch.Tensor  # [P, 7] int32
    tables: TextureTables  # images, Perlin keys and tables


def _tensor(x, device):
    x = np.asarray(x)
    if x.dtype == np.uint32:  # RNG words live in int64 (ops/rng.py)
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


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


def to_device(arrays, static: SceneStatic, device) -> SceneTensors:
    """SceneArrays of NumPy arrays -> SceneTensors on ``device``."""
    device = torch.device(device)
    t = _convert(arrays, device)
    g = t.geom
    n = static.n_prims
    spheres = SphereFields(*(x[:n].contiguous() for x in
                             (g.p0, g.p1, g.time0, g.time1, g.radius)))
    fpack, ipack = pack_prim_shade(t, static)
    tables = TextureTables(images=t.images, image_wh=t.image_wh,
                           perlin_keys=key_ints(arrays.perlin.keys),
                           perlin=t.perlin)
    return SceneTensors(
        arrays=t, static=static,
        sphere_only=sphere_only(static, arrays.geom.ptype),
        spheres=spheres, sweep=sweep_scene(arrays.geom, g, n),
        fpack=fpack, ipack=ipack, tables=tables)
