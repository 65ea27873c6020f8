"""Scaling-efficiency harness (BASELINE.md: >=80% rays/s going 1 -> N).

Renders the same sample block on meshes of the first 1, 2, 4, ... ranks
and reports throughput and efficiency against the one-rank run.  With
one rank per GPU this measures the real scaling across cards.

Several ranks that share one card, or CPU ranks on one host, only
validate the *mechanism* (the sharded renders run and match): they
contend for the same device, so the efficiency column is meaningless
there.  Real numbers need a card per rank; the render is embarrassingly
parallel over rays (no communication per bounce, one gather of the
[W*H, 3] sum per sample block), so the efficiency should be bounded by
that gather and by load imbalance, not by the render loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..camera import make_basis
from ..models.scene import Scene
from ..render import prepare_scene
from ..scene_tensors import to_device
from .mesh import make_render_mesh
from .render_sharded import make_sharded_renderer


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    seconds: float
    mrays_per_s: float
    efficiency: float  # vs n_devices=1, per-device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(scene: Scene, width: int, height: int, depth: int,
                    spp: int, device_counts: Optional[Sequence[int]] = None,
                    reps: int = 3, seed: int = 0,
                    device=None) -> List[ScalingPoint]:
    """One point per entry of ``device_counts`` (default 1, 2, 4, ... up
    to the world size): the sharded renderer on a rays mesh of the first
    n ranks, the best of ``reps`` renders after a warm-up, each timed
    from a synchronised device to a synchronised device on rank 0.  A
    collective: every rank of the world calls it with the same arguments
    (ranks outside a point's mesh wait for it), and every rank returns
    the same points.  ``device``: this rank's (default the current CUDA
    device)."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    arrays, structure, mode = prepare_scene(scene)
    scene_t = to_device(arrays, scene.static, device, structure)
    basis = make_basis(scene.camera, width, height)
    n_rays = width * height * spp

    points: List[ScalingPoint] = []
    base_mrays = None
    for n in device_counts:
        mesh = make_render_mesh(n, 1)
        best = [float("inf")]
        if mesh.rank is not None:
            run = make_sharded_renderer(scene, width, height, depth, mesh,
                                        mode)
            run(scene_t, basis, 0, spp, seed)  # warm-up
            for _ in range(reps):
                _sync(device)
                t0 = time.perf_counter()
                run(scene_t, basis, 0, spp, seed)
                _sync(device)
                best[0] = min(best[0], time.perf_counter() - t0)
        dist.broadcast_object_list(best, src=0)
        mrays = n_rays / best[0] / 1e6
        if base_mrays is None:
            base_mrays = mrays
        points.append(ScalingPoint(n, best[0], mrays,
                                   mrays / (base_mrays * n)))
    return points
