"""Differentiable rendering: the inverse-rendering train step (the JAX
package's ``train.py``) and its throughput CLI (its ``bench_grad.py``).

The loss is the mean squared error between each pixel's mean radiance
and a target image, through ``render.render_radiance``; the step is one
adam update of every parameter in ``PARAM_PATHS`` (sphere centers and
radii, metal albedo and fuzz, dielectric IOR, texture colors, the noise
scale, image texels).

Gradient conventions for discrete events (the JAX package's): hit or
miss, the winner, the reflect-or-refract draw, the checker's sign and the
texel are decisions of the forward pass.  Gradients flow through the
continuous quantities (the winner's t, scatter directions,
attenuations), not through decision boundaries.

Run a train step's timing (one JSON line) with
``python -m hyper_ray_tracer_tpu_torch.train [scene] [W] [H] [SPP]
[DEPTH] [--intersector auto|sweep|cluster|bvh] [--silhouette]
[--no-partition]``; on the CPU add ``--cpu`` and a small shape.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .camera import make_basis
from .models.scene import Scene
from .ops.edges import make_silhouette_correction
from .ops.typed_sweep import bf16_engages
from .render import (
    PartitionSchedule,
    check_upload,
    prepare_scene,
    render_radiance,
    resolve_intersector,
)
from .scene_tensors import (  # noqa: F401  (PARAM_PATHS is re-exported)
    PARAM_PATHS,
    bind_params,
    extract_params,
    merge_params,
    to_device,
)
from .utils.logging import get as get_logger
from .utils.profiling import count, span

# optax.adam's defaults; its eps_root is 0, which torch's Adam has no
# term for.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
REMAT_MIN_DEPTH = 17  # bench_grad.py: remat is on for depth > 16


class TrainState(NamedTuple):
    params: dict  # "group.field" -> leaf tensor that requires grad
    optimizer: torch.optim.Optimizer


def params_from_jax(params: dict, device="cpu") -> dict:
    """The JAX package's parameters (``extract_params`` there, as NumPy
    arrays under the same keys) as leaf tensors on ``device`` that
    require grad."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True)
            for k, v in params.items()}


def pixel_lanes(W: int, H: int, spp: int, device):
    """The [spp, W*H] pixel and sample ids of every camera ray."""
    pix = torch.arange(W * H, dtype=torch.int64, device=device)
    sam = torch.arange(spp, dtype=torch.int64, device=device)
    return pix.expand(spp, W * H), sam[:, None].expand(spp, W * H)


def make_radiance_fn(scene: Scene, W: int, H: int, depth: int,
                     intersector=None, leaf_size: int = 4,
                     remat: bool = False, partition: bool = False,
                     bf16_hits: bool = False):
    """radiance(params, scene_t, basis, pixel_ids, sample_ids, seed) ->
    (per-lane radiance [N, 3] with gradients to ``params``, the bound
    scene): the forward render of ``make_loss_fn``, for any lanes of the
    W x H frame (the sharded loss renders its shard's).  The modes and
    their checks: see ``make_loss_fn``.  ``bf16_hits``: the bf16
    candidate tests in sweep mode (the JAX package's
    ``make_ray_colorer(..., bf16_hits=)``): the selection is a fixed
    decision, and the selected primitive's gradients are float32's; a
    bf16 forward never partitions (``render.render_image``)."""
    mode = resolve_intersector(scene, intersector)
    schedule = None  # made at the first call, when partition engages
    engage = partition and mode == "sweep"

    def radiance(params, scene_t, basis, pixel_ids, sample_ids, seed):
        nonlocal schedule, engage
        check_upload(scene_t, mode, leaf_size)
        bf16 = bf16_hits and mode == "sweep" \
            and bf16_engages(scene_t.sweep)
        if engage and scene_t.groups and not bf16:
            if all(g.dynamic_ok for g in scene_t.groups):
                schedule = PartitionSchedule(scene_t.groups)
            else:
                get_logger().info(
                    "partition groups without boxes computable from the "
                    "parameters: the train step runs plain")
        engage = False
        bound = bind_params(scene_t, params)
        rad = render_radiance(bound, scene.background, basis, W, H,
                              pixel_ids.reshape(-1), sample_ids.reshape(-1),
                              seed, depth, remat=remat, schedule=schedule,
                              bf16_hits=bf16)
        return rad, bound

    radiance.schedule = lambda: schedule
    return radiance


def make_loss_fn(scene: Scene, W: int, H: int, depth: int,
                 intersector=None, leaf_size: int = 4, remat: bool = False,
                 silhouette: bool = False, partition: bool = False):
    """loss(params, scene_t, basis, pixel_ids, sample_ids, seed, target):
    the mean squared error between each pixel's mean radiance over the
    [S, W*H] launch and ``target`` ([W*H, 3], linear radiance, bottom-up
    rows).

    ``intersector`` / ``leaf_size``: the trace's mode, as
    ``render.prepare_scene`` resolves them; ``scene_t`` must be uploaded
    in that mode and, in BVH mode, at that leaf size (the parameters are
    then in the tree's leaf order; in cluster mode in the padded cluster
    order, NaN on the pads, whose gradients are 0), or the loss raises.
    As in the JAX package, a train step's compaction keeps launch order
    in every mode (no coherence sort).
    ``silhouette=True`` adds the edge-sampled boundary term
    (``ops/edges.py``, with the JAX package's defaults, built at the
    first call from the geometry ``scene_t`` was uploaded from), so that
    geometry gradients also see occlusion boundaries move; it needs
    ``pixel_ids`` to cover the whole frame.
    ``partition=True`` (sweep mode, a scene with partition groups) runs
    the forward's trace as the partitioned sweep (the JAX package's
    ``partition_sched``): its bounces are decided at the first call
    (``render.PartitionSchedule``) and kept, so that two calls from one
    state are bit-equal, and the groups' boxes come from the bound
    parameters of each call (``bind_params``), never stale.  If a group
    has no box computable from the parameters, the loss runs plain and
    logs it.  The loss equals the plain one bit for bit; the gradients
    part only by the order in which K3 sums a row's addends."""
    radiance = make_radiance_fn(scene, W, H, depth, intersector, leaf_size,
                                remat=remat, partition=partition)
    correction = None

    def loss_fn(params, scene_t, basis, pixel_ids, sample_ids, seed,
                target):
        nonlocal correction
        rad, bound = radiance(params, scene_t, basis, pixel_ids, sample_ids,
                              seed)
        mean_rad = rad.reshape(pixel_ids.shape[0], W * H, 3).mean(0)
        if silhouette:
            if correction is None:
                correction = make_silhouette_correction(
                    scene, W, H, depth, scene_t.host_geom)
            with span("silhouette"):
                mean_rad = mean_rad + correction(bound, basis, seed)
        return ((mean_rad - target) ** 2).mean()

    loss_fn.schedule = radiance.schedule
    return loss_fn


def make_train_step(scene: Scene, W: int, H: int, depth: int,
                    intersector=None, leaf_size: int = 4,
                    learning_rate: float = 1e-2, remat: bool = False,
                    silhouette: bool = False, partition: bool = False):
    """(init, step): ``init(scene_t)`` copies the scene's parameters into
    leaf tensors with an adam optimizer; ``step(state, scene_t, basis,
    pixel_ids, sample_ids, seed, target)`` runs the forward render, the
    backward pass and one adam update in place, and returns (state, the
    loss before the update).  The step runs in the span ``train_step``
    (``utils/profiling.py``), its parts in the spans ``forward`` (the
    correction inside it in ``silhouette``), ``backward`` and
    ``optimizer``, and counts one in ``steps``.  ``partition``: see
    ``make_loss_fn``; ``step.schedule()`` is its ``PartitionSchedule``
    once the first step made one, else None."""
    return train_step_of(make_loss_fn(scene, W, H, depth, intersector,
                                      leaf_size, remat=remat,
                                      silhouette=silhouette,
                                      partition=partition), learning_rate)


def train_step_of(loss_fn, learning_rate: float = 1e-2,
                  reduce_grads=None):
    """``make_train_step``'s (init, step) around any ``loss_fn`` of
    ``make_loss_fn``'s signature.  ``reduce_grads(params)``, when given,
    runs after the backward pass, every gradient present, and before the
    adam update (the sharded step folds its ranks' gradients there)."""

    def init(scene_t) -> TrainState:
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in extract_params(scene_t.arrays).items()}
        opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                               betas=ADAM_BETAS, eps=ADAM_EPS)
        return TrainState(params=params, optimizer=opt)

    @span("train_step")
    def step(state: TrainState, scene_t, basis, pixel_ids, sample_ids, seed,
             target):
        count("steps")
        state.optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            loss = loss_fn(state.params, scene_t, basis, pixel_ids,
                           sample_ids, seed, target)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            # A parameter the render never reads has a zero gradient, as
            # in JAX: adam counts the step for it too.
            for p in state.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if reduce_grads is not None:
                reduce_grads(state.params)
            state.optimizer.step()
        return state, loss.detach()

    step.schedule = loss_fn.schedule
    return init, step


def snapshot(state: TrainState) -> dict:
    """A copy of ``state``'s parameter values and optimizer state, for
    ``restore``."""
    return {"params": {k: p.detach().clone()
                       for k, p in state.params.items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict())}


def restore(state: TrainState, snap: dict) -> None:
    """Put ``snapshot``'s values back into ``state`` in place: the next
    step starts from the same parameters and adam moments (and step
    count) as the step after the snapshot did."""
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(snap["params"][k])
            p.grad = None
    state.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))


def main(argv=None) -> int:
    """Camera Mrays/s through a whole adam train step (forward render,
    backward pass, update), as one JSON line; the JAX package's
    ``bench_grad.py`` with the same positional arguments and defaults.
    As there, every step (the warm-up and each timed one) starts from
    the initial state: the parameters and the optimizer's state are
    restored before it, outside the timer.  The loss printed is the
    first step's, the loss at the initial parameters.  Compaction is
    always on (eager).  The trace runs partitioned by default, as
    bench_grad.py's descent does (``--no-partition`` turns it off): its
    bounces are decided by the warm-up step and kept for the timed
    ones."""
    from .models.builders import build_scene

    ap = argparse.ArgumentParser(prog="hyper_ray_tracer_tpu_torch.train")
    ap.add_argument("scene", nargs="?", default="random")
    ap.add_argument("width", nargs="?", type=int, default=400)
    ap.add_argument("height", nargs="?", type=int, default=225)
    ap.add_argument("spp", nargs="?", type=int, default=8)
    ap.add_argument("depth", nargs="?", type=int, default=8)
    ap.add_argument("--remat", action="store_true",
                    help="force per-bounce remat (auto for depth > 16): "
                         "trades recompute for backward memory")
    ap.add_argument("--intersector", default="auto",
                    choices=("auto", "sweep", "cluster", "bvh"),
                    help="the trace's mode, as the render CLI's: auto "
                         "takes the BVH from 30,000 primitives")
    ap.add_argument("--leaf-size", type=int, default=4,
                    help="primitives per BVH leaf (1-8)")
    ap.add_argument("--silhouette", action="store_true",
                    help="add the edge-sampled silhouette term to the "
                         "loss")
    ap.add_argument("--no-partition", dest="partition",
                    action="store_false", default=True,
                    help="run every bounce's sweep plain, not partitioned "
                         "(the loss is the same either way)")
    ap.add_argument("--steps", type=int, default=5,
                    help="timed steps after one warm-up step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the plain-PyTorch versions "
                         "of the kernels")
    a = ap.parse_args(argv)
    if a.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("no CUDA device is available; pass --cpu to "
                           "train on the CPU")
    W, H, spp, depth = a.width, a.height, a.spp, a.depth
    remat = a.remat or depth >= REMAT_MIN_DEPTH
    scene = build_scene(a.scene)
    arrays, structure, mode = prepare_scene(scene, a.intersector,
                                            a.leaf_size)
    scene_t = to_device(arrays, scene.static, device, structure)
    basis = make_basis(scene.camera, W, H)
    pix, sam = pixel_lanes(W, H, spp, device)
    target = torch.zeros((W * H, 3), dtype=torch.float32, device=device)
    init, step = make_train_step(scene, W, H, depth, mode, a.leaf_size,
                                 remat=remat, silhouette=a.silhouette,
                                 partition=a.partition)
    state = init(scene_t)
    start = snapshot(state)
    best = float("inf")
    for i in range(a.steps + 1):  # 0: the warm-up (kernel builds, allocator)
        restore(state, start)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, loss = step(state, scene_t, basis, pix, sam, 0, target)
        value = loss.item()
        if i == 0:
            first_loss = value
        else:
            best = min(best, time.perf_counter() - t0)
    schedule = step.schedule()
    print(json.dumps({
        "metric": f"{a.scene}_fwd_bwd_camera_mrays_per_s_depth{depth}",
        "value": W * H * spp / best / 1e6,
        "unit": "Mrays/s",
        "seconds_per_step": best,
        "loss": first_loss,
        "remat": remat,
        "intersector": mode,
        "silhouette": a.silhouette,
        "partition": schedule is not None,
        "partitioned_bounces": ([] if schedule is None else
                                [b for b, on in enumerate(schedule.decisions)
                                 if on]),
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
