"""Sharded rendering and training over a (rays, spp) mesh of ranks.

The JAX package has three sharded renderers (its ``parallel/
render_sharded.py``): ``make_pjit_renderer`` (GSPMD partitions the
wavefront), ``make_shardmap_renderer`` (explicit ``shard_map``, a
``psum`` over the spp axis) and ``make_sharded_compacting_renderer``
(dead-ray compaction inside ``shard_map``: a probe pass, static bucket
schedules, an overflow flag and a re-probe).  All three give the same
per-pixel radiance sum over a sample block.  The port compacts eagerly,
with dynamic shapes, on each rank's own lanes, so the three collapse into
``make_sharded_renderer``: each rank runs the port's render
(``render.accumulate_samples``, the loop ``render_image`` runs) on its
shard of the launch, and the ranks talk once, at the end.  The probe,
the bucket schedule, the overflow flag and the re-probe are not ported:
nothing can overflow.  The partitioned sweep's ``PartitionSchedule`` is
decided per rank from its own first chunk, which changes speed only.

Launch layout (the JAX package's ``_ids_for_block``): the ids of a
sample block are laid out [S, W*H], sample-major, and sharded
``P(spp, rays)``: mesh rank (i, j) holds the j-th contiguous range of
samples times the i-th contiguous range of pixels (``shard_lanes``).  In
cluster mode the pixels are taken in ``render.block_order`` and the sums
are put back by pixel id.

Reductions are deterministic (``collectives.py``): the spp shards' sums
are folded in rank order, then the rays shards' sums gathered, so every
rank holds the whole image.  A rays-only mesh renders every pixel's
samples exactly as ``render_image`` does, in the same chunks of the
global settings, so its image is bit-identical; an spp-sharded mesh adds
each rank's partial sums in rank order, which moves the low bits.

Training (``make_sharded_loss_fn``, ``make_sharded_train_step``): the JAX
package jits its train step with sharded ids and replicated parameters,
and autodiff inserts the ``psum``.  Here each rank renders its shard
with gradients, the spp fold is an autograd function whose gradient is
the identity, each rays shard's loss is folded into the total, and after
the backward pass every gradient is gathered in one flat buffer and
folded in rank order, so the same adam step runs on every rank and the
replicated parameters stay bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import CameraBasis
from ..models.scene import Scene
from ..ops.typed_sweep import bf16_engages
from ..render import (
    PartitionSchedule,
    RenderSettings,
    accumulate_samples,
    block_order,
    check_upload,
    resolve_intersector,
    spp_per_chunk,
)
from ..train import make_radiance_fn, train_step_of
from .collectives import all_gather, fold_sum, gather_fold
from .mesh import RenderMesh
from ..utils.profiling import host_sync


def _shard_sizes(mesh: RenderMesh, n_pix: int, n_samples: int):
    if n_pix % mesh.n_rays or n_samples % mesh.n_spp:
        raise ValueError(
            f"a {mesh.n_rays}x{mesh.n_spp} mesh needs the pixels ({n_pix}) "
            f"divisible by {mesh.n_rays} and the samples ({n_samples}) by "
            f"{mesh.n_spp}")
    return n_pix // mesh.n_rays, n_samples // mesh.n_spp


def shard_lanes(mesh: RenderMesh, rank: int, W: int, H: int, sample0: int,
                n_samples: int, lane_order=None):
    """Mesh rank ``rank``'s block of the [S, W*H] launch of the samples
    ``sample0`` .. ``sample0 + n_samples - 1``: (pixel_ids, sample_ids),
    int64 [S / n_spp, W*H / n_rays] each, as the JAX package's
    ``_ids_for_block`` sharded ``P(spp, rays)`` gives mesh device (i, j).
    ``lane_order``: the pixel of each launch column (default row-major;
    cluster mode's ``render.block_order``).  Raises ``ValueError`` unless
    the mesh's axes divide the pixels and the samples."""
    p_loc, s_loc = _shard_sizes(mesh, W * H, n_samples)
    i, j = mesh.coords(rank)
    order = (torch.arange(W * H, dtype=torch.int64) if lane_order is None
             else torch.as_tensor(np.asarray(lane_order), dtype=torch.int64))
    pix = order[i * p_loc:(i + 1) * p_loc]
    sam = sample0 + j * s_loc + torch.arange(s_loc, dtype=torch.int64)
    return pix.expand(s_loc, p_loc), sam[:, None].expand(s_loc, p_loc)


def place_pixels(n_pix: int, pixels, sums) -> torch.Tensor:
    """The [n_pix, 3] image sum with ``sums[i]`` ([P_loc, 3]) at the
    pixel ids ``pixels[i]``, for each rays shard i."""
    out = torch.zeros((n_pix, 3), dtype=sums[0].dtype,
                      device=sums[0].device)
    for pix, s in zip(pixels, sums):
        out.index_copy_(0, host_sync(pix.to(out.device)), s)
    return out


def make_sharded_renderer(scene: Scene, W: int, H: int, depth: int,
                          mesh: RenderMesh, intersector=None,
                          leaf_size: int = 4, partition: bool = True,
                          bf16_hits: bool = False):
    """run(scene_t, basis, sample0, n_samples, seed) -> the [W*H, 3]
    float32 radiance sum over the samples ``sample0`` ..
    ``sample0 + n_samples - 1``, on every rank of ``mesh``, in pixel order
    (bottom-up rows).  ``scene_t``: the scene uploaded to this rank's
    device in the mode ``intersector`` / ``leaf_size`` resolve to
    (``render.prepare_scene``, ``scene_tensors.to_device``).  Each rank
    traces its shard (``shard_lanes``) in chunks of
    ``render.spp_per_chunk`` of the global settings (W x H x
    ``n_samples``), as ``render_image`` would, not of its own share of the
    pixels, and adds each pixel's samples in turn as ``render_image``
    does (``render.accumulate_samples``).
    ``partition``: the partitioned sweep, decided by this rank's first
    chunk (``render.PartitionSchedule``).  ``bf16_hits``: the bf16
    candidate tests in sweep mode (``RenderSettings.bf16_hits``), never
    partitioned, as in ``render_image``, so each lane's the same as
    there.

    ``run.local(scene_t, basis, sample0, n_samples, seed, rank)``: mesh
    rank ``rank``'s own sum, [W*H / n_rays, 3] in the order of its
    pixels (``shard_lanes``), with no collective: ``run`` folds these
    over the spp axis in rank order and puts each rays shard's at its
    pixels (``place_pixels``)."""
    mode = resolve_intersector(scene, intersector)
    coherent = mode == "cluster"
    lane_order = block_order(W, H) if coherent else None
    schedule = None

    def local(scene_t, basis: CameraBasis, sample0: int, n_samples: int,
              seed: int, rank: int) -> torch.Tensor:
        nonlocal schedule
        check_upload(scene_t, mode, leaf_size)
        bf16 = bf16_hits and mode == "sweep" \
            and bf16_engages(scene_t.sweep)
        if schedule is None and partition and mode == "sweep" \
                and scene_t.groups and not bf16:
            schedule = PartitionSchedule(scene_t.groups)
        pixel_ids, sample_ids = shard_lanes(mesh, rank, W, H, sample0,
                                            n_samples, lane_order)
        device = scene_t.fpack.device
        pix = host_sync(pixel_ids[0].to(device))
        s0, s_loc = int(sample_ids[0, 0]), sample_ids.shape[0]
        chunk = spp_per_chunk(RenderSettings(W, H, n_samples, depth))
        acc = torch.zeros((pix.numel(), 3), dtype=torch.float32,
                          device=device)
        for _ in accumulate_samples(acc, scene_t, scene.background, basis, W,
                                    H, pix, s0, s0 + s_loc, chunk, seed,
                                    depth, coherent=coherent,
                                    schedule=schedule, bf16_hits=bf16):
            pass
        return acc

    def run(scene_t, basis: CameraBasis, sample0: int, n_samples: int,
            seed: int) -> torch.Tensor:
        rank = mesh.rank
        if rank is None:
            raise RuntimeError("make_sharded_renderer: this process is not "
                               "a rank of the mesh")
        total = gather_fold(local(scene_t, basis, sample0, n_samples, seed,
                                  rank), mesh.spp_group(rank))
        sums = all_gather(total, mesh.rays_group(rank))
        pixels = [shard_lanes(mesh, i * mesh.n_spp, W, H, sample0,
                              n_samples, lane_order)[0][0]
                  for i in range(mesh.n_rays)]
        return place_pixels(W * H, pixels, sums)

    run.local = local
    run.schedule = lambda: schedule
    return run


def gather_image(radiance_sum, samples: int, W: int, H: int) -> np.ndarray:
    """The sharded renderer's sum -> the host image (gamma, top-down
    rows), on every rank: ``run`` has already gathered the whole
    [W*H, 3] sum (the JAX package's ``process_allgather``), so this is a
    copy to the host and ``finish_image``."""
    acc = host_sync(radiance_sum.detach().cpu()).numpy().astype(np.float64)
    return finish_image(acc, samples, W, H)


def finish_image(acc: np.ndarray, samples: int, W: int, H: int
                 ) -> np.ndarray:
    """The JAX package's assembly math: the average in float64, the
    sqrt-gamma (application.rs:451-453), bottom-up rows -> top-down.
    (``render.gamma_image`` finishes ``render_image``'s float32
    accumulator in float32; the two may part by an ulp.)"""
    img = np.sqrt(np.maximum(acc / samples, 0.0)).astype(np.float32)
    return img.reshape(H, W, 3)[::-1]


def make_sharded_loss_fn(scene: Scene, W: int, H: int, depth: int,
                         mesh: RenderMesh, intersector=None,
                         leaf_size: int = 4, remat: bool = False,
                         silhouette: bool = False, partition: bool = False):
    """``train.make_loss_fn`` over ``mesh``: loss(params, scene_t, basis,
    pixel_ids, sample_ids, seed, target) with the whole [S, W*H] launch
    and the whole [W*H, 3] target on every rank; each rank renders its
    block of the launch (sharded ``P(spp, rays)``, as ``shard_lanes``).

    A rays shard's loss: the per-pixel sum of its spp shards (folded in
    rank order by an autograd function whose gradient is the identity)
    over S, less the target, squared, summed over the shard and divided
    by the whole target's size; the loss is the fold of the rays shards'
    losses (the same autograd fold), the same value on every rank.
    ``backward`` leaves on each rank the gradient through its own
    samples; ``reduce_gradients`` folds them into the whole gradient.
    ``silhouette=True`` raises ``NotImplementedError``: the correction
    needs the whole frame (``make_loss_fn``), and the JAX package never
    shards it."""
    if silhouette:
        raise NotImplementedError(
            "make_sharded_loss_fn: the silhouette term needs the whole "
            "frame on one rank; train it with train.make_loss_fn")
    radiance = make_radiance_fn(scene, W, H, depth, intersector, leaf_size,
                                remat=remat, partition=partition)

    def loss_fn(params, scene_t, basis, pixel_ids, sample_ids, seed,
                target):
        rank = mesh.rank
        if rank is None:
            raise RuntimeError("make_sharded_loss_fn: this process is not a "
                               "rank of the mesh")
        S, n_pix = pixel_ids.shape
        p_loc, s_loc = _shard_sizes(mesh, n_pix, S)
        i, j = mesh.coords(rank)
        rows = slice(j * s_loc, (j + 1) * s_loc)
        cols = slice(i * p_loc, (i + 1) * p_loc)
        rad, _ = radiance(params, scene_t, basis, pixel_ids[rows, cols],
                          sample_ids[rows, cols], seed)
        part = rad.reshape(s_loc, p_loc, 3).sum(0)
        mean_rad = fold_sum(part, mesh.spp_group(rank)) / S
        shard_loss = ((mean_rad - target[cols]) ** 2).sum() / target.numel()
        return fold_sum(shard_loss, mesh.rays_group(rank))

    loss_fn.schedule = radiance.schedule
    return loss_fn


def reduce_gradients(params: dict, mesh: RenderMesh) -> None:
    """Replace each parameter's gradient by the fold, in rank order, of
    every mesh rank's: one all-gather of one flat buffer of all of them.
    Every gradient must be present (zeros where the render never read the
    parameter)."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in params.values()]
    total = gather_fold(torch.cat([g.reshape(-1) for g in grads]),
                        mesh.group)
    for p, g in zip(params.values(), total.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def make_sharded_train_step(scene: Scene, W: int, H: int, depth: int,
                            mesh: RenderMesh, intersector=None,
                            leaf_size: int = 4, learning_rate: float = 1e-2,
                            remat: bool = False, silhouette: bool = False,
                            partition: bool = False):
    """``train.make_train_step`` over ``mesh``: (init, step) with the same
    arguments, the loss ``make_sharded_loss_fn``'s, and the gradients
    folded over the mesh (``reduce_gradients``) before the adam update,
    so that every rank takes the same step."""
    loss_fn = make_sharded_loss_fn(scene, W, H, depth, mesh, intersector,
                                   leaf_size, remat=remat,
                                   silhouette=silhouette,
                                   partition=partition)
    return train_step_of(loss_fn, learning_rate,
                         reduce_grads=lambda params: reduce_gradients(
                             params, mesh))
