"""Wavefront path tracer on torch tensors, with dead-ray compaction.

The reference integrator is a per-pixel recursion (application.rs:477-495):

    ray_color(ray, depth) =
        depth == 0            -> black
        miss                  -> background
        scatter() == None     -> emitted
        else                  -> emitted + attenuation * ray_color(scattered)

Here it is a loop over ``depth`` bounces carrying the whole ray wavefront
(``WavefrontState``); the algebra

    radiance += throughput * (miss ? background : emitted)
    throughput *= attenuation            (only while scattering continues)

telescopes to the recursion.  It follows the JAX package's ``render.py``
(``init_state`` :335-361, ``bounce_step`` :363-455, ``render_image``
:1459-1672).

``render_radiance`` is the differentiable form a train step runs: each
bounce traces its rays with the gradient stopped (the sweep kernels are
discrete searches) and recomputes the winner's hit distance in plain
torch, so that gradients reach the geometry through t, the hit point
and everything shaded from it.

The trace step has three modes (``resolve_intersector``): the all-pairs
sweeps; BVH mode, the walk of a skip-threaded BVH over the geometry
reordered into its leaves; and cluster mode, the sweep of spatial
clusters culled by their boxes over the geometry in padded cluster order
(``prepare_scene``; the JAX package's ``render.py:119-151, 547-575``).
A render in cluster mode launches its camera rays in image blocks
(``block_order``) and orders each compaction's survivors by the
coherence key (``ops/cluster_sweep.make_coherence_key``), as the JAX
package does, so that neighbouring lanes share clusters; both are pure
permutations, and the image is bit-identical to launch order.

Compaction is eager: after every bounce, each lane's radiance is written to
its launch slot, and only the ``alive.nonzero()`` lanes, in launch order,
go on to the next bounce.  Every lane carries its own RNG base and shutter
time, so dropping finished lanes changes no lane's result.

The partitioned sweep (``RenderSettings.partition``, ``PartitionSchedule``;
the JAX package's ``render.py:812-1131``, ``ops/partition.py``): in sweep
mode, on a bounce that pays, the lanes go on in the order of their
group-overlap category, and the sweep folds each partition group's
primitives only into the lanes whose segment may meet its box.  The test
is conservative and the kernels exact, so the image is bit-identical to
the plain sweep's (the JAX package's only statistically).

Tracing (``utils/profiling.py``): an image runs in the span
``render_image``, inside it ``prepare`` (the scene's host arrays),
``upload``, the chunks' layers ``raygen``, ``trace``, ``shade`` and
``compaction`` (the partition's ``partition_mask`` and ``partition_sort``
inside it), ``snapshot`` and ``finish`` (the readback); a profile of a
render attributes its device time to them.  ``images`` and
``camera_rays`` count the work, ``syncs`` each place the host waits for
the card.  With no profiler active a span costs the host well under a
microsecond, against the few microseconds of each of a bounce's eager
operations.

Shading (``shade_hits``) has two paths that share no logic: a
forward-only wavefront on the card runs the fused kernel K6
(``ops/shade.py``), one launch a bounce; the CPU and every call that
needs autograd's graph (the train step) run the eager operations of
``ops/intersect.py``, ``ops/textures.py`` and ``ops/materials.py``,
which are K6's twin on the card, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .camera import CameraBasis, get_rays, make_basis
from .models.bvh_build import build_bvh
from .models.clusters import build_clusters
from .models.scene import Scene
from .ops import rng as prng
from .ops.bvh import MAX_LEAF_SIZE, bvh_traverse
from .ops.cluster_sweep import cluster_sweep
from .ops.intersect import (
    BIG,
    gather_prim_shade_packed,
    hit_detail,
    prim_hit_t_lanes,
)
from .ops import partition
from .ops.materials import shade
from .ops.math import div_rn
from .ops.shade import shade_lanes
from .ops.sphere_sweep import sphere_sweep
from .ops.typed_sweep import bf16_engages, typed_sweep
from .scene_tensors import SceneTensors, to_device
from .utils import checkpoint as ckpt
from .utils.image import write_png
from .utils.logging import get as get_logger
from .utils.profiling import count, host_sync, since, snapshot, span

T_MIN = 1.0e-3  # application.rs:482 (float32-rounded where it is compared)

# Gradient sky for scenes whose background is None (the book's sky).
_SKY_WHITE = (1.0, 1.0, 1.0)
_SKY_BLUE = (0.5, 0.7, 1.0)

# Camera rays per chunk when RenderSettings.spp_chunk is None.  A lane's
# state is ~70 bytes and one bounce's eager temporaries (RNG words, shading
# vectors, the winner's joined row) add a few hundred more: 2**23 lanes
# (9 spp at 1280x720) peaked at 4.2 GB on an H100 80GB, far inside its
# memory, while every elementwise launch of the first bounces still covers
# millions of lanes.
CHUNK_LANES = 1 << 23

# The estimator's realization, part of a checkpoint's identity: bumped
# whenever a change alters the rendered values for a fixed seed, so that
# a stale accumulator is refused instead of blended.  It is not the JAX
# package's RENDER_FORMAT_VERSION (an int): the two estimators part on
# some lanes (tests/test_torch_render.py), so a checkpoint of one is
# never resumed by the other.
RENDER_FORMAT = "torch-1"

# Primitives from which auto leaves the sweep: the JAX package's
# AUTO_CLUSTER_MIN_PRIMS.  The JAX package takes its cluster intersector
# there; the port takes the BVH (K4) until its benchmark decides between
# the two on the card (ROADMAP queue 1, item 6).
AUTO_MIN_PRIMS = 30_000


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int
    height: int
    samples: int
    depth: int
    seed: int = 0
    spp_chunk: Optional[int] = None  # samples per pass (None: CHUNK_LANES)
    # None / 'auto' / True / 'sweep' / 'cluster' / 'bvh'
    # (resolve_intersector).
    intersector: Union[None, bool, str] = None
    leaf_size: int = 4  # primitives per BVH leaf, 1..MAX_LEAF_SIZE
    checkpoint_path: Optional[str] = None  # resumes from it if it exists
    preview_path: Optional[str] = None  # progressive PNG
    # Chunks between snapshots (checkpoint and preview; None: every chunk
    # with a preview, else every 8), plus the final one.
    snapshot_every: Optional[int] = None
    # Dead-ray compaction, taken for the JAX package's field (None auto,
    # False its fixed-width scan, which XLA's static shapes need): the port
    # always compacts, and the JAX package's image is the same either way.
    compaction: Optional[bool] = None
    # bf16 candidate hit tests (sweep mode; ``ops/typed_sweep.py``'s bf16
    # form): the plan tiles of static, untransformed spheres pick their
    # winner in bfloat16, whose t is then recomputed in float32.  Renders
    # are no longer bit-identical to float32 (near ties and silhouettes);
    # a bf16 render never partitions (a bf16 hit may lie outside a group's
    # float32 box, so the partition would change it); BVH and cluster mode
    # ignore it.
    bf16_hits: bool = False
    # The partitioned sweep (ops/partition.py; PartitionSchedule): in sweep
    # mode, on a scene with partition groups, the bounces whose wavefront
    # has at least PART_MIN_LANES lanes and skips at least PART_SAVED_MIN
    # of the pairs order their lanes by group overlap and fold each
    # group's primitives only into the lanes that may meet it.  The image
    # is bit-identical either way; False runs every bounce plain.
    partition: bool = True


class WavefrontState(NamedTuple):
    """Bounce-loop carry; every field is per lane."""

    o: torch.Tensor  # [M,3] origin
    d: torch.Tensor  # [M,3] direction (unnormalised, like the reference)
    time: torch.Tensor  # [M] shutter time
    base: torch.Tensor  # [M] int64 per-(pixel,sample) RNG base word
    alive: torch.Tensor  # [M] bool
    throughput: torch.Tensor  # [M,3]
    radiance: torch.Tensor  # [M,3]


def init_state(basis: CameraBasis, width: int, height: int, pixel_ids,
               sample_ids, seed: int) -> WavefrontState:
    """Camera-ray wavefront for ``pixel_ids`` / ``sample_ids`` ([N] int64;
    pixel rows count from the bottom)."""
    base = prng.ray_base(seed, pixel_ids, sample_ids)
    x = (pixel_ids % width).to(torch.float32)
    y = (pixel_ids // width).to(torch.float32)
    ju = prng.uniform(base, prng.P_CAM_JITTER_U)
    jv = prng.uniform(base, prng.P_CAM_JITTER_V)
    # application.rs:443-446, divided on the card as on the CPU (div_rn)
    s = div_rn(x + ju, float(np.float32(width - 1)))
    t = div_rn(y + jv, float(np.float32(height - 1)))
    o, d, time = get_rays(basis, base, s, t)
    return WavefrontState(
        o=o, d=d, time=time, base=base,
        alive=torch.ones_like(time, dtype=torch.bool),
        throughput=torch.ones_like(o),
        radiance=torch.zeros_like(o),
    )


def resolve_intersector(scene: Scene, intersector) -> str:
    """Map a ``RenderSettings.intersector`` value to a mode, as the JAX
    package's ``resolve_intersector`` does: 'sweep', 'cluster' and 'bvh'
    are forced, True means 'bvh', False, None and 'auto' are auto.  Auto
    traces with the sweeps below ``AUTO_MIN_PRIMS`` primitives (every
    reference scene) and with the BVH from there (where the JAX package
    takes its cluster intersector)."""
    if isinstance(intersector, str):
        if intersector in ("sweep", "cluster", "bvh"):
            return intersector
        if intersector != "auto":
            raise ValueError(f"unknown intersector {intersector!r}")
    elif intersector is True:
        return "bvh"
    elif intersector not in (None, False):
        raise ValueError(f"unknown intersector {intersector!r}")
    return "bvh" if scene.static.n_prims >= AUTO_MIN_PRIMS else "sweep"


@span("prepare")
def prepare_scene(scene: Scene, intersector=None, leaf_size: int = 4):
    """Resolve the intersector mode and produce the arrays it traces:
    (arrays, structure, mode).  In BVH mode ``arrays`` holds the geometry
    reordered into leaf order and the structure is the tree
    (``models/bvh_build.build_bvh``); in cluster mode the geometry in
    padded cluster order and the layout (``models/clusters.
    build_clusters``); otherwise ``arrays`` is the scene's and the
    structure None.  ``scene_tensors.to_device(arrays, static, device,
    structure)`` uploads them."""
    mode = resolve_intersector(scene, intersector)
    if mode == "sweep":
        return scene.arrays, None, mode
    if mode == "cluster":
        geom, layout = build_clusters(scene.arrays.geom,
                                      scene.static.n_prims)
        return scene.arrays._replace(geom=geom), layout, mode
    if not 1 <= leaf_size <= MAX_LEAF_SIZE:
        raise ValueError(f"leaf_size {leaf_size} is outside 1.."
                         f"{MAX_LEAF_SIZE}")
    bvh, geom = build_bvh(scene.arrays.geom, leaf_size=leaf_size)
    return scene.arrays._replace(geom=geom), bvh, mode


def check_upload(scene: SceneTensors, mode: str, leaf_size: int) -> None:
    """Raise ``ValueError`` unless ``scene`` was uploaded in ``mode``
    (``prepare_scene``'s) and, in BVH mode, at ``leaf_size``."""
    if scene.mode != mode:
        raise ValueError(f"the scene is uploaded in {scene.mode} mode, the "
                         f"trace runs in {mode} mode")
    if mode == "bvh" and scene.bvh.leaf_size != leaf_size:
        raise ValueError(f"the scene is uploaded at leaf size "
                         f"{scene.bvh.leaf_size}, the trace's is {leaf_size}")


def block_order(width: int, height: int, block_w: int = 64,
                block_h: int = 32) -> np.ndarray:
    """Pixel launch permutation of cluster mode (the JAX package's
    ``block_order``): ``perm[lane] = pixel_id``, the lanes walking 64x32
    image blocks, so that neighbouring lanes' camera rays form a narrow
    frustum and meet the same clusters.  Every ray's RNG words are keyed
    by its pixel, so the image is bit-identical to row-major order."""
    x = np.arange(width)
    y = np.arange(height)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    pid = (yy * width + xx).ravel()
    key = ((yy // block_h) * (-(-width // block_w)) + (xx // block_w)).ravel()
    return pid[np.argsort(key, kind="stable")].astype(np.int32)


def trace(scene: SceneTensors, state: WavefrontState, bb, mask=None,
          bf16: bool = False):
    """The trace step: each lane's closest hit (t, primitive index; BIG
    and -1 for a miss or a dead lane).  A scene in BVH mode walks its
    tree (K4), one in cluster mode sweeps its clusters (K5); otherwise
    sphere-only scenes go through the sphere sweep (K1), every other
    scene through the typed sweep (K1b).  Media draw their free flight
    from the bounce words ``bb``.  ``mask`` (uint8 [N],
    ``ops/partition.group_mask``): the sweeps' partitioned form over the
    scene's groups; BVH and cluster mode have none.  ``bf16``: in sweep
    mode, on a scene with a bf16 tile (``bf16_engages``), K1b's bf16 form,
    sphere-only scenes included; otherwise ignored."""
    if mask is not None and scene.mode != "sweep":
        raise ValueError(f"{scene.mode} mode has no partitioned form")
    if scene.mode == "bvh":
        return bvh_traverse(scene.bvh, state.o, state.d, state.time,
                            state.alive, bb, T_MIN)
    if scene.mode == "cluster":
        return cluster_sweep(scene.cluster, state.o, state.d, state.time,
                             state.alive, bb, T_MIN)
    if bf16 and bf16_engages(scene.sweep):
        return typed_sweep(scene.sweep, state.o, state.d, state.time,
                           state.alive, bb, T_MIN, mask=mask, bf16=True)
    if scene.sphere_only:
        return sphere_sweep(*scene.spheres, state.o, state.d, state.time,
                            state.alive, T_MIN, mask=mask,
                            groups=scene.groups if mask is not None else ())
    return typed_sweep(scene.sweep, state.o, state.d, state.time,
                       state.alive, bb, T_MIN, mask=mask)


def fused_shading(state: WavefrontState, scene: SceneTensors, t_hit,
                  differentiable: bool) -> bool:
    """Whether ``shade_hits`` takes K6 (``ops/shade.py``): a wavefront on
    the card whose shading needs no graph, i.e. not ``differentiable``
    and, with grad enabled, no input requiring grad.  Everything else
    takes the eager path, which autograd differentiates and the CPU
    runs."""
    if state.o.device.type != "cuda" or differentiable:
        return False
    return not (torch.is_grad_enabled() and any(
        x.requires_grad for x in (*state, t_hit, scene.fpack,
                                  scene.tables.images)))


def recomputed_t(scene: SceneTensors, pf, state: WavefrontState, bb, t_hit,
                 differentiable: bool):
    """The winner's t recomputed from its gathered fields ``pf`` (with
    gradients only if ``differentiable``).  For the winner the closed
    form gives the trace's t (in float32 after a bf16 selection); a
    grazing hit can recompute to a miss (the discriminant rounds to the
    other side of 0): it keeps the trace's t, gradient-free."""
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        t_re = prim_hit_t_lanes(pf, state.o, state.d, state.time, T_MIN,
                                BIG, bb, scene.static)
    return torch.where(t_re < 0.5 * BIG, t_re, t_hit)


def shade_hits(scene: SceneTensors, background, state: WavefrontState, bb,
               t_hit, prim, differentiable: bool = False,
               bf16_hits: bool = False) -> WavefrontState:
    """The rest of a bounce after the trace: background on misses, the
    winner's row gather, hit detail, textures and materials, and the
    radiance / throughput update.  ``differentiable``: recompute the
    winner's t from its gathered fields (the JAX package's
    ``render.py:420-441``), so that t carries gradients.  ``bf16_hits``
    (sweep mode): recompute it too, without gradients unless
    ``differentiable``, so that a winner picked in bf16 is shaded at its
    float32 t (the JAX package's ``render.py:423``).

    Two paths that share no logic: where ``fused_shading`` holds, one
    launch of K6 (``ops/shade.py``; a bf16 winner's t first recomputed
    by ``recomputed_t``, as on the eager path), else the eager operations
    below.  Both count their lanes in ``shade.lanes``."""
    count("shade.lanes", state.o.shape[0])
    if fused_shading(state, scene, t_hit, differentiable):
        if bf16_hits and scene.mode == "sweep":
            with torch.no_grad():
                pf, _ = gather_prim_shade_packed(
                    scene.fpack, scene.ipack, torch.clamp(prim, min=0).long(),
                    scene.static)
            t_hit = recomputed_t(scene, pf, state, bb, t_hit, False)
        o, d, alive, throughput, radiance = shade_lanes(
            scene, state.o, state.d, state.time, bb, t_hit, prim,
            state.alive, state.throughput, state.radiance, background,
            (_SKY_WHITE, _SKY_BLUE))
        return state._replace(o=o, d=d, alive=alive, throughput=throughput,
                              radiance=radiance)
    static = scene.static
    o, d, time = state.o, state.d, state.time
    alive, throughput, radiance = state.alive, state.throughput, \
        state.radiance
    hit = prim >= 0

    if background is None:  # gradient sky
        unit_y = d[:, 1] / torch.sqrt((d * d).sum(-1))
        sky_t = (0.5 * (unit_y + 1.0))[:, None]
        bg = (1.0 - sky_t) * host_sync(d.new_tensor(_SKY_WHITE)) \
            + sky_t * host_sync(d.new_tensor(_SKY_BLUE))
    else:
        bg = host_sync(d.new_tensor(background))
    miss = alive & ~hit
    radiance = radiance + torch.where(miss[:, None], throughput * bg, 0.0)

    pidx = torch.clamp(prim, min=0).long()
    pf, sf = gather_prim_shade_packed(scene.fpack, scene.ipack, pidx,
                                      static)
    if differentiable or (bf16_hits and scene.mode == "sweep"):
        t_hit = recomputed_t(scene, pf, state, bb, t_hit, differentiable)
    # Miss lanes take a finite 1.0: with BIG the hit point overflows, and
    # 0 * inf in a VJP is NaN.
    t_use = torch.where(hit, t_hit, 1.0)
    det = hit_detail(pf, o, d, time, t_use, static)
    sc = shade(sf, det, d, bb, static, scene.tables)

    contrib = alive & hit
    radiance = radiance + torch.where(contrib[:, None],
                                      throughput * sc.emitted, 0.0)
    alive = contrib & sc.did_scatter
    throughput = torch.where(alive[:, None], throughput * sc.attenuation,
                             throughput)
    o = torch.where(alive[:, None], det.point, o)
    d = torch.where(alive[:, None], sc.direction, d)
    return state._replace(o=o, d=d, alive=alive, throughput=throughput,
                          radiance=radiance)


def bounce_step(scene: SceneTensors, background, state: WavefrontState,
                bounce_idx: int, differentiable: bool = False, mask=None,
                bf16_hits: bool = False) -> WavefrontState:
    """One wavefront bounce (the JAX ``bounce_step``).  ``differentiable``:
    trace the detached rays with no graph, then recompute the winner's t
    with gradients (``shade_hits``).  ``mask``: the lanes' group masks
    of a partitioned bounce (``trace``).  ``bf16_hits``: the bf16
    candidate tests (``trace``, ``shade_hits``)."""
    with span("trace"):
        bb = prng.bounce_base(state.base, bounce_idx)
        if differentiable:
            with torch.no_grad():
                t_hit, prim = trace(scene, state._replace(
                    o=state.o.detach(), d=state.d.detach()), bb, mask,
                    bf16_hits)
        else:
            t_hit, prim = trace(scene, state, bb, mask, bf16_hits)
    with span("shade"):
        return shade_hits(scene, background, state, bb, t_hit, prim,
                          differentiable, bf16_hits)


class PartitionSchedule:
    """Which bounces of a render (or of a train step's forward) run the
    partitioned sweep (``ops/partition.py``), decided once, as the JAX
    package's probe decides (``schedule_from_cat_counts``): the first
    wavefront traced with it (the probe) computes each bounce's category
    counts, bounce 0's from the camera rays and bounce b + 1's from the
    lanes alive after bounce b, and decides each bounce by
    ``partition.worth``; every later wavefront reuses the decisions, and
    computes no mask for a bounce that runs plain.  The decisions change
    speed only: a partitioned bounce returns what a plain one does.

    ``decisions``: a bool per bounce once the probe ran, else None;
    ``counts``: the probe's category counts by bounce (None for a
    bounce whose wavefront was below ``PART_MIN_LANES``, which runs plain
    and computes no mask, or that had no lanes left)."""

    def __init__(self, groups):
        self.groups = tuple(groups)
        self.decisions = None
        self.counts = None

    def lanes(self, scene: SceneTensors, o, d, bounce: int, probe: bool):
        """The partitioned layout of the wavefront (o, d) for ``bounce``:
        (order, mask) with ``order`` the stable category sort of its
        lanes and ``mask`` their group masks in that order, or (None,
        None) when the bounce runs plain.  ``probe``: decide it now."""
        if probe:
            n = o.shape[0]
            if n < partition.PART_MIN_LANES:
                self.counts.append(None)
                self.decisions.append(False)
                return None, None
        elif not self.decisions[bounce]:
            return None, None
        with span("partition_mask"):
            with torch.no_grad():
                mask = partition.group_mask(self.groups, o.detach(),
                                            d.detach(), scene.group_aabbs)
                cat = partition.category(mask, len(self.groups))
            if probe:
                counts = host_sync(torch.bincount(
                    cat, minlength=1 << len(self.groups)))
                counts = host_sync(counts.cpu()).numpy()
                self.counts.append(counts.tolist())
                self.decisions.append(partition.worth(
                    counts, self.groups, scene.static.n_prims))
                if not self.decisions[-1]:
                    return None, None
        with span("partition_sort"):
            order = torch.sort(cat, stable=True).indices
            return order, mask[order].contiguous()


def trace_paths(scene: SceneTensors, background, basis: CameraBasis,
                width: int, height: int, pixel_ids, sample_ids, seed: int,
                depth: int, differentiable: bool = False,
                remat: bool = False, coherent: bool = False,
                schedule: Optional[PartitionSchedule] = None,
                bf16_hits: bool = False):
    """Per-lane radiance [N,3] (pre-gamma, pre-averaging) of the camera
    rays (pixel_ids[i], sample_ids[i]), in launch order, with dead lanes
    compacted out after every bounce.  ``differentiable``, ``remat``,
    ``coherent``, ``schedule`` and ``bf16_hits``: see ``render_radiance``
    and ``bounce_paths``."""
    with span("raygen"):
        state = init_state(basis, width, height, pixel_ids, sample_ids,
                           seed)
    return bounce_paths(scene, background, state, depth, differentiable,
                        remat, coherent, schedule, bf16_hits)


def bounce_paths(scene: SceneTensors, background, state: WavefrontState,
                 depth: int, differentiable: bool = False,
                 remat: bool = False, coherent: bool = False,
                 schedule: Optional[PartitionSchedule] = None,
                 bf16_hits: bool = False):
    """Per-lane radiance [N,3] of the wavefront ``state`` after ``depth``
    bounces numbered from 0, in ``state``'s lane order: the JAX package's
    ``bounce_scan(arrays, bvh, state, 0, depth)``, for a wavefront built
    from any rays (the silhouette correction's probes start at film
    points, lens points and shutter times of their own).  Dead lanes are
    compacted out after every bounce; each lane carries its own RNG base
    and time, so this equals the fixed-width loop bit for bit.
    ``coherent`` (cluster mode's render): the survivors go on in the
    order of their coherence key (one stable sort; the JAX package's
    ``compact_wavefront_sorted``), not in launch order; the result is the
    same, lane for lane.  ``schedule`` (sweep mode, a scene with
    partition groups): the partitioned sweep (``PartitionSchedule``); on
    a bounce that partitions, the wavefront goes on in stable category
    order (one permutation, as the coherence sort; bounce 0's camera
    rays included) and the sweep reads each lane's group mask; on the
    other bounces the survivors stay in launch order.  The result is the
    same, lane for lane.  A wavefront whose schedule is not decided yet
    is its probe.  ``bf16_hits``: the bf16 candidate tests
    (``bounce_step``)."""
    key = scene.cluster.key if coherent and scene.cluster is not None \
        else None
    if schedule is not None and key is not None:
        raise ValueError("cluster mode has no partitioned form")
    out = state.radiance.clone()
    slot = torch.arange(state.o.shape[0], device=state.o.device)
    probe = schedule is not None and schedule.decisions is None
    if probe:
        schedule.decisions, schedule.counts = [], []
    mask = None
    if schedule is not None:
        with span("compaction"):
            order, mask = schedule.lanes(scene, state.o, state.d, 0, probe)
            if order is not None:
                state = WavefrontState(*(x.index_select(0, order)
                                         for x in state))
                slot = slot[order]
    for bounce in range(depth):
        if remat:
            state = checkpoint(bounce_step, scene, background, state, bounce,
                               differentiable, mask, bf16_hits,
                               use_reentrant=False)
        else:
            state = bounce_step(scene, background, state, bounce,
                                differentiable, mask, bf16_hits)
        with span("compaction"):
            # A lane's radiance no longer changes once it is dead, so the
            # value written here is final for every lane that stops now.
            out.index_copy_(0, slot, state.radiance)
            keep = host_sync(state.alive.nonzero()).squeeze(1)  # in order
            if keep.numel() == 0:
                break
            order = mask = None
            if schedule is not None and bounce + 1 < depth:
                order, mask = schedule.lanes(
                    scene, state.o.index_select(0, keep),
                    state.d.index_select(0, keep), bounce + 1, probe)
                if order is not None:
                    keep = keep[order]
            if key is not None:
                k = key(state.o.index_select(0, keep),
                        state.d.index_select(0, keep))
                keep = keep[torch.sort(k, stable=True).indices]
            if (key is not None or order is not None
                    or keep.numel() < slot.numel()):
                # index_select: its backward is index_add_, exact here
                # because ``keep`` is unique: each lane's gradient is one
                # addend onto 0, whatever the atomics' order
                # (tests/test_torch_gather.py
                # test_compaction_gather_backward_is_exact).
                state = WavefrontState(*(x.index_select(0, keep)
                                         for x in state))
                slot = slot[keep]
    if probe:  # the bounces the wavefront never reached run plain
        schedule.decisions += [False] * (depth - len(schedule.decisions))
        schedule.counts += [None] * (depth - len(schedule.counts))
    return out


def render_radiance(scene: SceneTensors, background, basis: CameraBasis,
                    width: int, height: int, pixel_ids, sample_ids,
                    seed: int, depth: int, remat: bool = False,
                    schedule: Optional[PartitionSchedule] = None,
                    bf16_hits: bool = False):
    """Per-lane radiance [N,3] with gradients to the scene's parameters
    (bind them with ``scene_tensors.bind_params``): ``trace_paths`` with
    differentiable bounces.  Compaction stays eager: ``index_copy_`` and
    the gathers of the surviving lanes are differentiable, so the
    gradients equal those of a fixed-width loop over every lane.

    ``remat``: keep only each bounce's input state for the backward pass
    and recompute the bounce there (``torch.utils.checkpoint``; the JAX
    package's ``jax.checkpoint`` at ``render.py:457-466``).  The
    counter-based RNG and the deterministic kernels make the recompute
    exact.  ``schedule``: the partitioned sweep (``bounce_paths``), the
    groups' boxes the scene's ``group_aabbs`` (``bind_params`` computes
    them from the bound parameters).  ``bf16_hits``: the bf16 candidate
    tests; the selection is then a fixed decision, and the selected
    primitive gets float32 gradients through the recompute."""
    return trace_paths(scene, background, basis, width, height, pixel_ids,
                       sample_ids, seed, depth, differentiable=True,
                       remat=remat, schedule=schedule, bf16_hits=bf16_hits)


def gamma_image(acc: np.ndarray, samples: int, W: int, H: int) -> np.ndarray:
    """sqrt-gamma (application.rs:451-453), bottom-up rows -> top-down:
    ``render_image``'s finish of its float32 accumulator."""
    img = np.sqrt(np.maximum(acc / samples, 0.0)).astype(np.float32)
    return img.reshape(H, W, 3)[::-1]


def spp_per_chunk(settings: RenderSettings) -> int:
    """Samples per chunk: ``spp_chunk``, else as many as fit
    ``CHUNK_LANES``; with a preview and no ``spp_chunk``, at most an
    eighth of the samples, so that the preview refreshes at least 8
    times (the JAX package's ``render.py:1485-1493``)."""
    if settings.spp_chunk is not None:
        return max(1, min(settings.samples, settings.spp_chunk))
    lanes = settings.width * settings.height
    chunk = max(1, min(settings.samples, CHUNK_LANES // max(lanes, 1)))
    if settings.preview_path:
        chunk = max(1, min(chunk, settings.samples // 8))
    return chunk


def accumulate_samples(acc, scene: SceneTensors, background,
                       basis: CameraBasis, width: int, height: int, pix,
                       sample0: int, samples: int, chunk: int, seed: int,
                       depth: int, coherent: bool = False,
                       schedule: Optional[PartitionSchedule] = None,
                       bf16_hits: bool = False):
    """Trace the camera rays of the lanes ``pix`` (pixel ids, int64 [n] on
    the scene's device) for the samples ``sample0`` .. ``samples - 1``,
    ``chunk`` samples at a time (lane = sample * n + i traces pixel
    ``pix[i]``), and add each lane's radiance to ``acc[i]`` ([n, 3]
    float32, in place); a generator that yields the samples done after
    every chunk.  ``coherent``, ``schedule`` and ``bf16_hits``: see
    ``bounce_paths``.

    The samples go into ``acc`` one after the other, so that every
    pixel's sum is the same left-to-right fold of its samples whatever
    the chunk boundaries and the number of lanes: torch's ``sum(0)``
    orders its adds by the shape of what it reduces.  ``render_image``
    and the sharded renderer (``parallel/render_sharded.py``) share this
    loop."""
    n = pix.numel()
    s = sample0
    while s < samples:
        ns = min(chunk, samples - s)
        rad = trace_paths(scene, background, basis, width, height,
                          pix.repeat(ns),
                          torch.arange(s, s + ns, dtype=torch.int64,
                                       device=pix.device
                                       ).repeat_interleave(n),
                          seed, depth, coherent=coherent, schedule=schedule,
                          bf16_hits=bf16_hits)
        count("camera_rays", ns * n)
        for sample in rad.reshape(ns, n, 3):
            acc.add_(sample)
        s += ns
        yield s


def render_image(scene: Scene, settings: RenderSettings, device,
                 progress_cb=None) -> np.ndarray:
    """Render a full image on ``device``; returns [H, W, 3] float32,
    gamma-corrected (sqrt), rows top-down.

    Samples are traced in chunks of ``spp_per_chunk`` samples over every
    pixel (lane = sample * W * H + pixel) and added per pixel, one sample
    after the other, into one float32 accumulator on the device
    (``accumulate_samples``).  ``settings.intersector`` /
    ``leaf_size`` pick the trace's mode (``prepare_scene``); in cluster
    mode the lanes trace the pixels in ``block_order`` and each
    compaction orders its survivors by the coherence key, which leaves
    every pixel's sum as it is.  ``settings.partition`` (sweep mode, a
    scene with partition groups): the first chunk is the probe of a
    ``PartitionSchedule`` that every later chunk reuses; the image is
    bit-identical to ``partition=False``.  ``settings.bf16_hits``: the
    bf16 candidate tests in sweep mode, never partitioned, so that a bf16
    image does not depend on which chunk probed the schedule (ignored in
    BVH and cluster mode).  ``settings.compaction`` is taken and ignored:
    the port always compacts.
    ``progress_cb(samples_done, samples)`` is called after every chunk.

    Snapshots: every ``snapshot_every`` chunks and after the last, the
    accumulator is read back once and written to ``checkpoint_path``
    (``utils/checkpoint.py``) and as the gamma image of the samples so
    far to ``preview_path``.  A render with ``checkpoint_path`` starts
    from the checkpoint there when its identity matches (scene, size,
    depth, seed, the resolved intersector and its leaf size, the
    ``partition`` flag, ``bf16_hits`` where it applies, ``RENDER_FORMAT``)
    and it holds at most
    ``samples`` samples, and
    otherwise starts fresh with a warning.  The guarantee: a resumed
    render is bit-identical to an uninterrupted one, because every lane's
    RNG words are a function of its (pixel, sample) alone and the samples
    after the resume are added to the same float32 accumulator in the
    same order.  The samples are not part of the identity: a checkpoint at
    k spp resumes toward any target >= k.  Neither are the chunk
    boundaries (another ``spp_chunk``, or a preview's cap): they change
    the image not at all (tests/test_torch_cli.py).

    The call runs in the span ``render_image`` and counts one in
    ``images``; at debug level it logs its camera rays, its wall and the
    host ms of its spans outside the chunks (``image_summary``).
    """
    log = get_logger()
    before = snapshot() if log.isEnabledFor(logging.DEBUG) else None
    with span("render_image"):
        count("images")
        img = _render_image(scene, settings, device, progress_cb, log)
    if before is not None:
        log.debug("%s", image_summary(since(before), settings.depth))
    return img


def image_summary(work: dict, depth: int) -> str:
    """The debug line of one image from what it counted and spent
    (``profiling.since`` over a ``render_image`` call)."""
    spans, counters = work["spans"], work["counters"]
    rays = counters.get("camera_rays", 0)
    seconds = spans["render_image"].ns / 1e9
    host = ", ".join(f"{k} {spans[k].ns / 1e6:.2f}" for k in
                     ("prepare", "upload", "snapshot", "finish")
                     if k in spans)
    return (f"{rays} camera rays (depth<={depth}) in {seconds:.2f}s = "
            f"{rays / seconds / 1e6:.2f} Mrays/s; host ms {host}; "
            f"{counters.get('syncs', 0)} syncs")


def _render_image(scene: Scene, settings: RenderSettings, device,
                  progress_cb, log) -> np.ndarray:
    device = torch.device(device)
    W, H = settings.width, settings.height
    arrays, structure, mode = prepare_scene(scene, settings.intersector,
                                            settings.leaf_size)
    scene_t = to_device(arrays, scene.static, device, structure)
    basis = make_basis(scene.camera, W, H)
    n_pix = W * H
    chunk = spp_per_chunk(settings)
    coherent = mode == "cluster"
    if coherent:  # lane j traces pixel perm[j]; inv takes it back
        perm = block_order(W, H).astype(np.int64)
        pix = host_sync(torch.from_numpy(perm).to(device))
        inv = host_sync(torch.from_numpy(np.argsort(perm)).to(device))
    else:
        pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    # acc[i] is the sum of pixel pix[i]; in pixel order for a snapshot.
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)

    def pixel_order(a):
        return host_sync((a[inv] if coherent else a).cpu()).numpy()

    bf16 = bool(settings.bf16_hits) and mode == "sweep" \
        and bf16_engages(scene_t.sweep)
    schedule = None
    if settings.partition and mode == "sweep" and scene_t.groups \
            and not bf16:
        schedule = PartitionSchedule(scene_t.groups)

    # As the JAX package's meta: the partition and bf16_hits flags as
    # effective (bf16_hits changes nothing in BVH and cluster mode nor on a
    # plan without a bf16 tile; a bf16 render never partitions).
    meta = dict(scene=scene.name, width=W, height=H, depth=settings.depth,
                seed=settings.seed, format=RENDER_FORMAT, intersector=mode,
                leaf_size=settings.leaf_size if mode == "bvh" else None,
                partition=bool(settings.partition) and not bf16,
                bf16_hits=bf16)
    s = 0
    if settings.checkpoint_path:
        state = ckpt.load_state(settings.checkpoint_path)
        if state is not None:
            c_acc, c_done, c_meta = state
            if (ckpt.meta_matches(c_meta, meta)
                    and c_acc.shape == tuple(acc.shape)
                    and c_done <= settings.samples):
                acc = host_sync(torch.from_numpy(
                    c_acc.astype(np.float32)).to(device))
                if coherent:
                    acc = acc[pix]
                s = c_done
                log.info("resumed render at %d/%d spp from %s", s,
                         settings.samples, settings.checkpoint_path)
            else:
                log.warning("checkpoint %s does not match render config; "
                            "starting fresh", settings.checkpoint_path)

    snapshot_every = settings.snapshot_every or (
        1 if settings.preview_path else 8)
    chunks_done = 0
    for s in accumulate_samples(acc, scene_t, scene.background, basis, W, H,
                                pix, s, settings.samples, chunk,
                                settings.seed, settings.depth,
                                coherent=coherent, schedule=schedule,
                                bf16_hits=bf16):
        chunks_done += 1
        if (settings.checkpoint_path or settings.preview_path) and (
                s >= settings.samples or chunks_done % snapshot_every == 0):
            with span("snapshot"):
                acc_np = pixel_order(acc)
                if settings.checkpoint_path:
                    ckpt.save_state(settings.checkpoint_path, acc_np, s,
                                    meta)
                if settings.preview_path:
                    write_png(settings.preview_path,
                              gamma_image(acc_np, s, W, H))
        if progress_cb is not None:
            progress_cb(s, settings.samples)
    with span("finish"):
        acc_np = pixel_order(acc)
        if schedule is not None and schedule.decisions is not None:
            log.info("partitioned bounces %s (probe category counts %s)",
                     [b for b, on in enumerate(schedule.decisions) if on],
                     schedule.counts)
        return gamma_image(acc_np, settings.samples, W, H)
