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
(``init_state`` :335-361, ``bounce_step`` with ``differentiable=False``
:363-455, ``render_image`` :1459-1672).

Compaction is eager: after every bounce, each lane's radiance is written to
its launch slot, and only the ``alive.nonzero()`` lanes, in launch order,
go on to the next bounce.  Every lane carries its own RNG base and shutter
time, so dropping finished lanes changes no lane's result.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .camera import CameraBasis, get_rays, make_basis
from .models.scene import Scene
from .ops import rng as prng
from .ops.intersect import gather_prim_shade_packed, sphere_hit_detail
from .ops.materials import shade
from .ops.sphere_sweep import sphere_sweep
from .ops.textures import check_supported
from .scene_tensors import SceneTensors, check_sphere_only, to_device

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


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int
    height: int
    samples: int
    depth: int
    seed: int = 0
    spp_chunk: Optional[int] = None  # samples per pass (None: CHUNK_LANES)


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
    s = (x + ju) / float(np.float32(width - 1))  # application.rs:443-446
    t = (y + jv) / float(np.float32(height - 1))
    o, d, time = get_rays(basis, base, s, t)
    return WavefrontState(
        o=o, d=d, time=time, base=base,
        alive=torch.ones_like(time, dtype=torch.bool),
        throughput=torch.ones_like(o),
        radiance=torch.zeros_like(o),
    )


def bounce_step(scene: SceneTensors, background, state: WavefrontState,
                bounce_idx: int) -> WavefrontState:
    """One wavefront bounce (the JAX ``bounce_step``, not differentiable)."""
    static = scene.static
    o, d, time = state.o, state.d, state.time
    alive, throughput, radiance = state.alive, state.throughput, \
        state.radiance
    bb = prng.bounce_base(state.base, bounce_idx)

    t_hit, prim = sphere_sweep(*scene.spheres, o, d, time, alive, T_MIN)
    hit = prim >= 0

    if background is None:  # gradient sky
        unit_y = d[:, 1] / torch.sqrt((d * d).sum(-1))
        sky_t = (0.5 * (unit_y + 1.0))[:, None]
        bg = (1.0 - sky_t) * d.new_tensor(_SKY_WHITE) \
            + sky_t * d.new_tensor(_SKY_BLUE)
    else:
        bg = d.new_tensor(background)
    miss = alive & ~hit
    radiance = radiance + torch.where(miss[:, None], throughput * bg, 0.0)

    pidx = torch.clamp(prim, min=0).long()
    pf, sf = gather_prim_shade_packed(scene.fpack, scene.ipack, pidx,
                                      static)
    t_use = torch.where(hit, t_hit, 1.0)
    det = sphere_hit_detail(pf, o, d, time, t_use, static.has_motion)
    sc = shade(sf, det, d, bb, static)

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


def trace_paths(scene: SceneTensors, background, basis: CameraBasis,
                width: int, height: int, pixel_ids, sample_ids, seed: int,
                depth: int):
    """Per-lane radiance [N,3] (pre-gamma, pre-averaging) of the camera
    rays (pixel_ids[i], sample_ids[i]), in launch order, with dead lanes
    compacted out after every bounce."""
    state = init_state(basis, width, height, pixel_ids, sample_ids, seed)
    out = torch.zeros_like(state.o)
    slot = torch.arange(pixel_ids.shape[0], device=pixel_ids.device)
    for bounce in range(depth):
        state = bounce_step(scene, background, state, bounce)
        # A lane's radiance no longer changes once it is dead, so the value
        # written here is final for every lane that stops now.
        out.index_copy_(0, slot, state.radiance)
        keep = state.alive.nonzero().squeeze(1)  # launch order kept
        if keep.numel() == 0:
            break
        if keep.numel() < slot.numel():
            state = WavefrontState(*(x[keep] for x in state))
            slot = slot[keep]
    return out


def _gamma_image(acc: np.ndarray, samples: int, W: int, H: int) -> np.ndarray:
    """sqrt-gamma (application.rs:451-453), bottom-up rows -> top-down."""
    img = np.sqrt(np.maximum(acc / samples, 0.0)).astype(np.float32)
    return img.reshape(H, W, 3)[::-1]


def spp_per_chunk(settings: RenderSettings) -> int:
    if settings.spp_chunk is not None:
        return max(1, min(settings.samples, settings.spp_chunk))
    lanes = settings.width * settings.height
    return max(1, min(settings.samples, CHUNK_LANES // max(lanes, 1)))


def render_image(scene: Scene, settings: RenderSettings,
                 device) -> np.ndarray:
    """Render a full image on ``device``; returns [H, W, 3] float32,
    gamma-corrected (sqrt), rows top-down.

    Samples are traced in chunks of ``spp_per_chunk`` samples over every
    pixel (lane = sample * W * H + pixel) and summed per pixel on the
    device.
    """
    device = torch.device(device)
    check_sphere_only(scene.static, scene.arrays.geom.ptype)
    check_supported(scene.static)
    W, H = settings.width, settings.height
    scene_t = to_device(scene.arrays, scene.static, device)
    basis = make_basis(scene.camera, W, H)
    n_pix = W * H
    chunk = spp_per_chunk(settings)
    pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)

    s = 0
    while s < settings.samples:
        ns = min(chunk, settings.samples - s)
        pixel_ids = pix.repeat(ns)
        sample_ids = torch.arange(s, s + ns, dtype=torch.int64,
                                  device=device).repeat_interleave(n_pix)
        rad = trace_paths(scene_t, scene.background, basis, W, H, pixel_ids,
                          sample_ids, settings.seed, settings.depth)
        acc += rad.reshape(ns, n_pix, 3).sum(0)
        s += ns
    return _gamma_image(acc.cpu().numpy(), settings.samples, W, H)
