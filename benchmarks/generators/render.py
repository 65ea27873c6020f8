"""Render traffic: a closed loop of ``render_image`` calls.

Traffic parameters (``traffic/<name>.json``): ``width``, ``height``,
``samples``, ``depth``, ``intersector``, ``leaf_size``, ``partition``,
``seed_stride``, and ``rate_metric``, the name the camera-ray rate is
reported under (``render_mrays_s`` by default).  Image i of a run with ``--seed s`` uses the RNG seed
``(s * seed_stride + i) mod 2**32``; every image has the same size, so
every seed gives the same work in another draw of the samples.

Set-up builds the configuration's scene and renders one chunk of the
cell's own image (its first ``spp_per_chunk`` samples): every kernel is
built and loaded, and the caching allocator holds a chunk's memory.

The check (``check``): once the window has closed, ``check_pixels``
(image, pixel) pairs drawn from the seed over the window's images are
traced again by the reference (over the scene as its own builders make
it), every sample of each at the cell's depth,
summed one sample after the other in float32 and gamma-corrected as the
image is; a pixel parts where any channel differs by more than
``pixel_tol``.  The number compared is the share of parted pixels among
the lit ones (those that either side gives a value other than 0).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from benchmarks import faults
from benchmarks.reference.tracer import for_scene, pixel_sums
from benchmarks.trace import capture, merge, summarize


def image_seed(seed: int, stride: int, i: int) -> int:
    return (seed * stride + i) & 0xFFFFFFFF


class Session:
    def __init__(self, ctx):
        from hyper_ray_tracer_tpu_torch import (RenderSettings,
                                                build_scene, render_image)
        from hyper_ray_tracer_tpu_torch.render import spp_per_chunk

        self.ctx = ctx
        tr = ctx["traffic"]
        self.device = ctx["device"]
        self.scene = build_scene(ctx["config"]["scene"])
        self.W, self.H = int(tr["width"]), int(tr["height"])
        self.spp, self.depth = int(tr["samples"]), int(tr["depth"])
        self.stride = int(tr.get("seed_stride", 1000))
        self.control = ctx["control"]
        self.base = RenderSettings(
            width=self.W, height=self.H, samples=self.spp, depth=self.depth,
            intersector=tr.get("intersector", "auto"),
            leaf_size=int(tr.get("leaf_size", 4)),
            partition=bool(tr.get("partition", True)),
            bf16_hits=self.control == "bf16")
        self.render_image = render_image
        self.chunk = spp_per_chunk(self.base)
        self.images = []
        self.seeds = []
        self.fault = ctx["fault"]

    def settings(self, i):
        return dataclasses.replace(self.base, seed=image_seed(
            self.ctx["seed"], self.stride, i))

    def warm(self):
        with faults.render_fault(self.fault):
            self.render_image(self.scene, dataclasses.replace(
                self.settings(0), samples=self.chunk), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, i):
        s = self.settings(i)
        with faults.render_fault(self.fault):
            img = self.render_image(self.scene, s, self.device)
        self.images.append(img)
        self.seeds.append(s.seed)
        return self.W * self.H * self.spp

    def traced(self, loop):
        events, records, window = capture(loop, self.device)
        rays = sum(w for _, _, w in records)
        work = {"camera_rays": rays, "images": len(records)}
        return merge([summarize(events, work)]), window

    def end_to_end(self, records, window_s):
        rays = sum(w for _, _, w in records)
        name = self.ctx["traffic"].get("rate_metric", "render_mrays_s")
        return {name: rays / window_s / 1e6}

    def device_info(self):
        return device_info(self.device, self.ctx["chips"])

    def free(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        lim = self.ctx["limits"]
        n_check = int(lim["check_pixels"])
        tol = float(lim["pixel_tol"])
        seed = self.ctx["seed"] % (1 << 64)
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
        n_img = len(self.seeds)
        img_of = np.arange(n_check) % n_img
        pix_of = rng.integers(0, self.W * self.H, n_check)
        name = self.ctx["config"]["scene"]
        ref = for_scene(name, self.device)
        ctrl = None
        if self.control == "ref_bf16":
            ctrl = for_scene(name, self.device, dtype=torch.bfloat16)
        parted, lit, worst, nonfinite = 0, 0, 0.0, 0
        for k in range(n_img):
            pix = np.unique(pix_of[img_of == k])
            if pix.size == 0:
                continue
            p = torch.as_tensor(pix, device=self.device)
            want = gamma(pixel_sums(ref, self.W, self.H, p, self.spp,
                                    self.seeds[k], self.depth), self.spp)
            if ctrl is not None:  # the control's pixels in the program's place
                got = gamma(pixel_sums(ctrl, self.W, self.H, p, self.spp,
                                       self.seeds[k], self.depth), self.spp)
            else:
                img = self.images[k]
                got = img[self.H - 1 - pix // self.W, pix % self.W]
            nonfinite += int(not np.isfinite(got).all())
            gap = np.abs(got.astype(np.float64) - want).max(-1)
            gap = np.where(np.isfinite(gap), gap, np.inf)
            parted += int((gap > tol).sum())
            lit += int(((want != 0) | (got != 0)).any(-1).sum())
            worst = max(worst, float(gap.max()))
        share = parted / max(lit, 1)
        numbers = {"parted_pixel_share": {
            "value": share,
            "limit": float(lim["numbers"]["parted_pixel_share"]["limit"])}}
        print(f"checked {lit} lit pixels of {n_img} images: {parted} "
              f"parted, widest gap {worst!r}", file=sys.stderr)
        # A failed call: an image with a checked pixel that is not finite.
        return numbers, nonfinite


def gamma(acc: torch.Tensor, spp: int) -> np.ndarray:
    """sqrt-gamma of each pixel's float32 sum, as a rendered image's."""
    a = acc.float().cpu().numpy()
    return np.sqrt(np.maximum(a / spp, 0.0)).astype(np.float32)


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
