"""What the four fits share: their flags, the device, the scene uploaded
in its default mode, the fixed-noise mean image, the PNGs, and adam on a
masked subset of the parameters."""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from ..camera import make_basis
from ..render import prepare_scene, render_radiance
from ..scene_tensors import bind_params, extract_params, to_device
from ..train import ADAM_BETAS, ADAM_EPS, make_loss_fn, pixel_lanes
from ..utils.image import write_png


def parse_args(argv, name, steps, lr, width, height, spp, depth):
    """The JAX script's flags and defaults; ``--out`` defaults under the
    ignored ``out/``."""
    ap = argparse.ArgumentParser(
        prog=f"hyper_ray_tracer_tpu_torch.examples.{name}")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the plain-PyTorch versions "
                         "of the kernels")
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--out", default=f"out/{name}")
    ap.add_argument("--width", type=int, default=width)
    ap.add_argument("--height", type=int, default=height)
    ap.add_argument("--spp", type=int, default=spp)
    ap.add_argument("--depth", type=int, default=depth)
    return ap.parse_args(argv)


class Fit:
    """One fit's fixed parts: the scene uploaded in its default mode on
    the card (or the CPU with ``--cpu``), the camera, every pixel's
    ``spp`` lanes, the loss (with the silhouette term if asked), the true
    parameters and the target image rendered from them."""

    def __init__(self, scene, args, silhouette: bool):
        if args.cpu:
            self.device = torch.device("cpu")
        elif torch.cuda.is_available():
            self.device = torch.device("cuda")
        else:
            raise RuntimeError("no CUDA device is available; pass --cpu to "
                               "fit on the CPU")
        self.scene = scene
        self.W, self.H, self.spp, self.depth = (args.width, args.height,
                                                args.spp, args.depth)
        self.out = pathlib.Path(args.out)
        self.out.mkdir(parents=True, exist_ok=True)
        arrays, bvh, mode = prepare_scene(scene)
        self.scene_t = to_device(arrays, scene.static, self.device, bvh)
        self.basis = make_basis(scene.camera, self.W, self.H)
        self.pix, self.sam = pixel_lanes(self.W, self.H, self.spp,
                                         self.device)
        self.loss_fn = make_loss_fn(scene, self.W, self.H, self.depth, mode,
                                    silhouette=silhouette)
        self.true = {k: v.detach().clone()
                     for k, v in extract_params(self.scene_t.arrays).items()}
        self.target = self.mean_image(self.true)

    def mean_image(self, params):
        """Each pixel's mean radiance [W*H, 3] over its ``spp`` lanes under
        ``params``, with the noise of seed 0 (the target's): the loss's
        forward, as the JAX scripts render their images."""
        with torch.no_grad():
            rad = render_radiance(bind_params(self.scene_t, params),
                                  self.scene.background, self.basis, self.W,
                                  self.H, self.pix.reshape(-1),
                                  self.sam.reshape(-1), 0, self.depth)
        return rad.reshape(self.spp, self.W * self.H, 3).mean(0)

    def to_png(self, name, mean_rad, clip_max=1.0):
        img = np.sqrt(np.clip(mean_rad.cpu().numpy(), 0, clip_max))
        write_png(str(self.out / name), img.reshape(self.H, self.W, 3)[::-1])

    def with_shift(self, prim, shift):
        """The true parameters with primitive ``prim``'s p0 and p1 moved by
        ``shift`` (float32 [3])."""
        p0 = self.true["geom.p0"].cpu().numpy().copy()
        p1 = self.true["geom.p1"].cpu().numpy().copy()
        p0[prim] += shift
        p1[prim] += shift
        return {**self.true,
                "geom.p0": torch.from_numpy(p0).to(self.device),
                "geom.p1": torch.from_numpy(p1).to(self.device)}

    def row_mask(self, prim):
        """[P, 3] float32: 1 at primitive ``prim``'s first two components
        (a sphere's x and y, a rect's two in-plane coordinates)."""
        m = torch.zeros_like(self.true["geom.p0"])
        m[prim, :2] = 1.0
        return m

    def adam(self, params0, masks, lr, steps, report):
        """Adam at optax's defaults on the keys of ``masks``, each gradient
        multiplied by its mask (None: taken whole), the other parameters
        held; the loss against the target with the target's noise, so
        that the only image difference is the parameters.  Calls
        ``report(k, loss, params)`` after step k + 1 every tenth of the
        steps.  Returns (params, the loss before each step, the loop's
        seconds)."""
        params = {k: v.detach().clone().requires_grad_(k in masks)
                  for k, v in params0.items()}
        opt = torch.optim.Adam([params[k] for k in masks], lr=lr,
                               betas=ADAM_BETAS, eps=ADAM_EPS)
        losses = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for k in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = self.loss_fn(params, self.scene_t, self.basis, self.pix,
                                self.sam, 0, self.target)
            loss.backward()
            with torch.no_grad():
                for key, m in masks.items():
                    if params[key].grad is None:  # not read by the render
                        params[key].grad = torch.zeros_like(params[key])
                    elif m is not None:
                        params[key].grad.mul_(m)
            opt.step()
            losses.append(loss.detach())
            if (k + 1) % max(steps // 10, 1) == 0:
                report(k, float(loss.detach()), params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        return params, [float(x) for x in losses], seconds
