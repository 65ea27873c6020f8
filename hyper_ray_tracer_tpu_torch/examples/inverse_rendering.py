"""Inverse rendering: recover shading parameters from a target image (the
JAX package's ``examples/inverse_rendering.py`` on the port).

Renders the three-spheres scene, perturbs the center sphere's color and
the metal sphere's albedo and fuzz, then runs adam on the photometric
MSE through the differentiable render until they are recovered.
Shading parameters have clean interior gradients, so no silhouette term
is needed.

    python -m hyper_ray_tracer_tpu_torch.examples.inverse_rendering \
        [--cpu] [--steps N] [--out DIR]

Writes target.png / initial.png / recovered.png and prints the parameter
errors before and after; exits 0 when both final errors are below 0.2 of
their initial ones.
"""

from __future__ import annotations

import sys

import torch

from ..models.builders import build_scene
from .common import Fit, parse_args

# Only the perturbed leaves move: adam's normalized steps would otherwise
# drift every other parameter (the true ones too) and stall the recovery.
FREE = ("textures.color1", "materials.albedo", "materials.fuzz")


def run(argv=None) -> dict:
    args = parse_args(argv, "inverse_rendering", steps=200, lr=2e-2,
                      width=160, height=90, spp=4, depth=6)
    fit = Fit(build_scene("three-spheres"), args, silhouette=False)
    fit.to_png("target.png", fit.target, clip_max=None)

    # The blue sphere's color lives in the texture table (lambertian
    # attenuation = texture value); the metal sphere's albedo and fuzz are
    # material constants.
    params0 = {k: v.clone() for k, v in fit.true.items()}
    params0["textures.color1"][1] = torch.tensor((0.9, 0.1, 0.6))
    params0["materials.albedo"][3] = torch.tensor((0.2, 0.2, 0.9))
    params0["materials.fuzz"][3] = 0.4  # blurry instead of polished
    fit.to_png("initial.png", fit.mean_image(params0), clip_max=None)

    def err(params):
        def gap(k):
            return (params[k] - fit.true[k]).detach().abs().max().item()

        return gap("textures.color1"), (gap("materials.albedo")
                                        + gap("materials.fuzz"))

    def report(k, loss, params):
        ea, ec = err(params)
        print(f"step {k+1:4d}: loss {loss:.3e} "
              f"color err {ea:.3f} metal err {ec:.3f}", flush=True)

    ea0, ec0 = err(params0)
    print(f"initial error: color {ea0:.3f}, metal {ec0:.3f}")
    params, losses, seconds = fit.adam(params0, dict.fromkeys(FREE),
                                       args.lr, args.steps, report)
    fit.to_png("recovered.png", fit.mean_image(params), clip_max=None)
    ea1, ec1 = err(params)
    print(f"final error: color {ea1:.3f} (was {ea0:.3f}), "
          f"metal {ec1:.3f} (was {ec0:.3f})")
    return dict(losses=losses, errors=(ea0, ec0, ea1, ec1), seconds=seconds,
                passed=ea1 < 0.2 * ea0 and ec1 < 0.2 * ec0)


def main(argv=None) -> int:
    return 0 if run(argv)["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
