"""Inverse rendering THROUGH GLASS: recover a sphere's position when it
is visible only as a refracted image inside a glass ball (the JAX
package's ``examples/inverse_glass.py`` on the port).

The red sphere sits outside the camera's frustum; the only pixels that
see it are inside the glass ball's disk, showing its doubly refracted
(inverted, compressed) image.  Without the silhouette term the position
gradient is exactly 0 there; the refractive families of ``ops/edges.py``
(the doubly refracted chief point and the tangency solve) restore the
boundary term, so adam slides the hidden sphere back.

    python -m hyper_ray_tracer_tpu_torch.examples.inverse_glass \
        [--cpu] [--steps N] [--out DIR]

Writes target.png / initial.png / recovered.png and prints the position
error before and after; exits 0 when the final error is below 0.3 of the
initial one.
"""

from __future__ import annotations

import sys

import numpy as np

from ..models.builders import SKY
from ..models.scene import MT_LAMBERTIAN, CameraConfig, SceneBuilder
from ..ops.edges import glass_sphere_ids_of
from .common import Fit, parse_args


def run(argv=None) -> dict:
    args = parse_args(argv, "inverse_glass", steps=120, lr=0.02, width=128,
                      height=72, spp=8, depth=4)

    # Glass ball in front of the camera; red sphere outside the frustum
    # (fov 40 vertical, aspect 16:9: its near edge sits past the
    # horizontal half-width), so every pixel that sees it does so through
    # two refractions.
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.5), 0.4, b.dielectric(1.5))
    b.sphere((2.6, 0.0, -3.0), 0.6,
             b.lambertian(b.solid((0.7, 0.15, 0.1))))
    cam = CameraConfig((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 40.0, 0.0,
                       focus_dist=1.0)
    scene = b.finalize(cam, SKY, "inverse-glass")
    if len(glass_sphere_ids_of(scene)) != 1:
        raise RuntimeError("the scene has no solid glass sphere")
    fit = Fit(scene, args, silhouette=True)
    mt = np.asarray(scene.arrays.materials.mtype)[
        np.asarray(scene.arrays.geom.material)[: scene.static.n_prims]]
    sphere = int(np.flatnonzero(mt == MT_LAMBERTIAN)[0])
    print(f"hidden sphere = primitive {sphere} (outside the frustum)")
    fit.to_png("target.png", fit.target)

    # Displace the hidden sphere in its own (x, y) plane.
    params0 = fit.with_shift(sphere, np.float32([-0.3, 0.18, 0.0]))
    fit.to_png("initial.png", fit.mean_image(params0))

    def err(params):
        d = (params["geom.p0"][sphere] - fit.true["geom.p0"][sphere])
        d = d.detach().cpu().numpy()
        return float(np.abs(d).max()), d

    def report(k, loss, params):
        e, d = err(params)
        print(f"step {k+1:4d}: loss {loss:.3e} "
              f"pos err {e:.3f} (dx,dy)=({d[0]:+.3f},{d[1]:+.3f})",
              flush=True)

    e0, _ = err(params0)
    print(f"initial position error: {e0:.3f} world units")
    row = fit.row_mask(sphere)
    params, losses, seconds = fit.adam(
        params0, {"geom.p0": row, "geom.p1": row}, args.lr, args.steps,
        report)
    fit.to_png("recovered.png", fit.mean_image(params))
    e1, _ = err(params)
    print(f"final position error: {e1:.3f} (was {e0:.3f})")
    return dict(losses=losses, errors=(e0, e1), seconds=seconds,
                passed=e1 < 0.3 * e0)


def main(argv=None) -> int:
    return 0 if run(argv)["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
