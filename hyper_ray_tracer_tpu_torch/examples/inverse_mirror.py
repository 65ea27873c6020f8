"""Inverse rendering THROUGH A MIRROR: recover a sphere's position when
it is visible only as a reflection (the JAX package's
``examples/inverse_mirror.py`` on the port).

The sphere sits behind the camera, and every pixel that sees it does so
by one specular bounce off a polished metal rect.  Which pixels show the
mirrored sphere is a discrete event, so without the silhouette term the
position gradient is ~0; the planar-mirror family of ``ops/edges.py``
reflects the sphere's silhouette across the mirror plane and samples it
like a directly visible edge, so adam slides the hidden sphere back to a
target position it has never been directly seen at.

    python -m hyper_ray_tracer_tpu_torch.examples.inverse_mirror \
        [--cpu] [--steps N] [--out DIR]

Writes target.png / initial.png / recovered.png and prints the position
error before and after; exits 0 when the final error is below 0.15 of the
initial one.
"""

from __future__ import annotations

import sys

import numpy as np

from ..models.builders import SKY
from ..models.scene import PT_SPHERE, CameraConfig, SceneBuilder
from ..ops.edges import mirror_rect_ids_of
from .common import Fit, parse_args


def run(argv=None) -> dict:
    args = parse_args(argv, "inverse_mirror", steps=80, lr=0.02, width=96,
                      height=54, spp=8, depth=3)

    # A wall mirror facing the camera + a red sphere BEHIND the camera.
    b = SceneBuilder()
    b.rect(0, -0.9, 0.9, -0.55, 0.55, -1.0, b.metal((0.95, 0.95, 0.95),
                                                    0.0))
    b.sphere((0.3, 0.05, 1.2), 0.35,
             b.lambertian(b.solid((0.7, 0.15, 0.1))))
    cam = CameraConfig((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 90.0, 0.0,
                       focus_dist=1.0)
    scene = b.finalize(cam, SKY, "inverse-mirror")
    if len(mirror_rect_ids_of(scene)) != 1:
        raise RuntimeError("the scene has no planar mirror")
    fit = Fit(scene, args, silhouette=True)
    pt = np.asarray(scene.arrays.geom.ptype)[: scene.static.n_prims]
    sphere = int(np.flatnonzero(pt == PT_SPHERE)[0])
    print(f"hidden sphere = primitive {sphere} (behind the camera)")
    fit.to_png("target.png", fit.target)

    # Displace the hidden sphere in its own (x, y) plane.
    params0 = fit.with_shift(sphere, np.float32([-0.22, 0.12, 0.0]))
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
                passed=e1 < 0.15 * e0)


def main(argv=None) -> int:
    return 0 if run(argv)["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
