"""Inverse GEOMETRY: recover the cornell LIGHT's position from a target
image, through its silhouette (the JAX package's
``examples/inverse_geometry.py`` on the port).

Which paths hit the ceiling light is a discrete event, so the interior
gradient is nearly blind to where the light sits; the edge-sampled
silhouette term (``ops/edges.py``) restores the boundary term of the
light rect's edges, whose radiance step (emission 15 against the dim
ceiling) pulls the patch back to the target position.  The light is
shifted in its own plane by (dz, dx) = (40, -35), then adam on the
photometric MSE with ``make_loss_fn(silhouette=True)`` moves only its
in-plane components.

    python -m hyper_ray_tracer_tpu_torch.examples.inverse_geometry \
        [--cpu] [--steps N] [--out DIR]

Writes target.png / initial.png / recovered.png and prints the light's
position error before and after; exits 0 when the final error is below
0.15 of the initial one.
"""

from __future__ import annotations

import sys

import numpy as np

from ..models.builders import build_scene
from ..models.scene import MT_DIFFUSE_LIGHT
from .common import Fit, parse_args


def run(argv=None) -> dict:
    args = parse_args(argv, "inverse_geometry", steps=120, lr=2.0,
                      width=96, height=96, spp=4, depth=4)
    scene = build_scene("cornell")
    fit = Fit(scene, args, silhouette=True)

    # The light: the one primitive with an emissive material
    # (application.rs:679-685, ZX rect at y=554).
    mtypes = np.asarray(scene.arrays.materials.mtype)
    mat_of_prim = np.asarray(scene.arrays.geom.material)[
        : scene.static.n_prims]
    light = int(np.flatnonzero(mtypes[mat_of_prim] == MT_DIFFUSE_LIGHT)[0])
    print(f"light = primitive {light}")
    fit.to_png("target.png", fit.target)

    # Shift the light IN ITS PLANE: a ZX rect stores p0 = (a0, b0, k) =
    # (z0, x0, y); moving (dz, dx) shifts components 0 and 1 of both p0
    # and p1.
    params0 = fit.with_shift(light, np.float32([40.0, -35.0, 0.0]))
    fit.to_png("initial.png", fit.mean_image(params0))

    def err(params):
        d = (params["geom.p0"][light] - fit.true["geom.p0"][light]).detach()
        d = d.cpu().numpy()
        return float(np.abs(d).max()), d

    def report(k, loss, params):
        e, d = err(params)
        print(f"step {k+1:4d}: loss {loss:.3e} "
              f"pos err {e:6.1f} (da,db,dk)=({d[0]:.1f},{d[1]:.1f},"
              f"{d[2]:.1f})", flush=True)

    e0, _ = err(params0)
    print(f"initial light position error: {e0:.1f} world units")
    # Only the light rect's in-plane components move (the plane offset k
    # stays pinned: freeing it lets adam float the light off the ceiling
    # into a local minimum).
    row = fit.row_mask(light)
    params, losses, seconds = fit.adam(
        params0, {"geom.p0": row, "geom.p1": row}, args.lr, args.steps,
        report)
    fit.to_png("recovered.png", fit.mean_image(params))
    e1, _ = err(params)
    print(f"final light position error: {e1:.1f} (was {e0:.1f})")
    return dict(losses=losses, errors=(e0, e1), seconds=seconds,
                passed=e1 < 0.15 * e0)


def main(argv=None) -> int:
    return 0 if run(argv)["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
