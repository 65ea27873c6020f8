"""The plain reference that decides a benchmark run's ``correct``.

Provenance.  This folder is a frozen rewrite, not an import, of the
scalar NumPy oracle of the repository's JAX package
(``hyper_ray_tracer_tpu/oracle.py``), with the pieces it shares with that
package copied in too: the counter-based RNG spec
(``hyper_ray_tracer_tpu/ops/rng.py``) and the camera basis
(``hyper_ray_tracer_tpu/camera.py`` ``make_basis``), all as they stood at
commit ``7eb49fb`` of this repository.  The scene format is copied whole
from the same commit, so that the reference builds every scene itself:
``builders.py`` (``hyper_ray_tracer_tpu/models/builders.py``),
``scene.py`` (``hyper_ray_tracer_tpu/models/scene.py``) and ``perlin.py``
(the tables of ``hyper_ray_tracer_tpu/ops/perlin.py``), only their
imports and docstrings changed.  What was rewritten:

* the oracle's per-pixel recursion became a fixed-width loop over a
  whole wavefront of lanes, every lane through every bounce with an
  ``alive`` mask, in plain PyTorch on any device;
* its per-primitive Python scan became an all-pairs sweep vectorised over
  (lanes, primitives) in blocks, the closest hit taken with the lowest
  index on a tie, as the renderer under test documents;
* its float64 Python scalars became float32 tensors (or another dtype
  for the lower-precision control), one IEEE operation per step, in the
  order that the renderer's own semantics document;
* the Perlin turbulence reads the scene's Perlin tables (pure data of
  the scene, as the oracle's did);
* the hit distance of each winner is computed again with gradients
  (``radiance(..., params=)``), so that a train step's loss, gradients
  and adam update can be followed.

Nothing here imports the port (``hyper_ray_tracer_tpu_torch``), the JAX
package (``hyper_ray_tracer_tpu``) or ``jax``; ``benchmarks/tests``
checks it.  The inputs it reads are its own build of the scene
(``tracer.for_scene``) and the raw image file the scene names, never
anything that the port made (its scene arrays, packed rows, sweep
records, a BVH); a test holds its arrays equal to the port's build.
"""
