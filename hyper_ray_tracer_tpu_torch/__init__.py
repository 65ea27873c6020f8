"""PyTorch/CUDA port of the path tracer in ``hyper_ray_tracer_tpu``.

The JAX package beside it is the reference this port is held against.
Plain tensor code is PyTorch; the kernels are CUDA written for Hopper and
built with nvcc on first use: the trace step of sphere-only scenes
(``csrc/sphere_sweep.cu``, K1), of every other scene
(``csrc/typed_sweep.cu``, K1b), of BVH mode (``csrc/bvh_traverse.cu``,
K4: the walk of the skip-threaded BVH, which auto picks from 30,000
primitives) and of cluster mode (``csrc/cluster_sweep.cu``, K5: the sweep
of box-culled spatial clusters); the noise texture's turbulence and its
backward (``csrc/turbulence.cu``, K2 and K2b) and the gathers' segmented
sum (``csrc/segment_sum.cu``, K3).  The BVH's host build is the C++
builder of ``native/bvh_builder.cpp``, compiled with the host's C++
compiler on first use.  Importing the package imports neither JAX nor a
compiler.
"""

from .models.builders import SCENES, build_scene
from .models.scene import Scene, SceneBuilder
from .render import RenderSettings, prepare_scene, render_image

__all__ = [
    "SCENES",
    "build_scene",
    "Scene",
    "SceneBuilder",
    "RenderSettings",
    "prepare_scene",
    "render_image",
]
