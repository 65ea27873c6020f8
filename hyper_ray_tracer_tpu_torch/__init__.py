"""PyTorch/CUDA port of the path tracer in ``hyper_ray_tracer_tpu``.

The JAX package beside it is the reference this port is held against.
Plain tensor code is PyTorch; the trace step of sphere-only scenes is a
CUDA kernel written for Hopper (``csrc/sphere_sweep.cu``), built with nvcc
on first use.  Importing the package imports neither JAX nor a compiler.
"""

from .models.builders import SCENES, build_scene
from .models.scene import Scene, SceneBuilder
from .render import RenderSettings, render_image

__all__ = [
    "SCENES",
    "build_scene",
    "Scene",
    "SceneBuilder",
    "RenderSettings",
    "render_image",
]
