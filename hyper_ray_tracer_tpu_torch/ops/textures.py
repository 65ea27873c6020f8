"""Texture evaluation on the winner's joined shade row
(``hyper_ray_tracer_tpu/ops/textures.py:26-63``).

Solid (solid_color.rs:20-24) and checker (checker_texture.rs:22-30: 3-D
sine product over two inline solid colors).  Noise and image textures come
with the texture slice of the port; a scene that has them is refused here.
"""

from __future__ import annotations

import torch

from ..models.scene import TT_CHECKER


def check_supported(static):
    """Raise for texture kinds this slice does not evaluate."""
    if static.has_noise_tex or static.has_image_tex:
        raise NotImplementedError(
            "noise and image textures are not ported yet (they come with "
            "the noise/image texture slice of the PyTorch port)")


def texture_value(sf, point, static):
    """Texture colors [B,3] for shade fields ``sf`` at hit points [B,3]."""
    check_supported(static)
    value = sf.color1  # TT_SOLID; color1 is also the checker 'odd' color
    if static.has_checker_tex:
        sines = (torch.sin(10.0 * point[..., 0])
                 * torch.sin(10.0 * point[..., 1])
                 * torch.sin(10.0 * point[..., 2]))
        checker = torch.where((sines < 0.0)[..., None], sf.color1, sf.color2)
        value = torch.where((sf.ttype == TT_CHECKER)[..., None], checker,
                            value)
    return value
