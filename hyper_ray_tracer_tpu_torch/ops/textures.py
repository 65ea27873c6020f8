"""Texture evaluation on the winner's joined shade row
(``hyper_ray_tracer_tpu/ops/textures.py:26-86``).

Semantics:
  solid    solid_color.rs:20-24
  checker  checker_texture.rs:22-30 (3-D sine product over two inline
           solid colors)
  noise    noise_texture.rs:25-31 (marble; the turbulence input is the
           *pre-scaled* point, a reference quirk); the whole branch is
           ``ops/turbulence.noise_texture``, one CUDA kernel on the card
  image    image_texture.rs:36-62 (nearest texel, u clamped, v flipped,
           edge clamp)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import TT_CHECKER, TT_IMAGE
from .gather import gather_rows
from .perlin import PerlinTables
from .turbulence import noise_texture


class TextureTables(NamedTuple):
    """What the noise and image textures read besides the shade row."""

    images: torch.Tensor  # [NI, IH, IW, 3] float32
    image_wh: torch.Tensor  # [NI, 2] int32 (width, height) of each image
    perlin_keys: tuple  # the seven Perlin keys as Python ints
    perlin: PerlinTables  # the scene's tables, every array a tensor


def texel_rows(sf, hit, tables: TextureTables):
    """[B] int64: each lane's row of the scene's texels flattened to
    [NI * IH * IW, 3], from its image and uv."""
    wh = tables.image_wh[sf.image_id.long()]  # [B,2] (width, height)
    uu = torch.clamp(hit.u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(hit.v, 0.0, 1.0)
    i = torch.minimum((uu * wh[..., 0].to(torch.float32)).to(torch.int32),
                      wh[..., 0] - 1)
    j = torch.minimum((vv * wh[..., 1].to(torch.float32)).to(torch.int32),
                      wh[..., 1] - 1)
    ni, ih, iw, _ = tables.images.shape
    # Lanes of other textures may carry any uv; clamp their (unused)
    # index into the table, as the JAX package's gather does.
    return (sf.image_id.long() * (ih * iw) + j.long() * iw
            + i.long()).clamp(0, ni * ih * iw - 1)


def texture_value(sf, hit, static, tables: TextureTables):
    """Texture colors [B,3] for shade fields ``sf`` at the hits ``hit``
    (point and uv)."""
    point = hit.point
    value = sf.color1  # TT_SOLID; color1 is also the checker 'odd' color
    if static.has_checker_tex:
        sines = (torch.sin(10.0 * point[..., 0])
                 * torch.sin(10.0 * point[..., 1])
                 * torch.sin(10.0 * point[..., 2]))
        checker = torch.where((sines < 0.0)[..., None], sf.color1, sf.color2)
        value = torch.where((sf.ttype == TT_CHECKER)[..., None], checker,
                            value)
    if static.has_noise_tex:
        value = noise_texture(sf.ttype, sf.scale, point, value, tables)
    if static.has_image_tex:
        ni, ih, iw, _ = tables.images.shape
        # Many lanes read one texel: a reproducible backward.
        texel = gather_rows(tables.images.reshape(ni * ih * iw, 3),
                            texel_rows(sf, hit, tables))
        value = torch.where((sf.ttype == TT_IMAGE)[..., None], texel, value)
    return value
