"""Image output.

The reference streams RGBA32F tiles to an OpenGL window
(`src/application.rs:284-326`); a headless renderer has no window,
so the display layer becomes PNG files.  A dependency-free zlib PNG encoder is included so
image output never depends on PIL being installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """float [H,W,3] in [0,1] -> uint8, with clamping (GL clamps on blit)."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H,W,3] float (0..1) or uint8 array as PNG (pure zlib)."""
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w, _ = img.shape
    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read an RGB(A) image to uint8 [H,W,3] (PIL; test/tooling helper)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)
