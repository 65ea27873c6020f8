"""Thin-lens look-at camera, matching the reference's ``camera.rs``.

``make_basis`` (the ``resize`` of camera.rs:67-83) runs on the host in
NumPy, copied from ``hyper_ray_tracer_tpu/camera.py``; ``get_rays`` turns
per-sample uniforms into jittered, defocused, shutter-timed rays on
tensors.  Ray directions are unnormalised, like the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.scene import CameraConfig
from .ops import math as m
from .ops import rng as prng
from .utils.profiling import host_sync


class CameraBasis(NamedTuple):
    """The resolved camera frame (camera.rs:20-33), NumPy float32."""

    origin: np.ndarray  # [3]
    lower_left: np.ndarray  # [3]
    horizontal: np.ndarray  # [3]
    vertical: np.ndarray  # [3]
    u: np.ndarray  # [3]
    v: np.ndarray  # [3]
    lens_radius: np.ndarray  # [] = aperture / 2 (camera.rs:57)
    time0: np.ndarray  # []
    time1: np.ndarray  # []


def make_basis(cfg: CameraConfig, width: int, height: int) -> CameraBasis:
    """camera.rs:67-83 (``resize``)."""
    aspect = np.float32(width) / np.float32(height)
    theta = np.deg2rad(np.float32(cfg.fov))
    h = np.tan(theta / 2.0)
    viewport_h = 2.0 * h
    viewport_w = aspect * viewport_h

    look_from = np.asarray(cfg.look_from, np.float32)
    look_at = np.asarray(cfg.look_at, np.float32)
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(np.float32([0.0, 1.0, 0.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    horizontal = np.float32(cfg.focus_dist * viewport_w) * u
    vertical = np.float32(cfg.focus_dist * viewport_h) * v
    lower_left = (
        look_from - horizontal / 2.0 - vertical / 2.0
        - np.float32(cfg.focus_dist) * w
    )
    return CameraBasis(
        origin=look_from.astype(np.float32),
        lower_left=lower_left.astype(np.float32),
        horizontal=horizontal.astype(np.float32),
        vertical=vertical.astype(np.float32),
        u=u.astype(np.float32),
        v=v.astype(np.float32),
        lens_radius=np.float32(cfg.aperture / 2.0),
        time0=np.float32(cfg.time0),
        time1=np.float32(cfg.time1),
    )


def get_rays(basis: CameraBasis, base, s, t):
    """Camera rays (camera.rs:85-95) on ``s``'s device.

    ``base``: per-(pixel, sample) RNG base words (int64, shape [B]).
    ``s``, ``t``: viewport coordinates [B] including the pixel jitter.
    Returns (origin [B,3], direction [B,3], time [B]).
    """
    def vec(x):
        return host_sync(torch.as_tensor(x, dtype=torch.float32,
                                         device=s.device))

    u1 = prng.uniform(base, prng.P_LENS_U)
    u2 = prng.uniform(base, prng.P_LENS_V)
    rd = float(basis.lens_radius) * m.in_unit_disk_from_uniforms(u1, u2)
    offset = rd[..., 0:1] * vec(basis.u) + rd[..., 1:2] * vec(basis.v)

    origin = vec(basis.origin) + offset
    direction = (
        vec(basis.lower_left)
        + s[..., None] * vec(basis.horizontal)
        + t[..., None] * vec(basis.vertical)
        - vec(basis.origin)
        - offset
    )
    ut = prng.uniform(base, prng.P_TIME)
    time = float(basis.time0) + ut * float(basis.time1 - basis.time0)
    return origin, direction, time
