"""Edge-sampled silhouette gradients for scene geometry (the JAX
package's ``ops/edges.py``).

The renderer's gradients are fixed-decision (``train.py``): whether a ray
hits is settled in the forward pass, so moving a sphere so that its
silhouette sweeps across pixels has a gradient of exactly zero, although
the expected pixel value (the integral of radiance over the pixel's
jittered footprint) is a smooth function of the sphere.  This module
adds the missing boundary term with the edge-sampling estimator:

    d E[pixel] / dtheta  =  interior term (autograd)
        +  (1/A_pixel) * INT_{silhouette in pixel} dL * (v . n) dl

with dL the radiance step across the edge (two probe rays, one either
side), v the image-space velocity of the edge point and n its normal.

It is wired in as a straight-through image: ``correction(...)`` returns a
[W*H, 3] image that is exactly 0 in the forward pass (x - x.detach())
and whose gradient with respect to the geometry is the boundary term, so
``image + correction`` gives any loss the full gradient.

The curve families, each a point function of one curve parameter (an
angle ``phi`` on a circle, a fraction ``u`` along a segment) whose
tangent d xy / d parameter comes from ``torch.func.jacfwd`` and whose
gradient to the scene comes from autograd through the same function:

* spheres, static and moving (time-sampled centers), from a thin lens's
  sampled points (``_edge_xy``);
* rect and box boundary segments, a box's edge kept where its two faces
  straddle front and back from the sample's viewpoint (``_seg_xy``);
* every family above reflected in each planar mirror (a fuzz-0 metal
  rect) as a virtual image, a mirror's own edges excluded;
* curved mirrors (fuzz-0 metal spheres, and glass spheres' external
  Fresnel reflection): an unrolled Alhazen solve for the chief point and
  an unrolled tangency Newton (``_curved_mirror_xy``), and for segment
  sources the chief solve alone (``_curved_mirror_point_xy``);
* solid glass spheres: the doubly refracted (T*T) and internally
  reflected (T*R*T) images (``_glass_sphere_xy``), and segment sources
  through them (``_glass_point_xy``);
* hollow glass shells: the four-interface image of sphere sources
  (``_glass_shell_exit_ray``), with the direct family's samples whose
  lens-to-edge segment crosses a shell dropped (``_edge_blocked``).

The per-sample functions are written for one sample, as the JAX
package's are, and mapped with ``torch.func.vmap``; the Newton steps'
derivatives are ``torch.func.grad``, the solves unrolled to fixed counts
with ``torch.where`` as the only branch, so that they run under the
transforms.  ``.detach()`` stands for ``jax.lax.stop_gradient``.

Probe rays trace through the scene's own intersector (K1, K1b or K4)
with ``render.bounce_paths`` under ``no_grad``.  Gathers that take one
row many times (a bender's center for each of its pairs, a source for
each bender, a segment for each bender, an IOR) go through
``ops/gather.gather_rows``, whose backward is K3's fixed-order sum, so the
card's gradients repeat bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..camera import CameraBasis
from ..models.scene import (
    MT_DIELECTRIC,
    MT_METAL,
    PT_BOX,
    PT_RECT,
    PT_SPHERE,
)
from . import rng as prng
from .gather import gather_rows
from .math import div_rn, sqrt_capped_grad
from ..utils.profiling import host_sync

_TWO_PI = np.float32(2.0 * np.pi)
_PROBE_SALT = 0x51E77E00  # the probes' seed word, XORed with the seed


# --- host-side selectors (NumPy, over the first n_prims primitives) ---

def static_sphere_ids(scene) -> np.ndarray:
    """Indices of static (non-moving) spheres."""
    g = scene.arrays.geom
    pt = np.asarray(g.ptype)[: scene.static.n_prims]
    p0 = np.asarray(g.p0)[: scene.static.n_prims]
    p1 = np.asarray(g.p1)[: scene.static.n_prims]
    ok = (pt == PT_SPHERE) & np.all(p0 == p1, axis=-1)
    return np.flatnonzero(ok).astype(np.int32)


def sphere_ids_of(scene) -> np.ndarray:
    """Indices of every sphere, static and moving (moving ones get
    time-sampled edges)."""
    pt = np.asarray(scene.arrays.geom.ptype)[: scene.static.n_prims]
    return np.flatnonzero(pt == PT_SPHERE).astype(np.int32)


def rect_ids_of(scene) -> np.ndarray:
    """Indices of rect primitives (always silhouette-edged)."""
    pt = np.asarray(scene.arrays.geom.ptype)[: scene.static.n_prims]
    return np.flatnonzero(pt == PT_RECT).astype(np.int32)


def box_ids_of(scene) -> np.ndarray:
    """Indices of solid-box primitives."""
    pt = np.asarray(scene.arrays.geom.ptype)[: scene.static.n_prims]
    return np.flatnonzero(pt == PT_BOX).astype(np.int32)


def _material_of(scene):
    g = scene.arrays.geom
    n = scene.static.n_prims
    mat = np.asarray(g.material)[:n]
    return (np.asarray(scene.arrays.materials.mtype)[mat],
            np.asarray(scene.arrays.materials.fuzz)[mat])


def mirror_rect_ids_of(scene) -> np.ndarray:
    """Rects that are planar mirrors: metal with fuzz == 0 (a metal
    without perturbation reflects deterministically, so its virtual
    image is exact)."""
    pt = np.asarray(scene.arrays.geom.ptype)[: scene.static.n_prims]
    mt, fz = _material_of(scene)
    ok = (pt == PT_RECT) & (mt == MT_METAL) & (fz == 0.0)
    return np.flatnonzero(ok).astype(np.int32)


def mirror_sphere_ids_of(scene) -> np.ndarray:
    """Static spheres of metal with fuzz == 0: curved mirrors (e.g.
    `random`'s polished hero sphere)."""
    g = scene.arrays.geom
    n = scene.static.n_prims
    pt = np.asarray(g.ptype)[:n]
    st = np.all(np.asarray(g.p0)[:n] == np.asarray(g.p1)[:n], axis=-1)
    mt, fz = _material_of(scene)
    ok = (pt == PT_SPHERE) & st & (mt == MT_METAL) & (fz == 0.0)
    return np.flatnonzero(ok).astype(np.int32)


def _dielectric_spheres(scene):
    """(static dielectric sphere mask, radius, centers) over the first
    n_prims primitives."""
    g = scene.arrays.geom
    n = scene.static.n_prims
    pt = np.asarray(g.ptype)[:n]
    st = np.all(np.asarray(g.p0)[:n] == np.asarray(g.p1)[:n], axis=-1)
    mt, _ = _material_of(scene)
    rad = np.asarray(g.radius)[:n]
    return ((pt == PT_SPHERE) & st & (mt == MT_DIELECTRIC),
            rad, np.asarray(g.p0)[:n])


def glass_shell_pairs_of(scene) -> np.ndarray:
    """[K, 2] (outer, inner) ids of concentric hollow-glass shells: a
    positive-radius dielectric sphere and a negative-radius one at the
    same center (within 1e-4 of the outer radius) with |r_inner| <
    r_outer."""
    ok, rad, cen = _dielectric_spheres(scene)
    pos = np.flatnonzero(ok & (rad > 0.0))
    neg = np.flatnonzero(ok & (rad < 0.0))
    pairs = []
    for i in pos:
        tol = 1e-4 * abs(rad[i])
        for j in neg:
            if (np.linalg.norm(cen[j] - cen[i]) <= tol
                    and abs(rad[j]) < rad[i]):
                pairs.append((int(i), int(j)))
                break
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def glass_sphere_ids_of(scene) -> np.ndarray:
    """Static positive-radius dielectric spheres that are solid lenses;
    shell outers are left out (they get the four-interface family)."""
    ok, rad, _ = _dielectric_spheres(scene)
    ids = np.flatnonzero(ok & (rad > 0.0)).astype(np.int32)
    shells = glass_shell_pairs_of(scene)
    if len(shells):
        ids = ids[~np.isin(ids, shells[:, 0])]
    return ids.astype(np.int32)


# --- geometry on tensors (batched over primitives) ---

# The 12 edges of a box: (corner_a, corner_b, face1_axis, face1_is_max,
# face2_axis, face2_is_max).  Corner bit i set -> p1 on axis i, else p0.
_BOX_EDGES = []
for _a3 in range(3):
    _a1, _a2 = (i for i in range(3) if i != _a3)
    for _s1 in (0, 1):
        for _s2 in (0, 1):
            _ca = (_s1 << _a1) | (_s2 << _a2)
            _BOX_EDGES.append((_ca, _ca | (1 << _a3), _a1, _s1, _a2, _s2))
_BOX_EA = np.array([e[0] for e in _BOX_EDGES], np.int64)
_BOX_EB = np.array([e[1] for e in _BOX_EDGES], np.int64)
_BOX_FACE_AX = np.array([[e[2], e[4]] for e in _BOX_EDGES], np.int64)
_BOX_FACE_SGN = np.array([[2 * e[3] - 1, 2 * e[5] - 1] for e in _BOX_EDGES],
                         np.float32)
# Corner bit pattern -> per-axis selector (1.0 = take p1). [8,3]
_BOX_SEL = np.array([[(c >> i) & 1 for i in range(3)] for c in range(8)],
                    np.float32)


def _rect_corners(geom, ids):
    """World corners [R, 4, 3] of rects, differentiable in geom.p0/p1.
    Axis 0 (XY): k on z; 1 (YZ): k on x; 2 (ZX): k on y.  Consecutive
    corners (0,1), (1,2), (2,3), (3,0) are the four edges."""
    p0 = geom.p0[ids]
    p1 = geom.p1[ids]
    a0, b0, k = p0[:, 0], p0[:, 1], p0[:, 2]
    a1, b1 = p1[:, 0], p1[:, 1]
    A = torch.stack([a0, a1, a1, a0], 1)  # [R,4]
    B = torch.stack([b0, b0, b1, b1], 1)
    K = k[:, None].expand(A.shape)
    axis = geom.axis[ids][:, None]
    x = torch.where(axis == 0, A, torch.where(axis == 1, K, B))
    y = torch.where(axis == 0, B, torch.where(axis == 1, A, K))
    z = torch.where(axis == 0, K, torch.where(axis == 1, B, A))
    obj = torch.stack([x, y, z], -1)  # [R,4,3]
    return (torch.einsum("rij,rcj->rci", geom.rot[ids], obj)
            + geom.trans[ids][:, None, :])


def _box_corners(geom, ids, which=None):
    """World corners [B, 8, 3] of boxes (corner c takes p1 on axis i iff
    bit i of c), differentiable in geom.p0/p1; ``which`` [K]: only those
    corners, [B, K, 3], each computed as ``_box_corners(...)[:, which]``
    has it but with no gather (whose backward on the card would add a
    corner's three edges' cotangents in atomic order)."""
    p0 = geom.p0[ids][:, None, :]
    p1 = geom.p1[ids][:, None, :]
    sel = _BOX_SEL if which is None else _BOX_SEL[which]
    sel = host_sync(torch.as_tensor(sel, device=p0.device))[None]  # [1,8,3]
    obj = p0 * (1.0 - sel) + p1 * sel
    return (torch.einsum("rij,rcj->rci", geom.rot[ids], obj)
            + geom.trans[ids][:, None, :])


def _box_edge_normals(geom, ids):
    """[B, 12, 2, 3] world outward normals of the two faces beside each
    box edge: sign * the rotation's column of the face axis."""
    dev = geom.rot.device
    n = geom.rot[ids][:, :, host_sync(torch.as_tensor(_BOX_FACE_AX,
                                                      device=dev))]
    return torch.movedim(n, 1, -1) * host_sync(torch.as_tensor(
        _BOX_FACE_SGN, device=dev))[None, :, :, None]


def _box_silhouette_mask(geom, ids, corners, origin):
    """[B, 12] bool: an edge is a silhouette iff its two faces straddle
    front and back as seen from ``origin``, at the edge's midpoint.  The
    correction tests each sample from its own lens point instead; this
    midpoint form is for diagnostics and tests."""
    n = _box_edge_normals(geom, ids)
    ea = host_sync(torch.as_tensor(_BOX_EA, device=corners.device))
    eb = host_sync(torch.as_tensor(_BOX_EB, device=corners.device))
    mid = 0.5 * (corners[:, ea] + corners[:, eb])
    v = mid - origin
    d1 = (n[:, :, 0, :] * v).sum(-1)
    d2 = (n[:, :, 1, :] * v).sum(-1)
    return (d1 * d2) < 0.0


def _mirror_planes(geom, mirror_ids):
    """World planes of mirror rects: (point [M,3], unit normal [M,3]).
    The normal is the rotation's column of the rect's k axis; the point
    is corner 0, which moves with the rect's k offset in p0."""
    corners = _rect_corners(geom, mirror_ids)
    axis = geom.axis[mirror_ids]
    # k axis in world: axis 0 (XY) -> z, 1 (YZ) -> x, 2 (ZX) -> y.
    n_obj = torch.stack([(axis == 1), (axis == 2), (axis == 0)],
                        -1).to(torch.float32)
    n = torch.einsum("rij,rj->ri", geom.rot[mirror_ids], n_obj)
    return corners[:, 0], n


def _reflect_pts(x, pnt, nrm):
    """Householder reflection of points ``x`` [..., 3] across the plane
    (pnt, nrm); affine, so lerped centers stay lerps of reflections."""
    d = ((x - pnt) * nrm).sum(-1, keepdim=True)
    return x - 2.0 * d * nrm


def _reflect_dirs(v, nrm):
    return v - 2.0 * (v * nrm).sum(-1, keepdim=True) * nrm


# --- per-sample point functions (one sample; mapped with vmap) ---

def _vec3(ref, x, y, z):
    return host_sync(torch.tensor((x, y, z), dtype=torch.float32,
                                  device=ref.device))


def _normize(v):
    # A plain root with a floor (the JAX package's: its capped root is a
    # custom_vjp, which forward mode refuses); callers keep the argument
    # far from 0.
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-24))


def _safe_slope(dg, eps):
    """``dg`` pushed away from 0 to at least ``eps`` in magnitude, its
    sign kept (0 counts as positive)."""
    return torch.where(torch.abs(dg) > eps, dg,
                       torch.where(dg >= 0, eps, -eps))


def _ray_to_xy(d, offset, basis, W, H):
    """Image coordinates [2] of the thin-lens ray from ``basis.origin +
    offset`` along ``d``: where it crosses the focal plane, inverting
    camera.rs:85-94.  ``cW`` < 0 means the ray points in front of the
    camera."""
    Hv, Vv = basis.horizontal, basis.vertical
    fw = basis.origin - basis.lower_left - 0.5 * Hv - 0.5 * Vv
    rel = offset + 0.5 * Hv + 0.5 * Vv + fw  # (origin + offset) - llc
    a = (rel * Hv).sum() / (Hv * Hv).sum()
    b = (rel * Vv).sum() / (Vv * Vv).sum()
    c = (rel * fw).sum() / (fw * fw).sum()
    dH = (d * Hv).sum() / (Hv * Hv).sum()
    dV = (d * Vv).sum() / (Vv * Vv).sum()
    cW = (d * fw).sum() / (fw * fw).sum()  # negative in front
    lam = c / (-cW)  # ray parameter of the focal-plane crossing
    s = a + lam * dH
    t = b + lam * dV
    return torch.stack([s * (W - 1), t * (H - 1)]), cW


def _dir_to_xy(w_dir, basis, W, H):
    """Pinhole case of ``_ray_to_xy`` (zero lens offset)."""
    return _ray_to_xy(w_dir, torch.zeros_like(w_dir), basis, W, H)


def _edge_xy(c, r, phi, off, basis, W, H):
    """Image coordinates [2] of the silhouette point at angle ``phi`` of
    sphere (c, r) seen from lens point ``basis.origin + off``: the cone
    from the lens point tangent to the sphere has half-angle asin(r/L)
    about (c - o) / L.  Smooth in (c, r, phi)."""
    origin = basis.origin + off
    oc = c - origin
    L2 = (oc * oc).sum()
    L = sqrt_capped_grad(L2)
    u_ax = oc / L
    sin_a = r / L
    cos_a = sqrt_capped_grad(torch.clamp(1.0 - sin_a * sin_a, min=1e-12))
    # A frame around the view axis seeded by whichever camera basis
    # vector is less parallel to it.
    bu, bv = basis.u, basis.v
    seed_v = torch.where(torch.abs((u_ax * bu).sum()) < 0.9, bu, bv)
    e1 = torch.linalg.cross(u_ax, seed_v)
    e1 = e1 / sqrt_capped_grad((e1 * e1).sum())
    e2 = torch.linalg.cross(u_ax, e1)
    w_dir = cos_a * u_ax + sin_a * (torch.cos(phi) * e1
                                    + torch.sin(phi) * e2)
    return _ray_to_xy(w_dir, off, basis, W, H)


def _edge_blocked(c, r, phi, off, basis, gs, Rs):
    """True when the segment from the lens point to the silhouette point
    crosses one of the spheres ``gs`` / ``Rs`` (hollow-shell outers): the
    four-interface family owns that boundary term.  ``_edge_xy``'s frame
    and point, primal only (the caller detaches the inputs).  The gate is
    the JAX package's as it is: a shell's own rim point sits where the
    discriminant is ~0, and rounding decides whether it is dropped
    (ROADMAP queue 3, F4)."""
    origin = basis.origin + off
    oc = c - origin
    L = torch.sqrt(torch.clamp((oc * oc).sum(), min=1e-20))
    u_ax = oc / L
    sin_a = r / L
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=1e-12))
    bu, bv = basis.u, basis.v
    seed_v = torch.where(torch.abs((u_ax * bu).sum()) < 0.9, bu, bv)
    e1 = torch.linalg.cross(u_ax, seed_v)
    e1 = e1 / torch.sqrt(torch.clamp((e1 * e1).sum(), min=1e-20))
    e2 = torch.linalg.cross(u_ax, e1)
    w = cos_a * u_ax + sin_a * (torch.cos(phi) * e1 + torch.sin(phi) * e2)
    t_edge = L * cos_a
    oc2 = origin[None, :] - gs  # [G,3]
    b = (oc2 * w[None, :]).sum(-1)  # [G] (w is unit)
    disc = b * b - (oc2 * oc2).sum(-1) + Rs * Rs
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    hit = (disc > 0.0) & (((t0 > 1e-4) & (t0 < t_edge))
                          | ((t1 > 1e-4) & (t1 < t_edge)))
    return hit.any()


def _seg_xy(pA, pB, u, off, basis, W, H):
    """Image coordinates [2] of the segment point ``pA + u (pB - pA)``
    seen from lens point ``basis.origin + off``."""
    x = pA + u * (pB - pA)
    return _ray_to_xy(x - basis.origin - off, off, basis, W, H)


def _in_plane_frame(E, m, c):
    """(a_e, b_e): the unit axis from sphere center ``m`` toward the eye
    ``E``, and the unit direction of target ``c`` across it (any
    orthogonal one when ``c`` is on the axis)."""
    a_e = _normize(E - m)
    cm = c - m
    b_raw = cm - (cm * a_e).sum() * a_e
    b_len2 = (b_raw * b_raw).sum()
    alt = torch.where(torch.abs(a_e[1]) < 0.9, _vec3(a_e, 0.0, 1.0, 0.0),
                      _vec3(a_e, 1.0, 0.0, 0.0))
    alt = _normize(torch.linalg.cross(a_e, alt))
    b_e = torch.where(b_len2 > 1e-12,
                      b_raw / torch.sqrt(torch.clamp(b_len2, min=1e-20)),
                      alt)
    return a_e, b_e


def _alhazen_chief(E, m, R, c, n_alhazen: int = 4):
    """Reflection point of target ``c`` on the sphere mirror (m, R) seen
    from eye ``E`` (Alhazen's problem): unrolled Newton on the in-plane
    reflection condition from the bisector seed.  Returns (u0, a_e, b_e):
    the unit surface direction of the chief point and the frame."""
    a_e, b_e = _in_plane_frame(E, m, c)

    def chief_residual(psi):
        u = torch.cos(psi) * a_e + torch.sin(psi) * b_e
        x = m + R * u
        to_e = _normize(E - x)
        to_c = _normize(c - x)
        # Reflection: the normal u bisects to_e and to_c, so their
        # tangential components cancel.
        h = to_e + to_c
        return (h * b_e).sum() * (u * a_e).sum() \
            - (h * a_e).sum() * (u * b_e).sum()

    bis = _normize(_normize(E - m) + _normize(c - m))
    psi = torch.atan2((bis * b_e).sum(), (bis * a_e).sum()).detach()
    for _ in range(n_alhazen):
        g = chief_residual(psi)
        dg = grad(chief_residual)(psi)
        psi = psi - g / _safe_slope(dg, 1e-12)
    u0 = torch.cos(psi) * a_e + torch.sin(psi) * b_e
    return u0, a_e, b_e


def _refract_unit(v, n, ratio):
    """Unit refraction of unit ``v`` at unit normal ``n`` (cos_i =
    -(v.n) > 0), Snell ratio n_i / n_t.  Returns (v_t, tir): past the
    critical angle the root is clamped and ``tir`` marks the sample."""
    cos_i = -(v * n).sum()
    sin2_t = ratio * ratio * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    return ratio * v + (ratio * cos_i - cos_t) * n, tir


def _glass_exit_ray(E, m, R, ior, u):
    """T*T: the doubly refracted exit ray of the camera ray E -> m + R u
    through the glass sphere (m, R, ior): (entry x1, exit x2, unit exit
    direction, tir)."""
    x1 = m + R * u
    v1 = _normize(x1 - E)
    v2, _ = _refract_unit(v1, u, 1.0 / ior)  # air -> glass never TIRs
    v2 = _normize(v2)
    t2 = -2.0 * R * (v2 * u).sum()  # the chord
    x2 = x1 + t2 * v2
    n2 = (x2 - m) / R
    v3, tir = _refract_unit(v2, -n2, ior)
    return x1, x2, _normize(v3), tir


def _glass_trt_exit_ray(E, m, R, ior, u):
    """T*R*T: entry refraction, chord, internal reflection at the far
    surface, a second chord, exit refraction; ``_glass_exit_ray``'s
    return convention."""
    x1 = m + R * u
    v1 = _normize(x1 - E)
    v2, _ = _refract_unit(v1, u, 1.0 / ior)
    v2 = _normize(v2)
    t2 = -2.0 * R * (v2 * u).sum()
    x2 = x1 + t2 * v2
    n2 = (x2 - m) / R
    vr = v2 - 2.0 * (v2 * n2).sum() * n2  # the internal mirror bounce
    t3 = -2.0 * R * (vr * n2).sum()
    x3 = x2 + t3 * vr
    n3 = (x3 - m) / R
    v4, tir = _refract_unit(vr, -n3, ior)
    return x1, x3, _normize(v4), tir


def _glass_shell_exit_ray(E, m, R, ior, u, Ri):
    """The exit ray through a hollow glass shell (outer radius R, a
    concentric air bubble of radius Ri): air -> glass -> bubble -> glass
    -> air, the chords closed-form.  Entries that miss the bubble are
    marked invalid, as are TIRs at either glass -> air interface."""
    x1 = m + R * u
    v1 = _normize(x1 - E)
    v2, _ = _refract_unit(v1, u, 1.0 / ior)
    v2 = _normize(v2)
    hb = ((x1 - m) * v2).sum()  # negative: v2 heads inward
    disc = hb * hb - (R * R - Ri * Ri)
    miss = disc <= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=1e-20))
    xb1 = x1 + (-hb - sq) * v2  # the first bubble crossing
    nb1 = (xb1 - m) / Ri
    v3, tir1 = _refract_unit(v2, nb1, ior)  # glass -> air
    v3 = _normize(v3)
    xb2 = xb1 + (-2.0 * Ri * (v3 * nb1).sum()) * v3  # the bubble chord
    nb2 = (xb2 - m) / Ri
    v4, _ = _refract_unit(v3, -nb2, 1.0 / ior)  # air -> glass
    v4 = _normize(v4)
    hb2 = ((xb2 - m) * v4).sum()
    t_out = -hb2 + torch.sqrt(
        torch.clamp(hb2 * hb2 + R * R - Ri * Ri, min=1e-20))
    x2 = xb2 + t_out * v4
    n2 = (x2 - m) / R
    v5, tir2 = _refract_unit(v4, -n2, ior)  # outer exit: glass -> air
    return x1, x2, _normize(v5), miss | tir1 | tir2


_GLASS_LIM = np.float32(np.pi / 2 - 1e-3)
_GLASS_GRID_N = 48


def _glass_grid(ref):
    """The chief solve's seed grid over the visible cap, both sides of
    the axis (``jnp.linspace(-lim + 1e-3, lim - 1e-3, 48)``)."""
    lo = float(np.float32(-_GLASS_LIM + np.float32(1e-3)))
    hi = float(np.float32(_GLASS_LIM - np.float32(1e-3)))
    return torch.linspace(lo, hi, _GLASS_GRID_N, dtype=torch.float32,
                          device=ref.device)


def _glass_chief(E, m, R, ior, c, n_newton: int = 8, exit_fn=None):
    """Entry direction u0 of the chief refracted path E -> glass sphere
    (m, R, ior) -> target ``c``, and the in-plane frame: unrolled Newton
    on the in-plane entry angle, the residual the exit ray's signed
    misalignment with the direction to ``c``, seeded by a grid scan (a
    ball lens inverts, so no geometric seed exists).  ``exit_fn``: the
    ray map through the ball (``_glass_exit_ray`` by default)."""
    if exit_fn is None:
        exit_fn = _glass_exit_ray
    a_e, b_e = _in_plane_frame(E, m, c)

    def residual(psi):
        u = torch.cos(psi) * a_e + torch.sin(psi) * b_e
        _, x2, v3, _ = exit_fn(E, m, R, ior, u)
        to_c = _normize(c - x2)
        return (v3 * b_e).sum() * (to_c * a_e).sum() \
            - (v3 * a_e).sum() * (to_c * b_e).sum()

    grid_psi = _glass_grid(a_e)
    with torch.no_grad():  # a seed: no gradient reaches it
        res_g = vmap(residual)(grid_psi)
    # The first minimum, as jnp.argmin has it.
    psi = torch.take_along_dim(
        grid_psi, torch.argmin(torch.abs(res_g)).reshape(1))[0].detach()
    lim = float(_GLASS_LIM)
    for _ in range(n_newton):
        g = residual(psi)
        dg = grad(residual)(psi)
        psi = torch.clamp(psi - g / _safe_slope(dg, 1e-12), -lim, lim)
    u0 = torch.cos(psi) * a_e + torch.sin(psi) * b_e
    return u0, a_e, b_e


def _glass_point_xy(off, m, R, ior, p, basis, W, H, n_newton: int = 8):
    """Image point [2] of the refracted image of world point ``p`` seen
    through the glass sphere (m, R, ior) from lens point origin + off,
    its validity, and the exit point (the viewpoint ``p`` is seen from,
    for a box's silhouette test)."""
    E = basis.origin + off
    u0, _, _ = _glass_chief(E, m, R, ior, p, n_newton)
    x1, x2, v3, tir = _glass_exit_ray(E, m, R, ior, u0)
    to_p = _normize(p - x2)
    aligned = (v3 * to_p).sum() > 0.999
    front = ((x1 - E) * u0).sum() < 0.0
    outside = ((p - m) * (p - m)).sum() > R * R
    xy, cW = _ray_to_xy(x1 - E, off, basis, W, H)
    return xy, (aligned & front & ~tir & outside & (cW < 0.0)), x2


def _tangency_newton(tangency, n_newton, eps, ref):
    """Unrolled Newton on ``tangency(theta)[0]`` from 1e-3, each step
    clamped to the visible cap (``ref``: a tensor on the device)."""
    theta = host_sync(torch.tensor(1e-3, dtype=torch.float32,
                                   device=ref.device))
    hi = float(np.float32(np.pi / 2 - 1e-3))

    def g_of(t):
        return tangency(t)[0]

    for _ in range(n_newton):
        g = g_of(theta)
        dg = grad(g_of)(theta)
        theta = torch.clamp(theta - g / _safe_slope(dg, eps), 1e-4, hi)
    return tangency(theta)


def _glass_sphere_xy(off, m, R, ior, c, r, phi, basis, W, H,
                     n_chief: int = 8, n_newton: int = 8, exit_fn=None):
    """Image point [2] of the refracted silhouette of source sphere
    (c, r) seen through the glass sphere (m, R, ior) from lens point
    origin + off at curve parameter ``phi``, and its validity: the chief
    solve, then a tangency Newton along the entry surface's geodesic at
    azimuth ``phi`` for the entry point whose exit ray grazes (c, r)."""
    if exit_fn is None:
        exit_fn = _glass_exit_ray
    E = basis.origin + off
    u0, a_e, b_e = _glass_chief(E, m, R, ior, c, n_chief, exit_fn=exit_fn)
    e1 = _normize(torch.linalg.cross(u0, a_e) + 1e-12 * b_e)
    e2 = torch.linalg.cross(u0, e1)
    tdir = torch.cos(phi) * e1 + torch.sin(phi) * e2

    def tangency(theta):
        u = _normize(torch.cos(theta) * u0 + torch.sin(theta) * tdir)
        x1, x2, v3, tir = exit_fn(E, m, R, ior, u)
        q = c - x2
        t_c = (q * v3).sum()
        d2 = (q * q).sum() - t_c * t_c
        return torch.sqrt(torch.clamp(d2, min=1e-20)) - r, t_c, x1, tir

    g_fin, t_c, x1, tir = _tangency_newton(tangency, n_newton, 1e-9, u0)
    front = ((x1 - E) * _normize(x1 - m)).sum() < 0.0
    outside_src = ((c - m) * (c - m)).sum() > R * R
    ok = ((torch.abs(g_fin) < 0.05 * torch.abs(r)) & (t_c > 0.0) & front
          & ~tir & outside_src)
    xy, cW = _ray_to_xy(x1 - E, off, basis, W, H)
    return xy, (ok & (cW < 0.0))


def _curved_mirror_point_xy(off, m, R, p, basis, W, H,
                            n_alhazen: int = 6):
    """Image point [2] of the mirrored image of world point ``p`` in the
    sphere mirror (m, R) from lens point origin + off (one chief solve),
    its validity (converged, front-facing, in front), and the reflection
    point (the viewpoint for a box's silhouette test)."""
    E = basis.origin + off
    u0, _, _ = _alhazen_chief(E, m, R, p, n_alhazen)
    x = m + R * u0
    v = _normize(x - E)
    w = v - 2.0 * (v * u0).sum() * u0
    to_p = _normize(p - x)
    aligned = (w * to_p).sum() > 0.999
    front = ((x - E) * u0).sum() < 0.0
    xy, cW = _ray_to_xy(x - E, off, basis, W, H)
    return xy, (aligned & front & (cW < 0.0)), x


def _curved_mirror_xy(off, m, R, c, r, phi, basis, W, H,
                      n_alhazen: int = 4, n_newton: int = 8):
    """Image point [2] of the mirrored silhouette of sphere (c, r) in the
    sphere mirror (m, R) from lens point origin + off at curve parameter
    ``phi``, and its validity: the mirror-surface point whose reflected
    ray grazes (c, r), by the Alhazen chief solve and a tangency Newton
    along the geodesic from the chief point."""
    E = basis.origin + off
    u0, a_e, b_e = _alhazen_chief(E, m, R, c, n_alhazen)
    e1 = _normize(torch.linalg.cross(u0, a_e) + 1e-12 * b_e)
    e2 = torch.linalg.cross(u0, e1)
    tdir = torch.cos(phi) * e1 + torch.sin(phi) * e2

    def tangency(theta):
        u = torch.cos(theta) * u0 + torch.sin(theta) * tdir
        x = m + R * u
        v = _normize(x - E)
        w = v - 2.0 * (v * u).sum() * u  # the unit reflected direction
        q = c - x
        t_c = (q * w).sum()
        d2 = (q * q).sum() - t_c * t_c
        return torch.sqrt(torch.clamp(d2, min=1e-20)) - r, t_c, x

    g_fin, t_c, x = _tangency_newton(tangency, n_newton, 1e-9, u0)
    n_srf = (x - m) / R
    front = ((x - E) * n_srf).sum() < 0.0
    ok = (torch.abs(g_fin) < 0.05 * torch.abs(r)) & (t_c > 0.0) & front
    xy, cW = _ray_to_xy(x - E, off, basis, W, H)
    return xy, (ok & (cW < 0.0))


# --- mapping over samples ---

def _flat(x, lead):
    return x.reshape(lead, *x.shape[2:])


def _map_samples(fn, *args):
    """``fn`` over the [K, E] samples of ``args`` (each [K, E, ...]):
    ``vmap`` over the K*E samples flattened, the outputs back in
    [K, E, ...]."""
    K, E = args[0].shape[:2]
    out = vmap(fn)(*(_flat(a, K * E) for a in args))
    if isinstance(out, tuple):
        return tuple(o.reshape(K, E, *o.shape[1:]) for o in out)
    return out.reshape(K, E, *out.shape[1:])


def _map_tangents(fn, argnum, *args):
    """d fn(...)[0] / d args[argnum], per sample, as ``_map_samples`` maps
    ``fn``: ``jacfwd`` with respect to the one curve parameter, so no
    Jacobian larger than the [K, E, 2] tangent is formed.  Primal only
    (the caller detaches it): computed with no autograd graph."""
    with torch.no_grad():
        return _map_samples(jacfwd(lambda *a: fn(*a)[0], argnums=argnum),
                           *args)


def _rows(x, K, E):
    """[K, ...] -> [K, E, ...] (each row for each of its E samples)."""
    return x[:, None].expand(K, E, *x.shape[1:])


def _cols(x, K):
    """[E, ...] -> [K, E, ...]."""
    return x[None].expand(K, *x.shape)


def _gather(table, idx):
    """``table[idx]`` through ``gather_rows`` (K3's fixed-order backward),
    for ids that repeat; ``table`` [P] or [P, F]."""
    if table.dim() == 1:
        return gather_rows(table[:, None], idx)[:, 0]
    return gather_rows(table, idx)


def _disk(rows, cols, salt):
    """Concentric-disk lens points [rows, cols, 2] (a rotated lattice per
    row), for aperture 1."""
    i = np.arange(cols, dtype=np.float64) + 0.5
    rows_i = np.arange(max(rows, 1), dtype=np.float64)[:, None]
    u1 = np.mod(i * 0.7548776662 + 0.331 * salt * (rows_i + 1.0), 1.0)
    u2 = np.mod(i * 0.5698402910 + 0.773 * salt * (rows_i + 2.0), 1.0)
    rr = np.sqrt(u1)
    th = 2.0 * np.pi * u2
    return np.stack([rr * np.cos(th), rr * np.sin(th)],
                    -1).astype(np.float32)


def _tfracs(E, rows):
    """Shutter-time fractions [rows, E]: stratified over the sample,
    golden-ratio rotated per row."""
    return np.mod((np.arange(E, dtype=np.float64) + 0.5) / E
                  + 0.6180339887 * np.arange(max(rows, 1))[:, None],
                  1.0).astype(np.float32)


def _apparent_rank(centers, sizes, at, keep_max):
    """Indices of the ``keep_max`` largest apparent sizes seen from
    ``at``, largest first (stable)."""
    app = sizes / np.maximum(np.linalg.norm(centers - at, axis=-1), 1e-6)
    return np.argsort(-app, kind="stable")[:keep_max]


def make_silhouette_correction(scene, W, H, depth, geom=None,
                               sphere_ids=None, rect_ids=None,
                               box_ids=None, mirror_ids=None,
                               mirror_sphere_ids=None,
                               glass_sphere_ids=None, glass_shells=None,
                               mirror_pairs_max: int = 64,
                               n_edge: int = 64, n_seg: int = 16,
                               n_probe: int = 2, eps: float = 0.35):
    """Build ``correction(scene_t, basis, seed, stats=None)`` -> [W*H, 3].

    ``scene_t`` is the scene bound to the parameters
    (``scene_tensors.bind_params``); its probes trace through its own
    mode's kernel.  The image is 0 in the forward pass; its gradient
    with respect to ``geom.p0`` / ``geom.p1`` / ``geom.radius`` (and
    ``materials.ior`` through the glass families) is the edge-sampled
    boundary term of the expected image.

    ``geom`` is the NumPy geometry ``scene_t`` was uploaded from
    (``SceneTensors.host_geom``: in BVH mode the leaf order of
    ``render.prepare_scene``, in cluster mode its padded cluster order);
    None takes the scene's own, the sweep mode's.  The primitive ids
    (``sphere_ids`` ... ``glass_shells``; by default the selectors above,
    which skip pad slots) index that geometry, and the correction
    raises on a ``scene_t`` uploaded from any other.  ``n_edge``
    samples per sphere and per curved pair, ``n_seg`` per segment,
    ``n_probe`` probes per side, ``eps`` the probe offset in pixels,
    ``mirror_pairs_max`` source spheres or segments per bender, ranked by
    apparent size from the build's positions.  ``stats``: a dict that
    gets, per family, the samples and the probe rays traced, and
    ``edge_blocked_own_rim``, the (sphere id, sample) of each sample of a
    shell outer's own rim that ``_edge_blocked`` dropped, and
    ``probe_waves``, the probes' starting
    wavefronts (``render.WavefrontState``)."""
    from ..render import WavefrontState, bounce_paths

    if geom is not None:
        # The selectors read the first n_prims slots; the geometry of BVH
        # and cluster mode has more (its pads, of type PT_NONE, which no
        # selector takes), so they read every slot of it.
        scene = dataclasses.replace(
            scene, arrays=scene.arrays._replace(geom=geom),
            static=dataclasses.replace(
                scene.static, n_prims=np.asarray(geom.ptype).shape[0]))
    ids_geom = scene.arrays.geom
    background = scene.background
    if sphere_ids is None:
        sphere_ids = sphere_ids_of(scene)
    if rect_ids is None:
        rect_ids = rect_ids_of(scene)
    if box_ids is None:
        box_ids = box_ids_of(scene)
    if mirror_ids is None:
        mirror_ids = mirror_rect_ids_of(scene)
    if mirror_sphere_ids is None:
        mirror_sphere_ids = mirror_sphere_ids_of(scene)
    if glass_sphere_ids is None:
        glass_sphere_ids = glass_sphere_ids_of(scene)
    if glass_shells is None:
        glass_shells = glass_shell_pairs_of(scene)
    sphere_ids = np.asarray(sphere_ids, np.int64)
    rect_ids = np.asarray(rect_ids, np.int64)
    box_ids = np.asarray(box_ids, np.int64)
    mirror_ids = np.asarray(mirror_ids, np.int64)
    mirror_sphere_ids = np.asarray(mirror_sphere_ids, np.int64)
    glass_sphere_ids = np.asarray(glass_sphere_ids, np.int64)
    glass_shells = np.asarray(glass_shells, np.int64).reshape(-1, 2)
    S, E = int(sphere_ids.shape[0]), int(n_edge)
    R, B, E2 = int(rect_ids.shape[0]), int(box_ids.shape[0]), int(n_seg)
    M = int(mirror_ids.shape[0])
    g_host = scene.arrays.geom
    host_p0 = np.asarray(g_host.p0)
    host_r = np.asarray(g_host.radius)
    host_mat = np.asarray(g_host.material).astype(np.int64)

    # Curved-mirror (bender, source sphere) pairs, the largest apparent
    # source first.  Glass spheres (solid ones and shell outers) reflect
    # too (Schlick), so they join the fuzz-0 metal spheres as benders,
    # unless the camera sits inside them.
    cam_o = np.asarray(scene.camera.look_from, np.float64)
    shell_outer_ids = [int(p[0]) for p in glass_shells]
    gl_out = [int(g) for g in list(glass_sphere_ids) + shell_outer_ids
              if np.linalg.norm(host_p0[int(g)] - cam_o)
              > abs(float(host_r[int(g)])) * 1.001]
    refl_bender_ids = np.concatenate(
        [mirror_sphere_ids, np.asarray(gl_out, np.int64)])

    def sphere_pairs(benders, exclude):
        """Per bender, its ranked sources: (bender ids, source ids)."""
        bm, bs = [], []
        for bi, ex in zip(benders, exclude):
            srcs = sphere_ids[~np.isin(sphere_ids, ex)]
            if srcs.size == 0:
                continue
            keep = _apparent_rank(host_p0[srcs], np.abs(host_r[srcs]),
                                  host_p0[int(bi)], mirror_pairs_max)
            bm.extend(int(bi) for _ in keep)
            bs.extend(int(v) for v in srcs[keep])
        return np.asarray(bm, np.int64), np.asarray(bs, np.int64)

    pairs_m, pairs_s = sphere_pairs(refl_bender_ids,
                                    [[b] for b in refl_bender_ids])
    Q = int(pairs_m.shape[0])
    gp_g, gp_s = sphere_pairs(glass_sphere_ids,
                              [[g] for g in glass_sphere_ids])
    GQ = int(gp_g.shape[0])
    # Hollow shells: (outer, inner, source sphere), sphere sources only.
    shp_g, shp_s = sphere_pairs(glass_shells[:, 0],
                                [list(p) for p in glass_shells])
    inner_of = {int(o): int(i) for o, i in glass_shells}
    shp_in = np.asarray([inner_of[int(o)] for o in shp_g], np.int64)
    SQ = int(shp_g.shape[0])

    # Segment pairs through curved mirrors and glass (rect/box sources):
    # one bake of every boundary segment's midpoint and length, then the
    # ranking per bender.  Row r of the segment bank is rect r // 4's
    # edge r % 4 for r < 4R, else box (r - 4R) // 12's edge (r - 4R) % 12.
    K0 = 4 * R + 12 * B
    host_mid = host_len = None
    if K0 and (len(mirror_sphere_ids) or len(glass_sphere_ids)):
        g_cpu = type(g_host)(*(torch.from_numpy(np.asarray(x))
                               for x in g_host))
        mids, lens = [], []
        if R > 0:
            rc_h = _rect_corners(g_cpu, torch.from_numpy(rect_ids)).numpy()
            a = rc_h.reshape(-1, 3)
            bb = np.roll(rc_h, -1, axis=1).reshape(-1, 3)
            mids.append(0.5 * (a + bb))
            lens.append(np.linalg.norm(bb - a, axis=-1))
        if B > 0:
            bc_h = _box_corners(g_cpu, torch.from_numpy(box_ids)).numpy()
            a = bc_h[:, _BOX_EA].reshape(-1, 3)
            bb = bc_h[:, _BOX_EB].reshape(-1, 3)
            mids.append(0.5 * (a + bb))
            lens.append(np.linalg.norm(bb - a, axis=-1))
        host_mid = np.concatenate(mids)
        host_len = np.concatenate(lens)

    def rank_segments(bender_ids):
        bm, bsel = [], []
        if host_mid is not None:
            for bi in bender_ids:
                keep = _apparent_rank(host_mid, host_len, host_p0[int(bi)],
                                      mirror_pairs_max)
                bm.extend(int(bi) for _ in keep)
                bsel.extend(int(v) for v in keep)
        return np.asarray(bm, np.int64), np.asarray(bsel, np.int64)

    cms_m, cms_sel = rank_segments(refl_bender_ids)
    Q2 = int(cms_m.shape[0])
    gls_g, gls_sel = rank_segments(glass_sphere_ids)
    GQ2 = int(gls_g.shape[0])
    # A mirror's own edges reflected in its own plane land on themselves:
    # [M, 4R] rows excluded (rect r owns rows 4r..4r+3).
    if M and R:
        mir_excl = np.repeat(rect_ids[None, :] == mirror_ids[:, None], 4,
                             axis=1)
    else:
        mir_excl = np.zeros((M, 4 * R), bool)

    phis = (np.arange(E, dtype=np.float32) + 0.5) * np.float32(
        2.0 * np.pi / E)
    us = (np.arange(E2, dtype=np.float32) + 0.5) * np.float32(1.0 / E2)
    lens_r = np.float32(float(scene.camera.aperture) / 2.0)
    host = dict(
        phis=phis, us=us,
        tfracs=_tfracs(E, S), tfracs_q=_tfracs(E, Q),
        tfracs_g=_tfracs(E, GQ), tfracs_sh=_tfracs(E, SQ),
        disk_sph=_disk(S, E, 1.0) * lens_r,
        disk_seg=_disk(K0, E2, 2.0) * lens_r,
        disk_q=_disk(Q, E, 3.0) * lens_r,
        disk_q2=_disk(Q2, E2, 4.0) * lens_r,
        disk_g=_disk(GQ, E, 5.0) * lens_r,
        disk_g2=_disk(GQ2, E2, 6.0) * lens_r,
        disk_g3=_disk(GQ, E, 7.0) * lens_r,
        disk_sh=_disk(SQ, E, 8.0) * lens_r,
        keep_seg=[np.ones(R * 4, bool) for _ in range(R > 0)]
        + [np.ones(B * 12, bool) for _ in range(B > 0)]
        + [k for m in range(M)
           for k in ([~mir_excl[m]] if R else [])
           + ([np.ones(B * 12, bool)] if B else [])],
        sphere_ids=sphere_ids, rect_ids=rect_ids, box_ids=box_ids,
        mirror_ids=mirror_ids, pairs_m=pairs_m, pairs_s=pairs_s,
        gp_g=gp_g, gp_s=gp_s, shp_g=shp_g, shp_in=shp_in, shp_s=shp_s,
        cms_m=cms_m, cms_sel=cms_sel, gls_g=gls_g, gls_sel=gls_sel,
        mat_gp_g=host_mat[gp_g], mat_shp_g=host_mat[shp_g],
        mat_gls_g=host_mat[gls_g],
        shell_outer=np.asarray(shell_outer_ids, np.int64),
        own_rim=np.isin(sphere_ids, np.asarray(shell_outer_ids, np.int64)),
    )
    on_device = {}

    def consts(device):
        if device not in on_device:
            on_device[device] = {
                k: ([host_sync(torch.from_numpy(x).to(device)) for x in v]
                    if isinstance(v, list)
                    else host_sync(torch.from_numpy(v).to(device)))
                for k, v in host.items()}
        return on_device[device]

    def probe_radiance(scene_t, basis, xy, time, offs, seed, lanes,
                       keep=None):
        """Mean radiance [N, 3] over ``n_probe`` probes of rays from lens
        points ``origin + offs`` through film points ``xy`` at shutter
        times ``time``; ``lanes`` [N] are the rays' sample indices, which
        key their RNG words (``seed ^ salt``, lane, probe).  ``keep``: a
        list that gets each probe's starting wavefront."""
        n = xy.shape[0]
        s = div_rn(xy[:, 0], float(np.float32(W - 1)))
        t = div_rn(xy[:, 1], float(np.float32(H - 1)))
        o = basis.origin.expand(n, 3) + offs
        d = (basis.lower_left + s[:, None] * basis.horizontal
             + t[:, None] * basis.vertical - basis.origin - offs)
        out = torch.zeros((n, 3), dtype=torch.float32, device=xy.device)
        for p in range(n_probe):
            base = prng.ray_base((seed ^ (_PROBE_SALT + p)) & prng.MASK,
                                 lanes, torch.full_like(lanes, p))
            st = WavefrontState(
                o=o, d=d, time=time, base=base,
                alive=torch.ones(n, dtype=torch.bool, device=xy.device),
                throughput=torch.ones_like(o), radiance=torch.zeros_like(o))
            if keep is not None:
                keep.append(st)
            out = out + bounce_paths(scene_t, background, st, depth)
        return div_rn(out, float(np.float32(n_probe)))

    def finish_part(xy, tau, cen_xy, pre_valid):
        """From sample positions ``xy`` [K,M,2] (with their graph),
        tangents ``tau``, an orientation anchor ``cen_xy`` [K,1,2]
        (normals point away from it) and a validity mask: the flat
        (xy, xy detached, normal, weight, pixel).  The weight is the arc
        length a sample stands for (|tau| carries the span / count)."""
        xy_p = xy.detach()
        tau_p = tau.detach()
        tau_len = torch.sqrt((tau_p * tau_p).sum(-1) + 1e-20)
        nrm = torch.stack([tau_p[..., 1], -tau_p[..., 0]], -1) / (
            tau_len[..., None])
        flip = (nrm * (xy_p - cen_xy)).sum(-1) < 0.0
        nrm = torch.where(flip[..., None], -nrm, nrm)
        ix = _floor_int(xy_p[..., 0])
        iy = _floor_int(xy_p[..., 1])
        inside_img = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        valid = pre_valid & inside_img
        pix = (torch.clamp(iy, 0, H - 1) * W
               + torch.clamp(ix, 0, W - 1)).reshape(-1)
        wgt = (tau_len * valid.to(torch.float32)).reshape(-1)
        return (xy.reshape(-1, 2), xy_p.reshape(-1, 2), nrm.reshape(-1, 2),
                wgt, pix)

    def sanitize(xy, tau, ok):
        """Diverged lanes: xy 0 and tau 1 before they meet any weight (a
        NaN there would poison the sum: NaN * 0 = NaN), and the masked
        centroid of the converged lanes as the orientation anchor."""
        ok3 = ok[..., None]
        xy = torch.where(ok3, xy, 0.0)
        tau = torch.where(ok3, tau.detach(), 1.0)
        wsum = torch.clamp(ok3.sum(1, keepdim=True), min=1)
        cen = xy.detach().sum(1, keepdim=True) / wsum
        return xy, tau, cen

    checked = [ids_geom]  # the last uploaded geometry found to be it

    def correction(scene_t, basis, seed, stats=None):
        if scene_t.host_geom is not checked[0]:
            if not _same_geom(scene_t.host_geom, ids_geom):
                raise ValueError(
                    "silhouette correction: scene_t was uploaded from "
                    "other geometry than its ids index (another "
                    "intersector mode or leaf size?)")
            checked[0] = scene_t.host_geom
        geom = scene_t.arrays.geom
        dev = geom.p0.device
        if S + R + B + Q + GQ + SQ == 0:
            # Nothing edge-worthy (e.g. only media): identically zero.
            return torch.zeros((W * H, 3), dtype=torch.float32, device=dev)
        k = consts(dev)
        bs = CameraBasis(*(host_sync(torch.as_tensor(
            np.asarray(x, np.float32), device=dev)) for x in basis))
        ior_tab = scene_t.arrays.materials.ior
        t0, t1 = bs.time0, bs.time1
        parts, times, offsets, names = [], [], [], []

        def add(name, part, time, off):
            parts.append(part)
            times.append(time.reshape(-1))
            offsets.append(off.reshape(-1, 3))
            names.append(name)

        def lens_offsets(disk):
            return disk[..., 0:1] * bs.u + disk[..., 1:2] * bs.v

        def lerped(ids_p0, ids_p1, ids_t, tfr):
            """Sources' centers at each sample's shutter time [K,E,3]
            (moving spheres lerp; a static one has p1 == p0), and the
            times [K,E]."""
            tt = t0 + tfr * (t1 - t0)
            ts0 = geom.time0[ids_t][:, None]
            ts1 = geom.time1[ids_t][:, None]
            frac = (tt - ts0) / (ts1 - ts0)
            return (ids_p0[:, None, :]
                    + frac[..., None] * (ids_p1 - ids_p0)[:, None, :]), tt

        if M > 0:
            pl_pnt, pl_nrm = _mirror_planes(geom, k["mirror_ids"])

        if S > 0:
            sid = k["sphere_ids"]
            r = geom.radius[sid]
            c, tt = lerped(geom.p0[sid], geom.p1[sid], sid, k["tfracs"])
            # Virtual images: one more family per planar mirror.
            c_all = torch.cat([c] + [_reflect_pts(c, pl_pnt[m], pl_nrm[m])
                                     for m in range(M)])
            nf = M + 1
            r_all = r.repeat(nf)
            tt_all = tt.repeat(nf, 1)
            off_s = lens_offsets(k["disk_sph"]).repeat(nf, 1, 1)
            K = c_all.shape[0]
            args = (c_all, _rows(r_all, K, E), _cols(k["phis"], K), off_s)

            def fn(c_, r_, p_, o_):
                return _edge_xy(c_, r_, p_, o_, bs, W, H)

            xy, cW = _map_samples(fn, *args)
            tau = _map_tangents(fn, 2, *args) * float(_TWO_PI / E)
            # In front of the camera, lens point outside the sphere.
            L_cam = torch.sqrt(((c_all.detach() - bs.origin - off_s) ** 2)
                               .sum(-1))
            pre = (cW.detach() < 0.0) & (
                L_cam > r_all.detach()[:, None] * 1.001)
            if shell_outer_ids:
                # The direct rows (the first S) whose lens-to-edge segment
                # crosses a shell outer belong to the four-interface
                # family; virtual rows keep theirs.
                so = k["shell_outer"]
                gs = geom.p0[so].detach()
                Rs = torch.abs(geom.radius[so]).detach()
                blk = _map_samples(
                    lambda c_, r_, p_, o_: _edge_blocked(c_, r_, p_, o_, bs,
                                                         gs, Rs),
                    c.detach(), _rows(r.detach(), S, E),
                    _cols(k["phis"], S), off_s[:S])
                if stats is not None:
                    own = host_sync(
                        (pre[:S] & blk & k["own_rim"][:, None]).cpu())
                    stats["edge_blocked_own_rim"] = [
                        (int(sphere_ids[i]), j)
                        for i, j in torch.nonzero(own).tolist()]
                pre = torch.cat([pre[:S] & ~blk, pre[S:]])
            cen = xy.detach().mean(1, keepdim=True)
            add("spheres", finish_part(xy, tau, cen, pre), tt_all, off_s)

        if Q > 0:
            # Curved mirrors: one family per (bender, source) pair, the
            # curve solved on the mirror per sample.
            pm, ps = k["pairs_m"], k["pairs_s"]
            mq = _gather(geom.p0, pm)
            Rq = torch.abs(_gather(geom.radius, pm))
            rq = torch.abs(_gather(geom.radius, ps))
            cq, ttq = lerped(_gather(geom.p0, ps), _gather(geom.p1, ps), ps,
                             k["tfracs_q"])
            off_q = lens_offsets(k["disk_q"])
            args = (off_q, _rows(mq, Q, E), _rows(Rq, Q, E), cq,
                    _rows(rq, Q, E), _cols(k["phis"], Q))

            def fn(o_, m_, R_, c_, r_, p_):
                return _curved_mirror_xy(o_, m_, R_, c_, r_, p_, bs, W, H)

            xy, okq = _map_samples(fn, *args)
            tau = _map_tangents(fn, 5, *args) * float(_TWO_PI / E)
            xy, tau, cen = sanitize(xy, tau, okq)
            add("curved_mirror", finish_part(xy, tau, cen, okq), ttq, off_q)

        if GQ > 0:
            # Refracted silhouettes through solid glass: T*T, then T*R*T
            # on the same pairs.  The IOR is the material's parameter.
            gg = _gather(geom.p0, k["gp_g"])
            Rg = torch.abs(_gather(geom.radius, k["gp_g"]))
            iorg = _gather(ior_tab, k["mat_gp_g"])
            rg = torch.abs(_gather(geom.radius, k["gp_s"]))
            cg, ttg = lerped(_gather(geom.p0, k["gp_s"]),
                             _gather(geom.p1, k["gp_s"]), k["gp_s"],
                             k["tfracs_g"])
            for name, disk, exit_fn in (
                    ("glass", k["disk_g"], None),
                    ("glass_trt", k["disk_g3"], _glass_trt_exit_ray)):
                off_g = lens_offsets(disk)
                args = (off_g, _rows(gg, GQ, E), _rows(Rg, GQ, E),
                        _rows(iorg, GQ, E), cg, _rows(rg, GQ, E),
                        _cols(k["phis"], GQ))

                def fn(o_, m_, R_, i_, c_, r_, p_, exit_fn=exit_fn):
                    return _glass_sphere_xy(o_, m_, R_, i_, c_, r_, p_, bs,
                                            W, H, exit_fn=exit_fn)

                xy, okg = _map_samples(fn, *args)
                tau = _map_tangents(fn, 6, *args) * float(_TWO_PI / E)
                xy, tau, cen = sanitize(xy, tau, okg)
                add(name, finish_part(xy, tau, cen, okg), ttg, off_g)

        if SQ > 0:
            # Hollow shells: the tangency through four interfaces; outer
            # radius, bubble radius and IOR are all parameters.
            gsh = _gather(geom.p0, k["shp_g"])
            Rsh = torch.abs(_gather(geom.radius, k["shp_g"]))
            Rin = torch.abs(_gather(geom.radius, k["shp_in"]))
            iors = _gather(ior_tab, k["mat_shp_g"])
            rs_ = torch.abs(_gather(geom.radius, k["shp_s"]))
            cs_, tts = lerped(_gather(geom.p0, k["shp_s"]),
                              _gather(geom.p1, k["shp_s"]), k["shp_s"],
                              k["tfracs_sh"])
            off_sh = lens_offsets(k["disk_sh"])
            args = (off_sh, _rows(gsh, SQ, E), _rows(Rsh, SQ, E),
                    _rows(Rin, SQ, E), _rows(iors, SQ, E), cs_,
                    _rows(rs_, SQ, E), _cols(k["phis"], SQ))

            def fn(o_, m_, R_, Ri_, i_, c_, r_, p_):
                return _glass_sphere_xy(
                    o_, m_, R_, i_, c_, r_, p_, bs, W, H,
                    exit_fn=lambda E_, m2, R2, i2, u2: _glass_shell_exit_ray(
                        E_, m2, R2, i2, u2, Ri_))

            xy, oks = _map_samples(fn, *args)
            tau = _map_tangents(fn, 7, *args) * float(_TWO_PI / E)
            xy, tau, cen = sanitize(xy, tau, oks)
            add("glass_shell", finish_part(xy, tau, cen, oks), tts, off_sh)

        mid_t = t0 + 0.5 * (t1 - t0)
        rc = bc = bn = None
        if R > 0:
            rc = _rect_corners(geom, k["rect_ids"])  # [R,4,3]
        if B > 0:
            bc = _box_corners(geom, k["box_ids"])  # [B,8,3]
            # Each edge's two ends [B,12,3], each end its own corner.
            bca = _box_corners(geom, k["box_ids"], _BOX_EA)
            bcb = _box_corners(geom, k["box_ids"], _BOX_EB)
            bn = _box_edge_normals(geom, k["box_ids"]).detach()

        def corners_center_xy(corners):
            """Mean image position [K, 2] of each solid's corners: the
            projection of a convex solid is convex, so normals pointing
            away from it point out of the silhouette."""
            xy, _ = _map_samples(
                lambda p_: _dir_to_xy(p_ - bs.origin, bs, W, H), corners)
            return xy.mean(1)

        if R + B > 0:
            segA, segB, seg_cen, seg_n = [], [], [], []
            for refl in [None] + [(pl_pnt[m], pl_nrm[m]) for m in range(M)]:
                if R > 0:
                    c4 = rc if refl is None else _reflect_pts(rc, *refl)
                    segA.append(c4.reshape(-1, 3))
                    segB.append(torch.roll(c4, -1, dims=1).reshape(-1, 3))
                    seg_cen.append(corners_center_xy(c4.detach())
                                   .repeat_interleave(4, 0))
                    # A rect's boundary is a silhouette from everywhere:
                    # zero normals mark "no face test".
                    seg_n.append(torch.zeros((R * 4, 2, 3), device=dev))
                if B > 0:
                    if refl is None:
                        c8, ca, cb = bc, bca, bcb
                    else:
                        c8, ca, cb = (_reflect_pts(x, *refl)
                                      for x in (bc, bca, bcb))
                    segA.append(ca.reshape(-1, 3))
                    segB.append(cb.reshape(-1, 3))
                    seg_cen.append(corners_center_xy(c8.detach())
                                   .repeat_interleave(12, 0))
                    n_f = bn if refl is None else _reflect_dirs(
                        bn, refl[1].detach()[None, None, None, :])
                    seg_n.append(n_f.reshape(-1, 2, 3))
            pA, pB = torch.cat(segA), torch.cat(segB)
            K = pA.shape[0]
            u = k["us"]
            off_g = lens_offsets(k["disk_seg"]).repeat(M + 1, 1, 1)
            args = (_rows(pA, K, E2), _rows(pB, K, E2), _cols(u, K), off_g)

            def fn(a_, b_, u_, o_):
                return _seg_xy(a_, b_, u_, o_, bs, W, H)

            xy, cW = _map_samples(fn, *args)
            tau = _map_tangents(fn, 2, *args) * float(np.float32(1.0 / E2))
            # A box edge is kept per sample where its two faces straddle
            # front and back from the sample's own lens point.
            n12 = torch.cat(seg_n)
            is_box = (n12 * n12).sum((-1, -2)) > 0.0
            x_p = (pA.detach()[:, None, :]
                   + u[None, :, None] * (pB.detach() - pA.detach())[:, None])
            v = x_p - bs.origin - off_g
            d1 = (n12[:, None, 0, :] * v).sum(-1)
            d2 = (n12[:, None, 1, :] * v).sum(-1)
            sil = torch.where(is_box[:, None], (d1 * d2) < 0.0, True)
            keep = torch.cat(k["keep_seg"])[:, None]
            pre = sil & (cW.detach() < 0.0) & keep
            cen = torch.cat(seg_cen)[:, None, :]
            add("segments", finish_part(xy, tau, cen, pre),
                mid_t.expand(K * E2), off_g)

        if Q2 > 0 or GQ2 > 0:
            # Every rect/box boundary segment, in the bank's row layout:
            # (pa, pb, face normals, the solid's center).
            bank = [[], [], [], []]
            if R > 0:
                bank[0].append(rc.reshape(-1, 3))
                bank[1].append(torch.roll(rc, -1, dims=1).reshape(-1, 3))
                bank[2].append(torch.zeros((R * 4, 2, 3), device=dev))
                bank[3].append(rc.mean(1).repeat_interleave(4, 0))
            if B > 0:
                bank[0].append(bca.reshape(-1, 3))
                bank[1].append(bcb.reshape(-1, 3))
                bank[2].append(bn.reshape(-1, 2, 3))
                bank[3].append(bc.mean(1).repeat_interleave(12, 0))
            bank = [torch.cat(x) for x in bank]

        def segment_family(name, sel, disk, bender, point_fn, cen_fn):
            """Rect/box segments seen in a curved bender: one chief solve
            per sample; a box edge tested from the sample's reflection or
            exit point; the anchor the image of the solid's center, else
            the converged samples' centroid."""
            n = sel.shape[0]
            pa_b = _gather(bank[0], sel)
            pb_b = _gather(bank[1], sel)
            n12b = bank[2][sel]
            cen3 = bank[3][sel].detach()
            u = k["us"]
            off_b = lens_offsets(disk)
            args = (off_b, *(_rows(x, n, E2) for x in bender),
                    _rows(pa_b, n, E2), _rows(pb_b, n, E2), _cols(u, n))
            xy, ok, x_view = _map_samples(point_fn, *args)
            tau = _map_tangents(point_fn, len(args) - 1, *args) \
                * float(np.float32(1.0 / E2))
            is_box = (n12b * n12b).sum((-1, -2)) > 0.0
            x_p = (pa_b.detach()[:, None, :]
                   + u[None, :, None] * (pb_b.detach()
                                         - pa_b.detach())[:, None, :])
            v = x_p - x_view.detach()
            d1 = (n12b[:, None, 0, :] * v).sum(-1)
            d2 = (n12b[:, None, 1, :] * v).sum(-1)
            ok = ok & torch.where(is_box[:, None], (d1 * d2) < 0.0, True)
            xy, tau, cen_fb = sanitize(xy, tau, ok)
            with torch.no_grad():
                cen_xy, cen_ok = vmap(cen_fn)(
                    *(x.detach() for x in bender), cen3)
            cen = torch.where(cen_ok[:, None, None], cen_xy[:, None],
                              cen_fb)
            add(name, finish_part(xy, tau, cen, ok), mid_t.expand(n * E2),
                off_b)

        zero3 = torch.zeros(3, device=dev)
        if Q2 > 0:
            mq2 = _gather(geom.p0, k["cms_m"])
            Rq2 = torch.abs(_gather(geom.radius, k["cms_m"]))
            segment_family(
                "curved_mirror_segments", k["cms_sel"], k["disk_q2"],
                (mq2, Rq2),
                lambda o_, m_, R_, a_, b_, u_: _curved_mirror_point_xy(
                    o_, m_, R_, a_ + u_ * (b_ - a_), bs, W, H),
                lambda m_, R_, p_: _curved_mirror_point_xy(
                    zero3, m_, R_, p_, bs, W, H)[:2])
        if GQ2 > 0:
            gg2 = _gather(geom.p0, k["gls_g"])
            Rg2 = torch.abs(_gather(geom.radius, k["gls_g"]))
            iorg2 = _gather(ior_tab, k["mat_gls_g"])
            segment_family(
                "glass_segments", k["gls_sel"], k["disk_g2"],
                (gg2, Rg2, iorg2),
                lambda o_, m_, R_, i_, a_, b_, u_: _glass_point_xy(
                    o_, m_, R_, i_, a_ + u_ * (b_ - a_), bs, W, H),
                lambda m_, R_, i_, p_: _glass_point_xy(
                    zero3, m_, R_, i_, p_, bs, W, H)[:2])

        flat_xy = torch.cat([p[0] for p in parts])
        flat_xy_p = torch.cat([p[1] for p in parts])
        flat_n = torch.cat([p[2] for p in parts])
        wgt = torch.cat([p[3] for p in parts])
        pix = torch.cat([p[4] for p in parts])
        flat_t = torch.cat(times).detach()
        flat_off = torch.cat(offsets).detach()

        # The radiance step across the edge: one probe batch for every
        # family.  A sample of weight 0 adds w = 0 whatever its probes
        # see, so only the others are traced, each keyed by its index.
        lanes = host_sync((wgt != 0).nonzero()).squeeze(1)
        step = torch.zeros((wgt.shape[0], 3), device=dev)
        with torch.no_grad():
            if lanes.numel():
                xy_l = flat_xy_p[lanes]
                n_l = flat_n[lanes]
                probe = (scene_t, bs)
                keep = None if stats is None else stats.setdefault(
                    "probe_waves", [])
                rest = (flat_t[lanes], flat_off[lanes], seed, lanes, keep)
                L_in = probe_radiance(*probe, xy_l - float(np.float32(eps))
                                      * n_l, *rest)
                L_out = probe_radiance(*probe, xy_l + float(np.float32(eps))
                                       * n_l, *rest)
                step[lanes] = L_in - L_out
        w = step * wgt[:, None]
        if stats is not None:
            counts = np.cumsum([0] + [p[3].shape[0] for p in parts])
            traced = host_sync((wgt != 0).cpu()).numpy()
            for i, name in enumerate(names):
                sl = slice(counts[i], counts[i + 1])
                stats[name] = {"samples": int(counts[i + 1] - counts[i]),
                               "probe_rays": 2 * n_probe
                               * int(traced[sl].sum())}

        # Straight-through: 0 in the forward pass, tangent sum_k w_k
        # (n_k . dxy_k).  The scatter adds exact zeros, so index_add_'s
        # atomic order cannot show in the forward; its backward is a
        # gather, which has no order to keep.
        drift = ((flat_xy - flat_xy_p) * flat_n).sum(-1)
        img = torch.zeros((W * H, 3), dtype=torch.float32, device=dev)
        return img.index_add(0, pix, w * drift[:, None])

    return correction


def _same_geom(a, b) -> bool:
    """True when the NumPy geometries ``a`` and ``b`` hold the same
    primitives in the same order."""
    return all(x is y or np.array_equal(x, y, equal_nan=True)
               for x, y in zip(a, b))


def _floor_int(x):
    """floor(x) as int64 with XLA's float -> int32 conversion: NaN -> 0,
    saturated to the int32 range."""
    f = torch.floor(x)
    f = torch.where(torch.isnan(f), 0.0, f)
    return torch.clamp(f, -2.0**31, 2.0**31 - 1).to(torch.int64)
