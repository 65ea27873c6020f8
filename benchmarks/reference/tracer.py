"""A plain path tracer of the scene format: the benchmark's reference.

``Reference(scene_arrays, camera, background, device, dtype)`` holds a
scene's arrays as tensors.  ``radiance(W, H, pix, sam, seed, depth)``
gives each camera lane's radiance, in lane order: lane i traces pixel
``pix[i]`` (pixel rows count from the bottom) for sample ``sam[i]``.
With ``params`` (the trainable leaves by their ``group.field`` keys),
the radiance carries gradients to them, under the gradient conventions
of the renderer's documentation: the trace is a discrete search, and the
winner's hit distance is computed again from its fields, so that
gradients reach the geometry through t, the hit point and all that is
shaded from it; a square root's slope is capped at 1e5 (silhouettes).

Every lane runs every bounce until it dies: no chunk, no partition, no
BVH, no kernel.  The closest hit is an all-pairs sweep over the
primitives in blocks, the smallest t winning, the lowest index on a tie.
Semantics (the Rust reference's, as the scene format flattens them):
sphere.rs / moving_sphere.rs (half-b quadratic, nearer root first,
inclusive bounds), rect.rs, cuboid.rs as one slab interval,
constant_medium.rs (entry/exit and an exponential free flight whose
uniform is salted with the primitive's insertion id), baked rigid
transforms (o' = R^T (o - t)), the five materials and four textures of
the scene format, and the integrator of application.rs:477-495 as a loop
whose radiance telescopes to the recursion.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng

T_MIN = 1.0e-3
BIG = float(np.float32(3.0e38))
SLAB_FLOOR = 1e-20
MEDIUM_REHIT_EPS = float(np.float32(1.0e-4))
NEAR_ZERO = 1e-8
SQRT_SLOPE_CAP = 1.0e5
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
INV_TWO_PI = float(np.float32(0.5 / np.pi))
INV_PI = float(np.float32(1.0 / np.pi))

# The scene format's tags (models/scene.py of the scene format).
PT_SPHERE, PT_RECT, PT_MEDIUM_SPHERE, PT_MEDIUM_BOX, PT_BOX = 0, 1, 2, 3, 4
MT_LAMBERTIAN, MT_METAL, MT_DIELECTRIC, MT_LIGHT, MT_ISOTROPIC = 0, 1, 2, 3, 4
TT_SOLID, TT_CHECKER, TT_NOISE, TT_IMAGE = 0, 1, 2, 3
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

class Basis(NamedTuple):
    origin: np.ndarray
    lower_left: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray
    u: np.ndarray
    v: np.ndarray
    lens_radius: np.float32
    time0: np.float32
    time1: np.float32


def make_basis(cfg, width: int, height: int) -> Basis:
    """The thin-lens camera's frame (camera.rs:67-83), in NumPy float32."""
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
    lower_left = (look_from - horizontal / 2.0 - vertical / 2.0
                  - np.float32(cfg.focus_dist) * w)
    f = np.float32
    return Basis(look_from.astype(f), lower_left.astype(f),
                 horizontal.astype(f), vertical.astype(f), u.astype(f),
                 v.astype(f), f(cfg.aperture / 2.0), f(cfg.time0),
                 f(cfg.time1))


class _CappedSqrt(torch.autograd.Function):
    """sqrt, correctly rounded, whose slope is capped (silhouettes)."""

    @staticmethod
    def forward(ctx, x):
        y = _sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * torch.clamp(0.5 / torch.clamp(y, min=1e-30),
                               max=SQRT_SLOPE_CAP)


def _sqrt(x):
    """Correctly rounded: float64's root of a float32 rounds back to the
    float32 root; other dtypes take torch's."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _axis_pick(axis, v):
    """(v[k], v[a], v[b]) of each rect plane tag (rect.rs:54-58)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    vk = torch.where(axis == 0, z, torch.where(axis == 1, x, y))
    va = torch.where(axis == 0, x, torch.where(axis == 1, y, z))
    vb = torch.where(axis == 0, y, torch.where(axis == 1, z, x))
    return vk, va, vb


def _to_object(rot, trans, o, d):
    """o' = R^T (o - t), d' = R^T d, each component summed left to right."""
    def rt(x):
        return torch.stack([(rot[..., 0, i] * x[..., 0]
                             + rot[..., 1, i] * x[..., 1])
                            + rot[..., 2, i] * x[..., 2] for i in range(3)],
                           dim=-1)
    return rt(o - trans), rt(d)


def _slab(p0, p1, o, d):
    d_safe = torch.where(torch.abs(d) < SLAB_FLOOR, SLAB_FLOOR, d)
    inv = 1.0 / d_safe
    t_lo = (p0 - o) * inv
    t_hi = (p1 - o) * inv
    return (torch.minimum(t_lo, t_hi).amax(-1),
            torch.maximum(t_lo, t_hi).amin(-1))


def _roots(center, radius, o, d, capped: bool):
    oc = o - center
    a = _dot3(d, d)
    half_b = _dot3(oc, d)
    c = _dot3(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    exists = disc >= 0.0
    arg = torch.where(exists, torch.clamp(disc, min=1e-30), 1.0)
    sq = _CappedSqrt.apply(arg) if capped else _sqrt(arg)
    return (-half_b - sq) / a, (-half_b + sq) / a, exists


def _medium(t_entry, t_exit, nid, d, u):
    """Free flight inside [entry, exit] (constant_medium.rs:40-76).  A
    primitive that is no medium (nid = 0) takes no distance at all, so
    that its lanes' gradients never meet 0 * log(0)."""
    exists = t_exit >= t_entry + MEDIUM_REHIT_EPS
    t1 = torch.clamp(t_entry, min=T_MIN)
    t2 = torch.clamp(t_exit, max=BIG)
    exists = exists & (t1 < t2)
    t1 = torch.clamp(t1, min=0.0)
    ray_len = _sqrt(_dot3(d, d))
    hit_dist = torch.where(nid < 0.0, nid * torch.log(u), 0.0)
    exists = exists & (hit_dist <= (t2 - t1) * ray_len)
    return torch.where(exists, t1 + hit_dist / ray_len, BIG)


def hit_t(f, o, d, time, bb, capped: bool = False):
    """Hit distance of each (ray, primitive) pair in [T_MIN, BIG], BIG on a
    miss; ``f`` holds the primitives' fields broadcast against the rays'
    (o, d [..., 3], time and the bounce words bb [...])."""
    ptype = f["ptype"]
    if f["xform"] is not None:
        o, d = _to_object(f["xform"][0], f["xform"][1], o, d)
    out = torch.full(torch.broadcast_shapes(ptype.shape, time.shape), BIG,
                     dtype=o.dtype, device=o.device)

    def inrange(t):
        return (t >= T_MIN) & (t <= BIG)

    if f["has"][PT_SPHERE]:
        center = f["center"](time)
        tn, tf, ex = _roots(center, f["radius"], o, d, capped)
        t = torch.where(ex & inrange(tn), tn,
                        torch.where(ex & inrange(tf), tf, BIG))
        out = torch.where(ptype == PT_SPHERE, t, out)
    if f["has"][PT_RECT]:
        ok_, oa, ob = _axis_pick(f["axis"], o)
        dk, da, db = _axis_pick(f["axis"], d)
        p0, p1 = f["p0"], f["p1"]
        parallel = dk == 0.0
        t = (p0[..., 2] - ok_) / torch.where(parallel, 1.0, dk)
        a = oa + t * da
        b = ob + t * db
        ok = (~parallel & inrange(t) & (a >= p0[..., 0]) & (a <= p1[..., 0])
              & (b >= p0[..., 1]) & (b <= p1[..., 1]))
        out = torch.where((ptype == PT_RECT) & ok, t, out)
    if f["has"][PT_BOX] or f["has"][PT_MEDIUM_BOX]:
        entry, exit_ = _slab(f["p0"], f["p1"], o, d)
        ex = exit_ > entry
        if f["has"][PT_BOX]:
            t = torch.where(ex & inrange(entry), entry,
                            torch.where(ex & inrange(exit_), exit_, BIG))
            out = torch.where(ptype == PT_BOX, t, out)
        if f["has"][PT_MEDIUM_BOX]:
            u = rng.uniform(bb, rng.P_MEDIUM, f["stable_id"], o.dtype)
            t = _medium(entry, exit_, f["nid"], d, u)
            out = torch.where((ptype == PT_MEDIUM_BOX) & ex, t, out)
    if f["has"][PT_MEDIUM_SPHERE]:
        tn, tf, ex = _roots(f["p0"], f["radius"], o, d, capped)
        u = rng.uniform(bb, rng.P_MEDIUM, f["stable_id"], o.dtype)
        t = _medium(tn, tf, f["nid"], d, u)
        out = torch.where((ptype == PT_MEDIUM_SPHERE) & ex, t, out)
    return out


class Reference:
    """A scene's arrays on ``device`` in ``dtype`` (the lower-precision
    control runs in bfloat16), and the path tracer over them."""

    def __init__(self, arrays, camera, background, device,
                 dtype=torch.float32, block_pairs: int = 1 << 25):
        self.device = torch.device(device)
        self.dtype = dtype
        self.camera = camera
        self.background = background
        self.block_pairs = block_pairs
        g = arrays.geom
        n = int((np.asarray(g.ptype) >= 0).sum())

        def flt(x):
            return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

        def intg(x):
            return torch.as_tensor(np.asarray(x), device=self.device
                                   ).to(torch.int64)

        self.n = n
        self.fixed = dict(
            ptype=intg(g.ptype[:n]), stable_id=intg(g.stable_id[:n]),
            axis=intg(g.axis[:n]), time0=flt(g.time0[:n]),
            time1=flt(g.time1[:n]), nid=flt(g.neg_inv_density[:n]),
            material=intg(g.material[:n]), rot=flt(g.rot[:n]),
            trans=flt(g.trans[:n]),
            mtype=intg(arrays.materials.mtype),
            texture=intg(arrays.materials.texture),
            ttype=intg(arrays.textures.ttype),
            image_id=intg(arrays.textures.image_id),
            image_wh=intg(arrays.image_wh),
            perlin_vec=flt(arrays.perlin.vectors),
            perm=[intg(p) for p in (arrays.perlin.perm_x,
                                     arrays.perlin.perm_y,
                                     arrays.perlin.perm_z)])
        self.leaves = {
            "geom.p0": flt(g.p0[:n]), "geom.p1": flt(g.p1[:n]),
            "geom.radius": flt(g.radius[:n]),
            "materials.albedo": flt(arrays.materials.albedo),
            "materials.fuzz": flt(arrays.materials.fuzz),
            "materials.ior": flt(arrays.materials.ior),
            "textures.color1": flt(arrays.textures.color1),
            "textures.color2": flt(arrays.textures.color2),
            "textures.scale": flt(arrays.textures.scale),
            "images.None": flt(arrays.images)}
        pt = np.asarray(g.ptype[:n])
        p0, p1 = np.asarray(g.p0[:n]), np.asarray(g.p1[:n])
        sph = pt == PT_SPHERE
        # Spheres that were built moving; the others trace at p0.
        moving = sph & np.any(p1 != p0, axis=-1)
        self.has_motion = bool(moving.any())
        self.moving = torch.as_tensor(moving, device=self.device)
        eye = np.eye(3, dtype=np.float32)
        xf = ~sph & (np.any(np.asarray(g.rot[:n]) != eye, axis=(-2, -1))
                     | np.any(np.asarray(g.trans[:n]) != 0, axis=-1))
        self.has_xform = bool(xf.any())
        self.types = sorted(set(pt.tolist()))
        self.by_type = {t: torch.as_tensor(np.flatnonzero(pt == t),
                                           device=self.device)
                        for t in self.types}

    # -- the fields of primitives ---------------------------------------
    def _prim_fields(self, leaves, idx, trace: bool, only=None):
        """Fields of the primitives ``idx`` (any shape), as the trace or
        the winner's recompute reads them: the trace puts a sphere built
        still at p0, the recompute lerps every sphere of a scene with
        motion."""
        fx = self.fixed
        p0 = leaves["geom.p0"][idx]
        p1 = leaves["geom.p1"][idx]
        t0, t1 = fx["time0"][idx], fx["time1"][idx]
        moving = self.moving[idx] if trace else None

        def center(time):
            if not self.has_motion:
                return p0
            frac = (time - t0) / (t1 - t0)
            c = p0 + frac[..., None] * (p1 - p0)
            return c if moving is None else torch.where(moving[..., None],
                                                        c, p0)

        ptype = fx["ptype"][idx]
        has = {t: (t in self.types if only is None else t == only)
               for t in range(5)}
        return dict(
            ptype=ptype, has=has, p0=p0, p1=p1, center=center,
            radius=leaves["geom.radius"][idx], axis=fx["axis"][idx],
            nid=fx["nid"][idx], stable_id=fx["stable_id"][idx],
            xform=((fx["rot"][idx], fx["trans"][idx]) if self.has_xform
                   else None))

    # -- camera ----------------------------------------------------------
    def camera_rays(self, W, H, pix, sam, seed):
        dt, dev = self.dtype, self.device
        b = make_basis(self.camera, W, H)
        base = rng.ray_base(seed, pix, sam)
        x = (pix % W).to(dt)
        y = (pix // W).to(dt)
        ju = rng.uniform(base, rng.P_CAM_JITTER_U, 0, dt)
        jv = rng.uniform(base, rng.P_CAM_JITTER_V, 0, dt)
        s = (x + ju) / torch.tensor(float(np.float32(W - 1)), dtype=dt,
                                    device=dev)
        t = (y + jv) / torch.tensor(float(np.float32(H - 1)), dtype=dt,
                                    device=dev)

        def vec(a):
            return torch.as_tensor(a, device=dev).to(dt)

        u1 = rng.uniform(base, rng.P_LENS_U, 0, dt)
        u2 = rng.uniform(base, rng.P_LENS_V, 0, dt)
        r = torch.sqrt(u1)
        phi = TWO_PI * u2
        rd = float(b.lens_radius) * torch.stack(
            [r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
        offset = rd[..., 0:1] * vec(b.u) + rd[..., 1:2] * vec(b.v)
        o = vec(b.origin) + offset
        d = (vec(b.lower_left) + s[..., None] * vec(b.horizontal)
             + t[..., None] * vec(b.vertical) - vec(b.origin) - offset)
        ut = rng.uniform(base, rng.P_TIME, 0, dt)
        time = float(b.time0) + ut * float(b.time1 - b.time0)
        return o, d, time, base

    # -- the trace -------------------------------------------------------
    @torch.no_grad()
    def closest(self, leaves, o, d, time, bb):
        """(t, index) of each ray's closest hit (BIG, -1 on a miss): every
        primitive type's pairs in blocks of its own primitives, folded in
        with the smallest t winning and the lowest index on a tie."""
        L = o.shape[0]
        best_t = torch.full((L,), BIG, dtype=o.dtype, device=o.device)
        best_i = torch.full((L,), -1, dtype=torch.int64, device=o.device)
        for ptype in self.types:
            idx_all = self.by_type[ptype]
            cols = max(1, min(idx_all.numel(), self.block_pairs // max(L, 1)))
            rows = max(1, self.block_pairs // cols)
            for r0 in range(0, L, rows):
                r1 = min(L, r0 + rows)
                oo, dd = o[r0:r1, None], d[r0:r1, None]
                tt, bw = time[r0:r1, None], bb[r0:r1, None]
                bt, bi = best_t[r0:r1], best_i[r0:r1]
                for c0 in range(0, idx_all.numel(), cols):
                    idx = idx_all[c0:c0 + cols]
                    f = self._prim_fields(leaves, idx[None], trace=True,
                                          only=ptype)
                    t = hit_t(f, oo, dd, tt, bw)
                    # argmin gives the first of equal minima (torch.min's
                    # index may be any of them on the card).
                    am = torch.argmin(t, dim=1)
                    tm = t.gather(1, am[:, None]).squeeze(1)
                    cand = idx[am]
                    take = (tm < bt) | ((tm == bt) & (cand < bi) & (tm < BIG))
                    bt = torch.where(take, tm, bt)
                    bi = torch.where(take, cand, bi)
                best_t[r0:r1], best_i[r0:r1] = bt, bi
        best_i = torch.where(best_t < BIG, best_i, -1)
        return best_t, best_i

    # -- hit detail, textures, materials ----------------------------------
    def _detail(self, f, o, d, time, t):
        point = o + t[..., None] * d
        if f["xform"] is not None:
            rot = f["xform"][0]
            o_obj, d_obj = _to_object(rot, f["xform"][1], o, d)
        else:
            rot, o_obj, d_obj = None, o, d
        point_obj = o_obj + t[..., None] * d_obj
        ptype = f["ptype"]
        has = f["has"]
        p0, p1 = f["p0"], f["p1"]
        outward = torch.zeros_like(point)
        u = torch.zeros_like(t)
        v = torch.zeros_like(t)
        if has[PT_SPHERE]:
            center = f["center"](time)
            r = f["radius"]
            out_s = (point - center) / torch.where(r == 0.0, 1.0, r)[..., None]
            theta = torch.acos(torch.clamp(-out_s[..., 1], -(1.0 - 1e-7),
                                           1.0 - 1e-7))
            x, z = out_s[..., 0], out_s[..., 2]
            x = torch.where((x == 0.0) & (z == 0.0), 1e-20, x)
            sel = ptype == PT_SPHERE
            outward = torch.where(sel[..., None], out_s, outward)
            u = torch.where(sel, (torch.atan2(-z, x) + PI) * INV_TWO_PI, u)
            v = torch.where(sel, theta * INV_PI, v)
        if has[PT_RECT]:
            axis = f["axis"]
            _, oa, ob = _axis_pick(axis, o_obj)
            _, da, db = _axis_pick(axis, d_obj)
            a0, b0, a1, b1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
            ru = (oa + t * da - a0) / torch.where(a1 > a0, a1 - a0, 1.0)
            rv = (ob + t * db - b0) / torch.where(b1 > b0, b1 - b0, 1.0)
            k = torch.where(axis == 0, 2, axis - 1)
            out_r = torch.nn.functional.one_hot(k, 3).to(o.dtype)
            if rot is not None:
                out_r = (rot * out_r[..., None, :]).sum(-1)
            sel = ptype == PT_RECT
            outward = torch.where(sel[..., None], out_r, outward)
            u = torch.where(sel, ru, u)
            v = torch.where(sel, rv, v)
        if has[PT_BOX]:
            d_safe = torch.where(torch.abs(d_obj) < SLAB_FLOOR, SLAB_FLOOR,
                                 d_obj)
            inv = 1.0 / d_safe
            t_lo = (p0 - o_obj) * inv
            t_hi = (p1 - o_obj) * inv
            cand = torch.cat([torch.minimum(t_lo, t_hi),
                              torch.maximum(t_lo, t_hi)], dim=-1)
            face = torch.argmin(torch.abs(cand - t[..., None]), dim=-1) % 3
            out_b = torch.nn.functional.one_hot(face, 3).to(o.dtype)
            if rot is not None:
                out_b = (rot * out_b[..., None, :]).sum(-1)
            span = p1 - p0
            rel = (point_obj - p0) / torch.where(span > 0.0, span, 1.0)
            rx, ry, rz = rel[..., 0], rel[..., 1], rel[..., 2]
            bu = torch.where(face == 0, ry, torch.where(face == 1, rz, rx))
            bv = torch.where(face == 0, rz, torch.where(face == 1, rx, ry))
            sel = ptype == PT_BOX
            outward = torch.where(sel[..., None], out_b, outward)
            u = torch.where(sel, bu, u)
            v = torch.where(sel, bv, v)
        front = (d * outward).sum(-1) < 0.0
        normal = torch.where(front[..., None], outward, -outward)
        return point, normal, front, u, v

    def _noise(self, p):
        vec = self.fixed["perlin_vec"]
        perm = self.fixed["perm"]
        pf = torch.floor(p)
        ijk = pf.to(torch.int64)
        s = p - pf
        s = s * s * (3.0 - 2.0 * s)
        acc = None
        for dx in (0, 1):
            px = perm[0][(ijk[..., 0] + dx) & 0xFF]
            for dy in (0, 1):
                py = perm[1][(ijk[..., 1] + dy) & 0xFF]
                for dz in (0, 1):
                    pz = perm[2][(ijk[..., 2] + dz) & 0xFF]
                    g = vec[px ^ py ^ pz]
                    wv = (g[..., 0] * (s[..., 0] - dx)
                          + g[..., 1] * (s[..., 1] - dy)) \
                        + g[..., 2] * (s[..., 2] - dz)
                    wx = s[..., 0] if dx else 1.0 - s[..., 0]
                    wy = s[..., 1] if dy else 1.0 - s[..., 1]
                    wz = s[..., 2] if dz else 1.0 - s[..., 2]
                    term = (wx * wy) * wz * wv
                    acc = term if acc is None else acc + term
        return acc

    def _texture(self, leaves, tex, point, u, v):
        fx = self.fixed
        ttype = fx["ttype"][tex]
        c1 = leaves["textures.color1"][tex]
        value = c1
        present = set(torch.unique(ttype).tolist())
        if TT_CHECKER in present:
            sines = (torch.sin(10.0 * point[..., 0])
                     * torch.sin(10.0 * point[..., 1])
                     * torch.sin(10.0 * point[..., 2]))
            chk = torch.where((sines < 0.0)[..., None], c1,
                              leaves["textures.color2"][tex])
            value = torch.where((ttype == TT_CHECKER)[..., None], chk, value)
        if TT_NOISE in present:
            sel = (ttype == TT_NOISE).nonzero().squeeze(1)
            if sel.numel():
                sp = leaves["textures.scale"][tex[sel]][..., None] \
                    * point[sel]
                turb = None
                for k in range(7):
                    term = float(0.5 ** k) * self._noise(sp * float(2 ** k))
                    turb = term if turb is None else turb + term
                marble = 0.5 * (1.0 + torch.sin(sp[..., 2]
                                                + 10.0 * torch.abs(turb)))
                value = value.index_put((sel,), marble[..., None].expand(
                    -1, 3))
        if TT_IMAGE in present:
            images = leaves["images.None"]
            ni, ih, iw, _ = images.shape
            img = fx["image_id"][tex]
            wh = fx["image_wh"][img]
            uu = torch.clamp(u, 0.0, 1.0)
            vv = 1.0 - torch.clamp(v, 0.0, 1.0)
            i = torch.minimum((uu * wh[..., 0].to(u.dtype)).to(torch.int64),
                              wh[..., 0] - 1)
            j = torch.minimum((vv * wh[..., 1].to(u.dtype)).to(torch.int64),
                              wh[..., 1] - 1)
            row = (img * (ih * iw) + j * iw + i).clamp(0, ni * ih * iw - 1)
            texel = images.reshape(-1, 3)[row]
            value = torch.where((ttype == TT_IMAGE)[..., None], texel, value)
        return value

    def _scatter(self, leaves, mat, d, point, normal, front, u, v, bb):
        fx = self.fixed
        dt = d.dtype
        mtype = fx["mtype"][mat]
        tex = self._texture(leaves, fx["texture"][mat], point, u, v)
        zero = torch.zeros_like(point)
        emitted, att, direction = zero, zero, zero
        scatter = torch.zeros_like(mtype, dtype=torch.bool)
        present = set(torch.unique(mtype).tolist())

        def unit_vec(u1, u2):
            z = 1.0 - 2.0 * u1
            r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            phi = TWO_PI * u2
            return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                               dim=-1)

        def unit(x):
            return x / torch.sqrt((x * x).sum(-1, keepdim=True))

        def reflect(x, n):
            return x - 2.0 * (x * n).sum(-1, keepdim=True) * n

        if MT_LAMBERTIAN in present:
            sd = normal + unit_vec(rng.uniform(bb, rng.P_LAMBERT_A, 0, dt),
                                   rng.uniform(bb, rng.P_LAMBERT_B, 0, dt))
            near = torch.all(torch.abs(sd) < NEAR_ZERO, dim=-1, keepdim=True)
            sd = torch.where(near, normal, sd)
            sel = mtype == MT_LAMBERTIAN
            direction = torch.where(sel[..., None], sd, direction)
            att = torch.where(sel[..., None], tex, att)
            scatter = scatter | sel
        if MT_METAL in present or MT_ISOTROPIC in present:
            ball = unit_vec(rng.uniform(bb, rng.P_SPHERE_A, 0, dt),
                            rng.uniform(bb, rng.P_SPHERE_B, 0, dt)) \
                * (rng.uniform(bb, rng.P_SPHERE_C, 0, dt)
                   ** (1.0 / 3.0))[..., None]
        if MT_METAL in present:
            sd = reflect(unit(d), normal) \
                + leaves["materials.fuzz"][mat][..., None] * ball
            ok = (sd * normal).sum(-1) > 0.0
            sel = mtype == MT_METAL
            direction = torch.where(sel[..., None], sd, direction)
            att = torch.where(sel[..., None],
                              leaves["materials.albedo"][mat], att)
            scatter = torch.where(sel, ok, scatter)
        if MT_DIELECTRIC in present:
            ior = leaves["materials.ior"][mat]
            ratio = torch.where(front, 1.0 / ior, ior)
            ud = unit(d)
            cos_t = torch.clamp((-ud * normal).sum(-1), max=1.0)
            sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
            cannot = (ratio * ratio * sin2) > 1.0
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            om = 1.0 - cos_t
            schlick = r0 + (1.0 - r0) * om * om * om * om * om
            refl = cannot | (schlick > rng.uniform(bb, rng.P_DIELECTRIC, 0,
                                                   dt))
            ct = torch.clamp((-ud * normal).sum(-1, keepdim=True), max=1.0)
            perp = ratio[..., None] * (ud + ct * normal)
            par = -torch.sqrt(torch.clamp(torch.abs(
                1.0 - (perp * perp).sum(-1, keepdim=True)), min=1e-12)) \
                * normal
            sd = torch.where(refl[..., None], reflect(ud, normal), perp + par)
            sel = mtype == MT_DIELECTRIC
            direction = torch.where(sel[..., None], sd, direction)
            att = torch.where(sel[..., None], torch.ones_like(tex), att)
            scatter = scatter | sel
        if MT_LIGHT in present:
            sel = mtype == MT_LIGHT
            emitted = torch.where(sel[..., None], tex, emitted)
            scatter = scatter & ~sel
        if MT_ISOTROPIC in present:
            sel = mtype == MT_ISOTROPIC
            direction = torch.where(sel[..., None], ball, direction)
            att = torch.where(sel[..., None], tex, att)
            scatter = scatter | sel
        return emitted, att, direction, scatter

    # -- the integrator ----------------------------------------------------
    def radiance(self, W, H, pix, sam, seed, depth, params=None):
        """Radiance [N, 3] of the camera lanes (pix, sam), in lane order.
        ``params``: leaves that replace the scene's own, by key; the
        radiance then carries gradients to them."""
        leaves = dict(self.leaves)
        if params is not None:
            leaves.update({k: v.to(self.dtype) for k, v in params.items()})
        diff = params is not None
        traced = {k: v.detach() for k, v in leaves.items()}
        o, d, time, base = self.camera_rays(W, H, pix, sam, seed)
        n = o.shape[0]
        throughput = torch.ones_like(o)
        rad = torch.zeros_like(o)
        out = torch.zeros_like(o)
        slot = torch.arange(n, device=o.device)
        bg_const = None if self.background is None else torch.as_tensor(
            self.background, device=o.device).to(o.dtype)
        for bounce in range(depth):
            bb = rng.bounce_base(base, bounce)
            t, idx = self.closest(traced, o, d, time, bb)
            hit = idx >= 0
            if bg_const is None:
                unit_y = d[:, 1] / torch.sqrt((d * d).sum(-1))
                sky = (0.5 * (unit_y + 1.0))[:, None]
                bg = (1.0 - sky) * o.new_tensor(SKY_WHITE) \
                    + sky * o.new_tensor(SKY_BLUE)
            else:
                bg = bg_const
            rad = rad + torch.where((~hit)[:, None], throughput * bg, 0.0)
            # Only the lanes that hit are shaded, each group of one
            # primitive type, material and texture by itself: a branch a
            # lane does not take is not computed for it, so its gradient
            # never meets that branch's value (a zero direction, a log 0).
            h = hit.nonzero().squeeze(1)
            fx = self.fixed
            mat = fx["material"][idx[h]]
            key = (fx["ptype"][idx[h]] * 64 + fx["mtype"][mat] * 8
                   + fx["ttype"][fx["texture"][mat]])
            alive = torch.zeros_like(hit)
            o_new, d_new, thr_new = o, d, throughput
            for k in torch.unique(key).tolist():
                g = h[key == k]
                f = self._prim_fields(leaves, idx[g], trace=False,
                                      only=k // 64)
                og, dg, tg, bg_ = o[g], d[g], time[g], bb[g]
                th = t[g]
                if diff:
                    t_re = hit_t(f, og, dg, tg, bg_, capped=True)
                    th = torch.where(t_re < 0.5 * BIG, t_re, th)
                point, normal, front, u, v = self._detail(f, og, dg, tg, th)
                emitted, att, sdir, scat = self._scatter(
                    leaves, fx["material"][idx[g]], dg, point, normal, front,
                    u, v, bg_)
                thr_g = throughput[g]
                rad = rad.index_add(0, g, thr_g * emitted)
                alive = alive.index_copy(0, g, scat)
                thr_new = thr_new.index_copy(
                    0, g, torch.where(scat[:, None], thr_g * att, thr_g))
                o_new = o_new.index_copy(
                    0, g, torch.where(scat[:, None], point, og))
                d_new = d_new.index_copy(
                    0, g, torch.where(scat[:, None], sdir, dg))
            o, d, throughput = o_new, d_new, thr_new
            out = out.index_put((slot,), rad)
            keep = alive.nonzero().squeeze(1)
            if keep.numel() == 0:
                break
            if keep.numel() < slot.numel():
                o, d, time, base = o[keep], d[keep], time[keep], base[keep]
                throughput, rad, slot = throughput[keep], rad[keep], \
                    slot[keep]
        return out


def pixel_sums(ref: Reference, W, H, pix, spp, seed, depth, block=4096):
    """Each pixel's sum over samples 0..spp-1 of its radiance, the samples
    added one after the other in float32 (as a render accumulates them):
    [len(pix), 3].  ``block``: pixels traced together."""
    sums = []
    for p0 in range(0, pix.numel(), block):
        p = pix[p0:p0 + block]
        lanes_p = p.repeat(spp)
        lanes_s = torch.arange(spp, device=p.device).repeat_interleave(
            p.numel())
        rad = ref.radiance(W, H, lanes_p, lanes_s, seed, depth)
        acc = torch.zeros((p.numel(), 3), dtype=torch.float32,
                          device=p.device)
        for sample in rad.reshape(spp, p.numel(), 3):
            acc.add_(sample.float())
        sums.append(acc)
    return torch.cat(sums)


# The trainable leaves, by the keys ``radiance(params=)`` takes: (group,
# field) of the scene's arrays, field None for the group itself.
PARAM_PATHS = (
    ("geom", "p0"), ("geom", "p1"), ("geom", "radius"),
    ("materials", "albedo"), ("materials", "fuzz"), ("materials", "ior"),
    ("textures", "color1"), ("textures", "color2"), ("textures", "scale"),
    ("images", None),
)


def scene_leaves(arrays) -> dict:
    """The trainable leaves of a scene's arrays as float32 NumPy, whole
    (padding rows included), by their ``group.field`` keys."""
    out = {}
    for group, field in PARAM_PATHS:
        node = getattr(arrays, group)
        leaf = node if field is None else getattr(node, field)
        out[f"{group}.{field}"] = np.asarray(leaf, np.float32)
    return out


def for_scene(name: str, device, dtype=torch.float32) -> Reference:
    """The reference over the scene ``name``, built here from the scene
    format's own builders (``builders.py``), not from the renderer's;
    ``.arrays`` holds the scene's arrays as built."""
    from .builders import build_scene

    scene = build_scene(name)
    ref = Reference(scene.arrays, scene.camera, scene.background, device,
                    dtype=dtype)
    ref.arrays = scene.arrays
    return ref
