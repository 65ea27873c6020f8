"""The scene format, as arrays: a frozen copy of the JAX package's
``hyper_ray_tracer_tpu/models/scene.py`` at commit ``7eb49fb`` (its
``SceneBuilder`` flattens primitives, materials and textures into the
structure of arrays that ``tracer.Reference`` reads), so that the
reference builds each scene itself.  Only this docstring and the import
of the Perlin tables changed; the flattening rules are in the original's
docstring.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .perlin import PerlinTables, make_tables

# Primitive type tags.
PT_SPHERE = 0
PT_RECT = 1
PT_MEDIUM_SPHERE = 2
PT_MEDIUM_BOX = 3
PT_BOX = 4
PT_NONE = -1  # padding; never hit

# Rect plane tags -> (k_axis, a_axis, b_axis), matching rect.rs:54-58.
PLANE_XY = 0  # k on z
PLANE_YZ = 1  # k on x
PLANE_ZX = 2  # k on y
PLANE_AXES = {PLANE_XY: (2, 0, 1), PLANE_YZ: (0, 1, 2), PLANE_ZX: (1, 2, 0)}

# Material type tags.
MT_LAMBERTIAN = 0
MT_METAL = 1
MT_DIELECTRIC = 2
MT_DIFFUSE_LIGHT = 3
MT_ISOTROPIC = 4

# Texture type tags.
TT_SOLID = 0
TT_CHECKER = 1
TT_NOISE = 2
TT_IMAGE = 3

RECT_PAD = 1e-4  # thin-axis AABB padding, rect.rs:88-103


class GeometrySoA(NamedTuple):
    ptype: np.ndarray  # [P] int32
    stable_id: np.ndarray  # [P] int32 insertion-order id; survives BVH
    # reordering so ordering-independent RNG salts (media free flight)
    # stay identical between the oracle, the scan path, and the BVH path.
    p0: np.ndarray  # [P,3] f32
    p1: np.ndarray  # [P,3] f32
    radius: np.ndarray  # [P] f32
    axis: np.ndarray  # [P] int32 (rect plane)
    time0: np.ndarray  # [P] f32
    time1: np.ndarray  # [P] f32
    neg_inv_density: np.ndarray  # [P] f32
    material: np.ndarray  # [P] int32
    rot: np.ndarray  # [P,3,3] f32 world-from-object
    trans: np.ndarray  # [P,3] f32
    aabb_min: np.ndarray  # [P,3] f32 world AABB over shutter [0,1]
    aabb_max: np.ndarray  # [P,3] f32


class MaterialSoA(NamedTuple):
    mtype: np.ndarray  # [M] int32
    texture: np.ndarray  # [M] int32
    albedo: np.ndarray  # [M,3] f32 (metal only, metal.rs:20)
    fuzz: np.ndarray  # [M] f32
    ior: np.ndarray  # [M] f32


class TextureSoA(NamedTuple):
    ttype: np.ndarray  # [T] int32
    color1: np.ndarray  # [T,3] f32 (solid color / checker odd)
    color2: np.ndarray  # [T,3] f32 (checker even)
    scale: np.ndarray  # [T] f32 (noise)
    image_id: np.ndarray  # [T] int32


class SceneArrays(NamedTuple):
    """The device-side pytree: everything the renderer traces over."""

    geom: GeometrySoA
    materials: MaterialSoA
    textures: TextureSoA
    perlin: PerlinTables
    images: np.ndarray  # [NI, IH, IW, 3] f32 in [0,1]
    image_wh: np.ndarray  # [NI, 2] int32 (width, height) of valid region


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable trace-time metadata; drives specialisation of the renderer."""

    n_prims: int  # real primitives (before padding)
    n_prims_padded: int
    has_ray_xform: bool  # any rect/box with a non-identity rotation
    has_media: bool
    has_boxes: bool  # any PT_BOX (solid cuboid) primitive
    has_motion: bool
    has_noise_tex: bool
    has_image_tex: bool
    has_checker_tex: bool
    mat_types: Tuple[int, ...]  # sorted set of MT_* present


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Per-scene camera table entry (application.rs:125-211)."""

    look_from: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    fov: float  # vertical, degrees
    aperture: float
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 1.0


@dataclasses.dataclass
class Scene:
    arrays: SceneArrays
    static: SceneStatic
    camera: CameraConfig
    background: Tuple[float, float, float]
    name: str = "scene"


def rotation_matrix(axis: int, angle_deg: float) -> np.ndarray:
    """World-from-object rotation matching rotation.rs:36-40,102-133.

    axis: 0=X, 1=Y, 2=Z.  The reference's per-axis index shuffle is exactly
    the standard right-handed rotation matrix about that axis.
    """
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    if axis == 0:
        m = [[1, 0, 0], [0, c, -s], [0, s, c]]
    elif axis == 1:
        m = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    elif axis == 2:
        m = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    else:
        raise ValueError(f"bad axis {axis}")
    return np.asarray(m, dtype=np.float32)


def _identity_xform():
    return np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32)


def _rotate_aabb(mn, mx, rot, trans):
    """World AABB of a rotated+translated box: transform all 8 corners
    (rotation.rs:43-89 semantics, generalised to a full matrix)."""
    pts = []
    for ix in range(2):
        for iy in range(2):
            for iz in range(2):
                p = np.array(
                    [
                        mx[0] if ix else mn[0],
                        mx[1] if iy else mn[1],
                        mx[2] if iz else mn[2],
                    ],
                    dtype=np.float32,
                )
                pts.append(rot @ p + trans)
    pts = np.stack(pts)
    return pts.min(0), pts.max(0)


class SceneBuilder:
    """Accumulates primitives/materials/textures, then flattens to SoA."""

    def __init__(self, perlin_seed: int = 0):
        self._prims: List[dict] = []
        self._mats: List[dict] = []
        self._texs: List[dict] = []
        self._images: List[np.ndarray] = []  # each [H,W,3] f32
        self._perlin_seed = perlin_seed

    # ---- textures -------------------------------------------------------
    def solid(self, color) -> int:
        self._texs.append(
            dict(ttype=TT_SOLID, c1=np.float32(color), c2=np.zeros(3, np.float32),
                 scale=0.0, image_id=0)
        )
        return len(self._texs) - 1

    def checker(self, odd, even) -> int:
        """3-D sine checker over two solid colors (checker_texture.rs:22-30)."""
        self._texs.append(
            dict(ttype=TT_CHECKER, c1=np.float32(odd), c2=np.float32(even),
                 scale=0.0, image_id=0)
        )
        return len(self._texs) - 1

    def noise(self, scale: float) -> int:
        self._texs.append(
            dict(ttype=TT_NOISE, c1=np.zeros(3, np.float32),
                 c2=np.zeros(3, np.float32), scale=float(scale), image_id=0)
        )
        return len(self._texs) - 1

    def image(self, pixels: np.ndarray) -> int:
        """Image texture from an [H,W,3] uint8 or float array
        (image_texture.rs:19-32; lookup semantics in ops/textures.py)."""
        px = np.asarray(pixels)
        if px.dtype == np.uint8:
            px = px.astype(np.float32) / 255.0
        self._images.append(px.astype(np.float32))
        self._texs.append(
            dict(ttype=TT_IMAGE, c1=np.zeros(3, np.float32),
                 c2=np.zeros(3, np.float32), scale=0.0,
                 image_id=len(self._images) - 1)
        )
        return len(self._texs) - 1

    # ---- materials ------------------------------------------------------
    def lambertian(self, texture_id: int) -> int:
        return self._mat(MT_LAMBERTIAN, texture=texture_id)

    def metal(self, albedo, fuzz: float) -> int:
        return self._mat(MT_METAL, albedo=np.float32(albedo), fuzz=float(fuzz))

    def dielectric(self, ior: float) -> int:
        return self._mat(MT_DIELECTRIC, ior=float(ior))

    def diffuse_light(self, texture_id: int) -> int:
        return self._mat(MT_DIFFUSE_LIGHT, texture=texture_id)

    def isotropic(self, texture_id: int) -> int:
        return self._mat(MT_ISOTROPIC, texture=texture_id)

    def _mat(self, mtype, texture=0, albedo=None, fuzz=0.0, ior=1.0) -> int:
        self._mats.append(
            dict(mtype=mtype, texture=texture,
                 albedo=np.zeros(3, np.float32) if albedo is None else albedo,
                 fuzz=fuzz, ior=ior)
        )
        return len(self._mats) - 1

    # ---- primitives -----------------------------------------------------
    def sphere(self, center, radius: float, material: int,
               rot: Optional[np.ndarray] = None, trans=None):
        """Static sphere (sphere.rs).  A transform folds into the center."""
        self.moving_sphere(center, center, 0.0, 1.0, radius, material,
                           rot=rot, trans=trans)

    def spheres(self, centers: np.ndarray, radii, material):
        """Bulk static spheres (identity transform): one call for K
        primitives.  ``centers`` [K,3]; ``radii`` scalar or [K];
        ``material`` scalar or [K] material ids.  Semantically identical
        to K ``sphere()`` calls in order, without the per-call transform
        bake; together with the vectorised finalize (sort key / AABBs /
        flags) a 598k-sphere build takes ~8 s instead of ~30 s."""
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        K = centers.shape[0]
        radii = np.broadcast_to(np.asarray(radii, np.float32), (K,))
        material = np.broadcast_to(np.asarray(material, np.int32), (K,))
        eye = np.eye(3, dtype=np.float32)
        zero3 = np.zeros(3, np.float32)
        self._prims.extend(
            dict(ptype=PT_SPHERE, p0=c, p1=c, radius=float(r), axis=0,
                 time0=0.0, time1=1.0, nid=0.0, material=int(m), rot=eye,
                 trans=zero3)
            for c, r, m in zip(centers, radii, material)
        )

    def moving_sphere(self, center0, center1, time0: float, time1: float,
                      radius: float, material: int,
                      rot: Optional[np.ndarray] = None, trans=None):
        """Sphere with lerped center over [time0, time1] (moving_sphere.rs)."""
        r, t = _identity_xform()
        if rot is not None:
            r = np.asarray(rot, np.float32)
        if trans is not None:
            t = np.asarray(trans, np.float32)
        c0 = r @ np.float32(center0) + t  # bake: rotated sphere is a sphere
        c1 = r @ np.float32(center1) + t
        self._prims.append(
            dict(ptype=PT_SPHERE, p0=c0, p1=c1, radius=float(radius),
                 axis=0, time0=float(time0), time1=float(time1), nid=0.0,
                 material=material, rot=np.eye(3, dtype=np.float32),
                 trans=np.zeros(3, np.float32))
        )

    def rect(self, plane: int, a0: float, a1: float, b0: float, b1: float,
             k: float, material: int,
             rot: Optional[np.ndarray] = None, trans=None,
             *, _ptype: int = PT_RECT, _nid: float = 0.0):
        """Axis-aligned rect in object space (rect.rs:13-17)."""
        r, t = _identity_xform()
        if rot is not None:
            r = np.asarray(rot, np.float32)
        if trans is not None:
            t = np.asarray(trans, np.float32)
        if np.allclose(r, np.eye(3)) and np.any(t != 0.0):
            # Pure translation folds into the rect parameters.
            ka, aa, ba = PLANE_AXES[plane]
            a0, a1 = a0 + t[aa], a1 + t[aa]
            b0, b1 = b0 + t[ba], b1 + t[ba]
            k = k + t[ka]
            r, t = _identity_xform()
        self._prims.append(
            dict(ptype=_ptype, p0=np.float32([a0, b0, k]),
                 p1=np.float32([a1, b1, 0.0]), radius=0.0, axis=plane,
                 time0=0.0, time1=1.0, nid=_nid, material=material,
                 rot=r, trans=t)
        )

    def cuboid(self, box_min, box_max, material: int,
               rot: Optional[np.ndarray] = None, trans=None):
        """Axis-aligned box (cuboid.rs:31-88) as ONE PT_BOX slab primitive.

        Hit semantics are equivalent to the reference's 6-rect ``List``
        scan (see the module docstring); the final scene's 400 ground
        cuboids cost 400 slab columns in the dense sweep instead of 2400
        rect columns.  A pure translation folds into the box bounds; a
        rotation is stored as the per-primitive baked transform.
        """
        mn, mx = np.float32(box_min), np.float32(box_max)
        r, t = _identity_xform()
        if rot is not None:
            r = np.asarray(rot, np.float32)
        if trans is not None:
            t = np.asarray(trans, np.float32)
        if np.allclose(r, np.eye(3)) and np.any(t != 0.0):
            mn, mx = mn + t, mx + t
            r, t = _identity_xform()
        self._prims.append(
            dict(ptype=PT_BOX, p0=mn, p1=mx, radius=0.0, axis=0,
                 time0=0.0, time1=1.0, nid=0.0, material=material,
                 rot=r, trans=t)
        )

    def cuboid_rects(self, box_min, box_max, material: int,
                     rot: Optional[np.ndarray] = None, trans=None):
        """The reference's literal 6-rect decomposition (cuboid.rs:31-88),
        same face order.  Kept as the semantic ground truth that
        tests/test_box.py proves PT_BOX equivalent to."""
        mn, mx = np.float32(box_min), np.float32(box_max)
        faces = [
            (PLANE_XY, mn[0], mx[0], mn[1], mx[1], mx[2]),
            (PLANE_XY, mn[0], mx[0], mn[1], mx[1], mn[2]),
            (PLANE_ZX, mn[2], mx[2], mn[0], mx[0], mx[1]),
            (PLANE_ZX, mn[2], mx[2], mn[0], mx[0], mn[1]),
            (PLANE_YZ, mn[1], mx[1], mn[2], mx[2], mx[0]),
            (PLANE_YZ, mn[1], mx[1], mn[2], mx[2], mn[0]),
        ]
        for plane, a0, a1, b0, b1, k in faces:
            self.rect(plane, a0, a1, b0, b1, k, material, rot=rot, trans=trans)

    def medium_sphere(self, center, radius: float, density: float,
                      texture_id: int,
                      rot: Optional[np.ndarray] = None, trans=None):
        """ConstantMedium with a sphere boundary (constant_medium.rs)."""
        r, t = _identity_xform()
        if rot is not None:
            r = np.asarray(rot, np.float32)
        if trans is not None:
            t = np.asarray(trans, np.float32)
        c = r @ np.float32(center) + t
        mat = self.isotropic(texture_id)
        self._prims.append(
            dict(ptype=PT_MEDIUM_SPHERE, p0=c, p1=c, radius=float(radius),
                 axis=0, time0=0.0, time1=1.0,
                 nid=float(-1.0 / density), material=mat,
                 rot=np.eye(3, dtype=np.float32), trans=np.zeros(3, np.float32))
        )

    def medium_box(self, box_min, box_max, density: float, texture_id: int,
                   rot: Optional[np.ndarray] = None, trans=None):
        """ConstantMedium with a cuboid boundary (cornell-smoke,
        application.rs:786-813)."""
        r, t = _identity_xform()
        if rot is not None:
            r = np.asarray(rot, np.float32)
        if trans is not None:
            t = np.asarray(trans, np.float32)
        mat = self.isotropic(texture_id)
        self._prims.append(
            dict(ptype=PT_MEDIUM_BOX, p0=np.float32(box_min),
                 p1=np.float32(box_max), radius=0.0, axis=0,
                 time0=0.0, time1=1.0, nid=float(-1.0 / density),
                 material=mat, rot=r, trans=t)
        )

    # ---- finalisation ---------------------------------------------------
    def _prim_aabb(self, p) -> Tuple[np.ndarray, np.ndarray]:
        """World-space AABB over shutter time [0,1]."""
        pt = p["ptype"]
        if pt in (PT_SPHERE, PT_MEDIUM_SPHERE):
            # abs: a negative radius (hollow-glass trick) still bounds the
            # same ball; the reference would produce an inverted AABB here
            # (sphere.rs:77-83) but never BVH-wraps such a sphere.
            rv = np.full(3, abs(p["radius"]), np.float32)
            mn = np.minimum(p["p0"], p["p1"]) - rv
            mx = np.maximum(p["p0"], p["p1"]) + rv
            return mn, mx
        if pt == PT_RECT:
            ka, aa, ba = PLANE_AXES[p["axis"]]
            mn = np.zeros(3, np.float32)
            mx = np.zeros(3, np.float32)
            a0, b0, k = p["p0"]
            a1, b1, _ = p["p1"]
            mn[aa], mx[aa] = a0, a1
            mn[ba], mx[ba] = b0, b1
            mn[ka], mx[ka] = k - RECT_PAD, k + RECT_PAD
            return _rotate_aabb(mn, mx, p["rot"], p["trans"])
        if pt in (PT_MEDIUM_BOX, PT_BOX):
            # cuboid.rs:104-106: the box AABB is (min, max) directly —
            # no thin-axis pad, unlike its constituent rects.
            return _rotate_aabb(p["p0"], p["p1"], p["rot"], p["trans"])
        raise ValueError(f"bad ptype {pt}")

    def finalize(self, camera: CameraConfig, background, name: str,
                 pad_to_multiple: int = 1) -> Scene:
        n = len(self._prims)
        if n == 0:
            raise ValueError("no primitives in scene")

        # Canonical primitive order: stable-sorted by (type, transform
        # presence, plane axis).  This is THE order everywhere (oracle,
        # renderer, trainable arrays), so closest-hit tie-breaks stay
        # consistent, and it clusters the dense sweep's run-aligned tiles
        # into type- and axis-pure runs whose intersection math specialises
        # completely (ops/bvh.py:_tile_plan).  List order has no other
        # semantics in the reference (list.rs scans whatever order the
        # builder produced).
        # Vectorised sort key (the per-prim np.array_equal lambda cost
        # ~7 s alone at 598k primitives): exact identity test, matching
        # the original semantics bit for bit.
        eye3 = np.eye(3, dtype=np.float32)
        rots_a = np.stack([p["rot"] for p in self._prims])
        trans_a = np.stack([p["trans"] for p in self._prims])
        xf = ((rots_a != eye3).any((1, 2)) | (trans_a != 0.0).any(1))
        keys = [(p["ptype"], int(xf[i]), p["axis"])
                for i, p in enumerate(self._prims)]
        order = sorted(range(n), key=keys.__getitem__)  # stable, like sort
        self._prims = [self._prims[i] for i in order]

        # AABBs: vectorised fast path for sphere-like prims (the bulk of
        # procedural scenes), per-prim fallback for rects/boxes.
        pt_a = np.array([p["ptype"] for p in self._prims], np.int32)
        sph = (pt_a == PT_SPHERE) | (pt_a == PT_MEDIUM_SPHERE)
        if sph.any():
            p0_a = np.stack([p["p0"] for p in self._prims]).astype(
                np.float32)
            p1_a = np.stack([p["p1"] for p in self._prims]).astype(
                np.float32)
            r_a = np.abs(np.array([p["radius"] for p in self._prims],
                                  np.float32))[:, None]
            mn_a = np.minimum(p0_a, p1_a) - r_a
            mx_a = np.maximum(p0_a, p1_a) + r_a
        aabbs = [
            (mn_a[i], mx_a[i]) if sph[i] else self._prim_aabb(p)
            for i, p in enumerate(self._prims)
        ]

        n_pad = -(-n // pad_to_multiple) * pad_to_multiple

        def field(key, shape, dtype, pad_value):
            out = np.full((n_pad, *shape), pad_value, dtype)
            vals = [p[key] for p in self._prims]
            out[:n] = (np.asarray(vals, dtype) if not shape
                       else np.stack(vals).astype(dtype))
            return out

        geom = GeometrySoA(
            ptype=field("ptype", (), np.int32, PT_NONE),
            stable_id=np.concatenate(
                [np.arange(n, dtype=np.int32),
                 np.zeros(n_pad - n, np.int32)]
            ),
            p0=field("p0", (3,), np.float32, 0.0),
            p1=field("p1", (3,), np.float32, 0.0),
            radius=field("radius", (), np.float32, 0.0),
            axis=field("axis", (), np.int32, 0),
            time0=field("time0", (), np.float32, 0.0),
            time1=field("time1", (), np.float32, 1.0),
            neg_inv_density=field("nid", (), np.float32, 0.0),
            material=field("material", (), np.int32, 0),
            rot=field("rot", (3, 3), np.float32, 0.0),
            trans=field("trans", (3,), np.float32, 0.0),
            aabb_min=np.stack(
                [a[0] for a in aabbs]
                + [np.full(3, np.float32(3e38))] * (n_pad - n)
            ).astype(np.float32),
            aabb_max=np.stack(
                [a[1] for a in aabbs]
                + [np.full(3, np.float32(-3e38))] * (n_pad - n)
            ).astype(np.float32),
        )

        mats = MaterialSoA(
            mtype=np.array([m["mtype"] for m in self._mats], np.int32),
            texture=np.array([m["texture"] for m in self._mats], np.int32),
            albedo=np.stack([m["albedo"] for m in self._mats]).astype(np.float32),
            fuzz=np.array([m["fuzz"] for m in self._mats], np.float32),
            ior=np.array([m["ior"] for m in self._mats], np.float32),
        )
        if not self._texs:
            # A scene can be texture-free (e.g. dielectric + metal only);
            # keep one dummy solid row so the SoA stays non-empty.
            self.solid((0.0, 0.0, 0.0))
        texs = TextureSoA(
            ttype=np.array([t["ttype"] for t in self._texs], np.int32),
            color1=np.stack([t["c1"] for t in self._texs]).astype(np.float32),
            color2=np.stack([t["c2"] for t in self._texs]).astype(np.float32),
            scale=np.array([t["scale"] for t in self._texs], np.float32),
            image_id=np.array([t["image_id"] for t in self._texs], np.int32),
        )

        if self._images:
            ih = max(im.shape[0] for im in self._images)
            iw = max(im.shape[1] for im in self._images)
            images = np.zeros((len(self._images), ih, iw, 3), np.float32)
            image_wh = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                images[i, : im.shape[0], : im.shape[1]] = im
                image_wh[i] = (im.shape[1], im.shape[0])
        else:
            images = np.ones((1, 1, 1, 3), np.float32)
            image_wh = np.ones((1, 2), np.int32)

        arrays = SceneArrays(
            geom=geom, materials=mats, textures=texs,
            perlin=make_tables(self._perlin_seed),
            images=images, image_wh=image_wh,
        )

        # Flags from the already-built SoA arrays (the per-prim allclose
        # genexprs cost ~25 s at 598k prims); [:n] excludes pad rows
        # (whose zero rot would read as a transform).  Same semantics:
        # np.allclose(a, b) == np.isclose(a, b).all().
        g_, n_ = geom, n
        static = SceneStatic(
            n_prims=n,
            n_prims_padded=n_pad,
            has_ray_xform=bool(
                np.any(~np.isclose(g_.rot[:n_],
                                   np.eye(3, dtype=np.float32)).all((1, 2)))
                or np.any(g_.trans[:n_] != 0.0)),
            has_media=bool(np.isin(
                g_.ptype[:n_], (PT_MEDIUM_SPHERE, PT_MEDIUM_BOX)).any()),
            has_boxes=bool((g_.ptype[:n_] == PT_BOX).any()),
            has_motion=bool(np.any(
                (g_.ptype[:n_] == PT_SPHERE)
                & (g_.p0[:n_] != g_.p1[:n_]).any(1))),
            has_noise_tex=any(t["ttype"] == TT_NOISE for t in self._texs),
            has_image_tex=any(t["ttype"] == TT_IMAGE for t in self._texs),
            has_checker_tex=any(t["ttype"] == TT_CHECKER for t in self._texs),
            mat_types=tuple(sorted({m["mtype"] for m in self._mats})),
        )
        return Scene(arrays=arrays, static=static, camera=camera,
                     background=tuple(np.float32(background).tolist()),
                     name=name)
