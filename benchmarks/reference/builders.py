"""The scenes the benchmark's configurations name: a frozen copy of the
JAX package's ``hyper_ray_tracer_tpu/models/builders.py`` at commit
``7eb49fb``.  Geometry, materials, cameras and backgrounds follow the Rust
reference's ``src/application.rs:125-211`` (camera table) and ``:497-935``
(scene builders); its random scenes draw from a seeded NumPy generator.
The image texture is read from the repository's ``assets/earthmap.jpg``,
the same raw file the renderer under test reads.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .scene import (
    PLANE_XY,
    PLANE_YZ,
    PLANE_ZX,
    CameraConfig,
    Scene,
    SceneBuilder,
    rotation_matrix,
)

_ASSETS = Path(__file__).resolve().parents[2] / "assets"

SKY = (0.7, 0.8, 1.0)
BLACK = (0.0, 0.0, 0.0)

_CAM_STANDARD = CameraConfig((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0, 0.0)


def _load_earthmap() -> np.ndarray:
    from PIL import Image

    with Image.open(_ASSETS / "earthmap.jpg") as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def random_scene(seed: int = 3) -> Scene:
    """application.rs:497-565 — checker ground, 22x22 grid, 3 hero spheres."""
    b = SceneBuilder()
    rng = np.random.default_rng(seed)

    ground = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()],
                np.float32,
            )
            if np.linalg.norm(center - np.float32([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3).astype(np.float32)
                center2 = center + np.float32([0.0, rng.uniform(0.0, 0.5), 0.0])
                mat = b.lambertian(b.solid(albedo))
                b.moving_sphere(center, center2, 0.0, 1.0, 0.2, mat)
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3).astype(np.float32)
                fuzz = rng.uniform(0.0, 0.5)
                b.sphere(center, 0.2, b.metal(albedo, fuzz))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))

    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian(b.solid((0.4, 0.2, 0.1))))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    cam = CameraConfig((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0, 0.1)
    return b.finalize(cam, SKY, "random")


def two_spheres() -> Scene:
    """application.rs:567-587."""
    b = SceneBuilder()
    checker = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -10.0, 0.0), 10.0, checker)
    b.sphere((0.0, 10.0, 0.0), 10.0, checker)
    return b.finalize(_CAM_STANDARD, SKY, "two-spheres")


def two_perlin_spheres() -> Scene:
    """application.rs:589-602."""
    b = SceneBuilder()
    noise = b.lambertian(b.noise(4.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, noise)
    b.sphere((0.0, 2.0, 0.0), 2.0, noise)
    return b.finalize(_CAM_STANDARD, SKY, "two-perlin-spheres")


def earth() -> Scene:
    """application.rs:604-612."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(b.image(_load_earthmap())))
    return b.finalize(_CAM_STANDARD, SKY, "earth")


def simple_light() -> Scene:
    """application.rs:614-637."""
    b = SceneBuilder()
    noise = b.lambertian(b.noise(4.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, noise)
    b.sphere((0.0, 2.0, 0.0), 2.0, noise)
    light = b.diffuse_light(b.solid((4.0, 4.0, 4.0)))
    b.rect(PLANE_XY, 3.0, 5.0, 1.0, 3.0, -2.0, light)
    cam = CameraConfig((26.0, 3.0, 6.0), (0.0, 2.0, 0.0), 20.0, 0.0)
    return b.finalize(cam, BLACK, "simple-light")


def _cornell_walls(b: SceneBuilder):
    red = b.lambertian(b.solid((0.65, 0.05, 0.05)))
    white = b.lambertian(b.solid((0.73, 0.73, 0.73)))
    green = b.lambertian(b.solid((0.12, 0.45, 0.15)))
    light = b.diffuse_light(b.solid((15.0, 15.0, 15.0)))
    b.rect(PLANE_YZ, 0.0, 555.0, 0.0, 555.0, 555.0, green)
    b.rect(PLANE_YZ, 0.0, 555.0, 0.0, 555.0, 0.0, red)
    b.rect(PLANE_ZX, 213.0, 343.0, 227.0, 332.0, 554.0, light)
    b.rect(PLANE_ZX, 0.0, 555.0, 0.0, 555.0, 0.0, white)
    b.rect(PLANE_ZX, 0.0, 555.0, 0.0, 555.0, 555.0, white)
    b.rect(PLANE_XY, 0.0, 555.0, 0.0, 555.0, 555.0, white)
    return white


_CAM_CORNELL = CameraConfig((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), 40.0, 0.0)


def cornell() -> Scene:
    """application.rs:639-721."""
    b = SceneBuilder()
    white = _cornell_walls(b)
    b.cuboid((0, 0, 0), (165, 330, 165), white,
             rot=rotation_matrix(1, 15.0), trans=(265.0, 0.0, 295.0))
    b.cuboid((0, 0, 0), (165, 165, 165), white,
             rot=rotation_matrix(1, -18.0), trans=(130.0, 0.0, 65.0))
    return b.finalize(_CAM_CORNELL, BLACK, "cornell")


def cornell_smoke() -> Scene:
    """application.rs:723-815 — cuboids become pure participating media."""
    b = SceneBuilder()
    _cornell_walls(b)
    b.medium_box((0, 0, 0), (165, 330, 165), 0.01, b.solid((0.0, 0.0, 0.0)),
                 rot=rotation_matrix(1, 15.0), trans=(265.0, 0.0, 295.0))
    b.medium_box((0, 0, 0), (165, 165, 165), 0.01, b.solid((1.0, 1.0, 1.0)),
                 rot=rotation_matrix(1, -18.0), trans=(130.0, 0.0, 65.0))
    return b.finalize(_CAM_CORNELL, BLACK, "cornell-smoke")


def final_scene(seed: int = 7) -> Scene:
    """application.rs:817-935 — the 'Next Week' showcase scene."""
    b = SceneBuilder()
    rng = np.random.default_rng(seed)

    ground = b.lambertian(b.solid((0.48, 0.83, 0.53)))
    boxes_per_side = 20
    for i in range(boxes_per_side):
        for j in range(boxes_per_side):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = float(rng.uniform(1.0, 101.0))
            b.cuboid((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    light = b.diffuse_light(b.solid((7.0, 7.0, 7.0)))
    b.rect(PLANE_ZX, 123.0, 423.0, 147.0, 412.0, 554.0, light)

    c1 = np.float32([400.0, 400.0, 200.0])
    b.moving_sphere(c1, c1 + np.float32([30.0, 0.0, 0.0]), 0.0, 1.0, 50.0,
                    b.lambertian(b.solid((0.7, 0.3, 0.1))))

    b.sphere((260.0, 150.0, 45.0), 50.0, b.dielectric(1.5))
    b.sphere((0.0, 150.0, 145.0), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))

    # Subsurface: glass boundary + blue interior medium (application.rs:866-877).
    b.sphere((360.0, 150.0, 145.0), 70.0, b.dielectric(1.5))
    b.medium_sphere((360.0, 150.0, 145.0), 70.0, 0.2, b.solid((0.2, 0.4, 0.9)))

    # Global fog (application.rs:879-884); the glass boundary is not rendered.
    b.medium_sphere((0.0, 0.0, 0.0), 5000.0, 0.0001, b.solid((1.0, 1.0, 1.0)))

    b.sphere((400.0, 200.0, 400.0), 100.0,
             b.lambertian(b.image(_load_earthmap())))
    b.sphere((220.0, 280.0, 300.0), 80.0, b.lambertian(b.noise(0.1)))

    white = b.lambertian(b.solid((0.73, 0.73, 0.73)))
    rot = rotation_matrix(1, 15.0)
    trans = (-100.0, 270.0, 395.0)
    for _ in range(1000):
        center = rng.uniform(0.0, 165.0, 3).astype(np.float32)
        b.sphere(center, 10.0, white, rot=rot, trans=trans)

    cam = CameraConfig((478.0, 278.0, -600.0), (278.0, 278.0, 0.0), 40.0, 0.0)
    return b.finalize(cam, BLACK, "final")


def _flake_frames(axes: np.ndarray) -> np.ndarray:
    """[K,3,3] orthonormal frames (u, v, axis) for attachment axes [K,3]."""
    a = axes / np.linalg.norm(axes, axis=-1, keepdims=True)
    h = np.where(np.abs(a[:, 1:2]) < 0.9,
                 np.float32([0.0, 1.0, 0.0]), np.float32([1.0, 0.0, 0.0]))
    u = np.cross(h, a)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(a, u)
    return np.stack([u, v, a], axis=1).astype(np.float32)


# Child attachment directions in the parent's local frame (z = parent
# attachment axis): 6 equatorial + 3 upper, the classic 9-child sphereflake
# layout (Haines' SPD "sphflake"; exact angles are a free choice — the
# scene is ours, not the reference's, so they are simply fixed constants).
def _flake_dirs() -> np.ndarray:
    eq_az = np.deg2rad(np.arange(6) * 60.0 + 30.0)
    top_az = np.deg2rad(np.arange(3) * 120.0)
    eq_pol = np.deg2rad(100.0)  # slightly below the equator: fuller look
    top_pol = np.deg2rad(40.0)
    az = np.concatenate([eq_az, top_az])
    pol = np.concatenate([np.full(6, eq_pol), np.full(3, top_pol)])
    return np.stack([np.sin(pol) * np.cos(az),
                     np.sin(pol) * np.sin(az),
                     np.cos(pol)], axis=-1).astype(np.float32)


def sphereflake(depth: int = 5, name: str = "sphereflake") -> Scene:
    """Recursive 9-child sphereflake: the large-scene showcase.

    NOT a reference scene — the reference tops out at ~3.4k primitives
    (`application.rs:817-935`); this scene exists to give the cluster
    intersector (auto above render.AUTO_CLUSTER_MIN_PRIMS) a real
    committed workload: depth 5 = (9^6-1)/8 = 66,430 spheres (plus
    ground), deterministic (no RNG), spatially hierarchical — exactly
    the regime the 30k-300k crossover table was measured in.  Smaller
    depths (tests use 2) keep identical structure at oracle-checkable
    sizes.
    """
    b = SceneBuilder()
    ground = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    # Per-level materials: polished-metal trunk, warm lambertian branches.
    level_mats = [
        b.metal((0.8, 0.8, 0.9), 0.02),
        b.lambertian(b.solid((0.75, 0.25, 0.15))),
        b.metal((0.9, 0.7, 0.4), 0.1),
        b.lambertian(b.solid((0.2, 0.45, 0.7))),
        b.lambertian(b.solid((0.85, 0.8, 0.3))),
        b.lambertian(b.solid((0.9, 0.9, 0.9))),
    ]

    dirs = _flake_dirs()  # [9,3] local
    centers = np.float32([[0.0, 1.0, 0.0]])
    radii = np.float32([1.0])
    axes = np.float32([[0.0, 1.0, 0.0]])
    for level in range(depth + 1):
        mat = level_mats[min(level, len(level_mats) - 1)]
        b.spheres(centers, radii, mat)
        if level == depth:
            break
        frames = _flake_frames(axes)  # [K,3,3]
        # World-space child dirs: dir @ frame  ([9,3] x [K,3,3] -> [K,9,3]).
        dw = np.einsum("dj,kjm->kdm", dirs, frames)
        r_child = radii / 3.0
        centers = (centers[:, None] + dw
                   * (radii + r_child)[:, None, None]).reshape(-1, 3)
        axes = dw.reshape(-1, 3)
        radii = np.repeat(r_child, 9)

    cam = CameraConfig((4.0, 2.6, 5.2), (0.0, 1.2, 0.0), 32.0, 0.0)
    return b.finalize(cam, SKY, name)


# ---- BASELINE.json bench scenes (configs 1-2); not in the reference CLI ----

def one_sphere() -> Scene:
    """BASELINE config 1: lambertian sphere + ground, gradient sky."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.solid((0.5, 0.5, 0.5))))
    b.sphere((0.0, -100.5, -1.0), 100.0,
             b.lambertian(b.solid((0.5, 0.5, 0.5))))
    cam = CameraConfig((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 90.0, 0.0,
                       focus_dist=1.0)
    s = b.finalize(cam, SKY, "one-sphere")
    s.background = None  # gradient sky sentinel (see render.py)
    return s


def three_spheres() -> Scene:
    """BASELINE config 2: lambertian/metal/dielectric with hollow glass."""
    b = SceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0,
             b.lambertian(b.solid((0.8, 0.8, 0.0))))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.solid((0.1, 0.2, 0.5))))
    glass = b.dielectric(1.5)
    b.sphere((-1.0, 0.0, -1.0), 0.5, glass)
    b.sphere((-1.0, 0.0, -1.0), -0.45, glass)  # hollow: negative radius
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.0))
    cam = CameraConfig((-2.0, 2.0, 1.0), (0.0, 0.0, -1.0), 90.0, 0.0,
                       focus_dist=1.0)
    s = b.finalize(cam, SKY, "three-spheres")
    s.background = None
    return s


SCENES = {
    "random": random_scene,
    "two-spheres": two_spheres,
    "two-perlin-spheres": two_perlin_spheres,
    "earth": earth,
    "simple-light": simple_light,
    "cornell": cornell,
    "cornell-smoke": cornell_smoke,
    "final": final_scene,
    "sphereflake": sphereflake,
    # Oracle-checkable small variant (92 prims), same structure/camera:
    # golden-image tested so the big scene's geometry generator is pinned.
    "sphereflake-small": lambda: sphereflake(2, "sphereflake-small"),
    "one-sphere": one_sphere,
    "three-spheres": three_spheres,
}


def build_scene(name: str) -> Scene:
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; options: {sorted(SCENES)}")
    return SCENES[name]()
