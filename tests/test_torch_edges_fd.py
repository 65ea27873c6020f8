"""The port's silhouette gradients against finite differences of the
port's own render (``tests/test_edges.py``'s FD checks, on the port).

Each case is the JAX test's: its scene, image size, spp, depth, eps,
shift and rtol, the correction's seed 7 beside the render's 0.  The
loss is the unmasked (or disk-masked) MSE to a target rendered with the
primitive shifted, so that d loss / dx at 0 is dominated by the boundary
term that fixed-decision gradients miss; where the JAX test also shows
that the uncorrected gradient misses the FD, so does this one.  The
glass full-disk residual, the hollow shell and the two recovery fits are
``slow``, as in ``tests/test_edges.py``.

The FD here is of a Monte-Carlo render: each ``_Rig.image`` renders the
same lanes with the same noise, so the difference of two renders is the
parameter's effect alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu_torch import build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.builders import SKY  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import (  # noqa: E402
    MT_DIFFUSE_LIGHT,
    MT_LAMBERTIAN,
    PT_SPHERE,
    CameraConfig,
    SceneBuilder,
    rotation_matrix,
)
from hyper_ray_tracer_tpu_torch.ops import edges as P  # noqa: E402
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    prepare_scene,
    render_radiance,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import (  # noqa: E402
    bind_params,
    extract_params,
    to_device,
)
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    ADAM_BETAS,
    ADAM_EPS,
    make_loss_fn,
    pixel_lanes,
)

W, H, DEPTH = 32, 18, 3
_CAM = CameraConfig((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 90.0, 0.0,
                    focus_dist=1.0)


class _Rig:
    """A scene uploaded on the CPU in its default mode, with
    ``image(dx0, dx1)``: the mean image [W*H, 3] over ``spp`` lanes with
    primitive ``prim``'s p0 and p1 shifted on x by dx0 and dx1 (tensors,
    differentiable), the silhouette correction (seed 7) added."""

    def __init__(self, scene, W_, H_, spp, depth, prim=0, **corr_kw):
        arrays, bvh, _ = prepare_scene(scene)
        self.st = to_device(arrays, scene.static, "cpu", bvh)
        self.scene, self.W, self.H, self.spp, self.depth = (scene, W_, H_,
                                                            spp, depth)
        self.basis = make_basis(scene.camera, W_, H_)
        self.pix, self.sam = pixel_lanes(W_, H_, spp, "cpu")
        self.corr = P.make_silhouette_correction(scene, W_, H_, depth,
                                                 self.st.host_geom,
                                                 **corr_kw)
        self.params = extract_params(self.st.arrays)
        self.e = torch.zeros_like(self.params["geom.p0"])
        self.e[prim, 0] = 1.0

    def image(self, dx0, dx1=None):
        g = self.params
        bound = bind_params(self.st, {
            **g, "geom.p0": g["geom.p0"] + self.e * dx0,
            "geom.p1": g["geom.p1"] + self.e * (dx0 if dx1 is None
                                                else dx1)})
        rad = render_radiance(bound, self.scene.background, self.basis,
                              self.W, self.H, self.pix.reshape(-1),
                              self.sam.reshape(-1), 0, self.depth)
        img = rad.reshape(self.spp, self.W * self.H, 3).mean(0)
        return img + self.corr(bound, self.basis, 7)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32, requires_grad=True)


def _grad_and_fd(rig, shift, eps, mask=None):
    """(d loss / dx at 0, the central difference at +-eps) of the MSE to
    the image at ``shift`` (times ``mask`` per pixel, if given)."""
    with torch.no_grad():
        target = rig.image(torch.tensor(np.float32(shift)))

    def loss(dx):
        sq = (rig.image(dx) - target) ** 2
        return (sq if mask is None else sq * mask).mean()

    dx = _f32(0.0)
    loss(dx).backward()
    with torch.no_grad():
        fd = (float(loss(torch.tensor(np.float32(eps))))
              - float(loss(torch.tensor(np.float32(-eps))))) / (2 * eps)
    return float(dx.grad), fd


def _fd_check(rig, shift=0.15, eps=0.03, rtol=0.35):
    g, fd = _grad_and_fd(rig, shift, eps)
    assert abs(fd) > 1e-4, f"FD degenerate: {fd}"
    np.testing.assert_allclose(g, fd, rtol=rtol)


def _first(scene, test):
    """The first primitive of ``scene`` that ``test(ptype, mtype, p0)``
    picks."""
    n = scene.static.n_prims
    g = scene.arrays.geom
    mt = np.asarray(scene.arrays.materials.mtype)[
        np.asarray(g.material)[:n]]
    pick = test(np.asarray(g.ptype)[:n], mt, np.asarray(g.p0)[:n])
    return int(np.flatnonzero(pick)[0])


# --- test_edges.py:85, :115: one-sphere, no mask ---

def test_silhouette_grad_matches_fd_unmasked():
    """d/dx of an unmasked loss as one-sphere's hero slides sideways:
    within 35% of the FD (the JAX test measured the uncorrected gradient
    ~300x too small and of the wrong sign)."""
    rig = _Rig(build_scene("one-sphere"), W, H, 48, DEPTH)
    g, fd = _grad_and_fd(rig, 0.15, 0.03)
    assert abs(fd) > 1e-3, f"FD degenerate: {fd}"
    np.testing.assert_allclose(g, fd, rtol=0.35)


@pytest.mark.slow
def test_inverse_rendering_recovers_position_through_silhouette():
    """Recover the hero's x from a loss dominated by where its silhouette
    falls: adam (0.05) from 0.22 off, 40 steps, ends within 0.05."""
    rig = _Rig(build_scene("one-sphere"), W, H, 16, DEPTH)
    with torch.no_grad():
        target = rig.image(torch.tensor(np.float32(0.0)))
    dx = _f32(0.22)
    opt = torch.optim.Adam([dx], lr=0.05, betas=ADAM_BETAS, eps=ADAM_EPS)
    for _ in range(40):
        opt.zero_grad()
        ((rig.image(dx) - target) ** 2).mean().backward()
        opt.step()
    assert abs(float(dx.detach())) < 0.05, float(dx.detach())


# --- test_edges.py:200, :210: rect and box edges ---

def test_rect_silhouette_grad_matches_fd():
    """A lone gray rect sliding in its own plane: its interior gradient is
    exactly 0, so the whole derivative is the boundary term."""
    b = SceneBuilder()
    b.rect(0, -0.4, 0.4, -0.3, 0.3, -1.0,
           b.lambertian(b.solid((0.4, 0.4, 0.4))))
    scene = b.finalize(_CAM, SKY, "rect-sil")
    assert len(P.rect_ids_of(scene)) == 1
    _fd_check(_Rig(scene, W, H, 48, DEPTH))


def test_box_silhouette_grad_matches_semianalytic():
    """An emissive rotated box on black: the expected image is emission x
    coverage, so d/dx of a pixel-weighted sum is a weighted coverage
    derivative, rasterized with a slab test on an 8x8 subpixel grid (no
    Monte Carlo).  The interior term is exactly 0 for an emissive box."""
    b = SceneBuilder()
    lit = b.diffuse_light(b.solid((1.0, 1.0, 1.0)))
    rot = rotation_matrix(1, 20.0)
    trans = np.array([0.0, 0.0, -1.5])
    p0w = np.array([-0.3, -0.3, -0.3])
    p1w = np.array([0.3, 0.3, 0.3])
    b.cuboid(p0w, p1w, lit, rot=rot, trans=trans)
    scene = b.finalize(_CAM, (0.0, 0.0, 0.0), "box-lit")
    assert len(P.box_ids_of(scene)) == 1

    rig = _Rig(scene, W, H, 32, 2)
    wts = torch.arange(W * H, dtype=torch.float32)[:, None]
    dx = _f32(0.0)
    (rig.image(dx) * wts).sum().backward()
    gval = float(dx.grad)

    basis = rig.basis
    o, Hv, Vv, llc = (np.asarray(basis.origin), np.asarray(basis.horizontal),
                      np.asarray(basis.vertical),
                      np.asarray(basis.lower_left))
    sub = 8
    xs = (np.arange(W * sub) + 0.5) / sub  # pixel-unit image x
    ys = (np.arange(H * sub) + 0.5) / sub
    px, py = np.meshgrid(xs, ys, indexing="ij")
    s = px.ravel() / (W - 1)
    t = py.ravel() / (H - 1)
    d = llc + s[:, None] * Hv + t[:, None] * Vv - o
    d_obj = d @ rot  # rows: R^T @ d
    o_obj = (o - trans) @ rot
    wts_np = (np.floor(py).astype(int) * W
              + np.floor(px).astype(int)).ravel().astype(np.float64)

    def weighted_cov(dx):
        lo = p0w + np.array([dx, 0.0, 0.0])
        hi = p1w + np.array([dx, 0.0, 0.0])
        with np.errstate(divide="ignore"):
            inv = 1.0 / d_obj
        t0 = (lo - o_obj) * inv
        t1 = (hi - o_obj) * inv
        tn = np.minimum(t0, t1).max(1)
        tf = np.maximum(t0, t1).min(1)
        hit = tf >= np.maximum(tn, 0.0)
        return 3.0 * (wts_np * hit).sum() / (sub * sub)

    eps = 0.05
    truth = (weighted_cov(eps) - weighted_cov(-eps)) / (2 * eps)
    assert abs(truth) > 1.0
    np.testing.assert_allclose(gval, truth, rtol=0.15)


# --- test_edges.py:314, :327, :340: lens and shutter ---

@pytest.mark.parametrize("kind", ["sphere", "rect"])
def test_defocus_silhouette_grad(kind):
    """An out-of-focus sphere (:314) or rect (:327) under aperture 0.3:
    the estimator integrates the boundary term over the lens disk."""
    b = SceneBuilder()
    gray = b.lambertian(b.solid((0.4, 0.4, 0.4)))
    if kind == "sphere":
        b.sphere((0.0, 0.0, -1.6), 0.5, gray)
    else:
        b.rect(0, -0.4, 0.4, -0.3, 0.3, -1.6, gray)
    cam = CameraConfig((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 90.0, 0.3,
                       focus_dist=1.0)
    _fd_check(_Rig(b.finalize(cam, SKY, f"defocus-{kind}"), W, H, 64,
                   DEPTH))


def test_moving_sphere_silhouette_grad():
    """A motion-blurred sphere: the total over both center endpoints
    matches the FD, and the p1 endpoint carries 20-80% of it."""
    b = SceneBuilder()
    b.moving_sphere((-0.12, 0.0, -1.0), (0.12, 0.0, -1.0), 0.0, 1.0, 0.5,
                    b.lambertian(b.solid((0.4, 0.4, 0.4))))
    scene = b.finalize(_CAM, SKY, "moving-sil")
    assert len(P.static_sphere_ids(scene)) == 0  # nothing static to cover
    rig = _Rig(scene, W, H, 64, DEPTH)
    with torch.no_grad():
        shift = torch.tensor(np.float32(0.15))
        target = rig.image(shift, shift)

    def loss(dx0, dx1):
        return ((rig.image(dx0, dx1) - target) ** 2).mean()

    dx0, dx1 = _f32(0.0), _f32(0.0)
    loss(dx0, dx1).backward()
    g0, g1 = float(dx0.grad), float(dx1.grad)
    eps = np.float32(0.03)
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps), torch.tensor(eps)))
              - float(loss(torch.tensor(-eps), torch.tensor(-eps)))) / (
            2 * 0.03)
    assert abs(fd) > 1e-4, f"FD degenerate: {fd}"
    np.testing.assert_allclose(g0 + g1, fd, rtol=0.35)
    assert 0.2 < g1 / (g0 + g1) < 0.8, (g0, g1)


# --- test_edges.py:412: the cornell light through its outline ---

@pytest.mark.slow
def test_light_position_recovery_through_silhouette():
    """examples/inverse_geometry.py condensed: the cornell light's
    in-plane position, shifted by (25, -20), recovered to within 0.4 of
    the error by 35 adam steps (2.5) at 48x48x2 d2."""
    Wl = Hl = 48
    spp, depth = 2, 2
    scene = build_scene("cornell")
    light = _first(scene, lambda pt, mt, p0: mt == MT_DIFFUSE_LIGHT)
    arrays, bvh, mode = prepare_scene(scene)
    st = to_device(arrays, scene.static, "cpu", bvh)
    basis = make_basis(scene.camera, Wl, Hl)
    pix, sam = pixel_lanes(Wl, Hl, spp, "cpu")
    true = extract_params(st.arrays)
    with torch.no_grad():
        rad = render_radiance(bind_params(st, true), scene.background,
                              basis, Wl, Hl, pix.reshape(-1),
                              sam.reshape(-1), 0, depth)
    target = rad.reshape(spp, Wl * Hl, 3).mean(0)
    shift = torch.tensor([25.0, -20.0, 0.0])
    params = {k: v.clone() for k, v in true.items()}
    params["geom.p0"][light] += shift
    params["geom.p1"][light] += shift
    row = torch.zeros_like(true["geom.p0"])
    row[light, :2] = 1.0
    free = [params[k].requires_grad_() for k in ("geom.p0", "geom.p1")]
    opt = torch.optim.Adam(free, lr=2.5, betas=ADAM_BETAS, eps=ADAM_EPS)
    loss_fn = make_loss_fn(scene, Wl, Hl, depth, mode, silhouette=True)

    def err():
        return float((params["geom.p0"][light]
                      - true["geom.p0"][light]).abs().max())

    e0 = err()
    for _ in range(35):
        opt.zero_grad()
        loss_fn(params, st, basis, pix, sam, 0, target).backward()
        for p in free:
            p.grad.mul_(row)
        opt.step()
    e1 = err()
    assert e1 < 0.4 * e0, (e0, e1)


# --- test_edges.py:549, :619, :690: mirrors ---

def _mirror_scene():
    """A polished metal rect facing the camera, a diffuse sphere behind
    the camera: the sphere is visible only in the mirror."""
    b = SceneBuilder()
    b.rect(0, -0.6, 0.6, -0.6, 0.6, -1.0, b.metal((0.95, 0.95, 0.95), 0.0))
    b.sphere((0.3, 0.0, 1.2), 0.35, b.lambertian(b.solid((0.7, 0.15, 0.1))))
    return b.finalize(_CAM, SKY, "mirror-sil")


def _curved_mirror_rig():
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.3), 0.8, b.metal((0.9, 0.9, 0.95), 0.0))
    b.sphere((0.4, 0.0, 1.5), 0.45, b.lambertian(b.solid((0.7, 0.15, 0.1))))
    return b.finalize(_CAM, SKY, "curved-mirror")


def _rect_curved_mirror_rig():
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.3), 0.8, b.metal((0.9, 0.9, 0.95), 0.0))
    b.rect(0, 0.0, 0.8, -0.4, 0.4, 1.5,  # XY at z=+1.5 (behind)
           b.lambertian(b.solid((0.75, 0.3, 0.1))))
    return b.finalize(_CAM, SKY, "rect-curved-mirror")


# case: (rig, the primitive shifted, the family's selector and the
# correction's keyword that turns it off, shift, eps)
MIRROR_CASES = {
    "planar": (_mirror_scene, lambda pt, mt, p0: pt == PT_SPHERE,
               "mirror_rect_ids_of", "mirror_ids", 0.15, 0.03),
    "curved": (_curved_mirror_rig,
               lambda pt, mt, p0: (pt == PT_SPHERE) & (p0[:, 2] > 0),
               "mirror_sphere_ids_of", "mirror_sphere_ids", 0.2, 0.04),
    "rect-in-curved": (_rect_curved_mirror_rig,
                       lambda pt, mt, p0: pt != PT_SPHERE,
                       "mirror_sphere_ids_of", "mirror_sphere_ids", 0.2,
                       0.04),
}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_mirror_silhouette_grad_matches_fd(case):
    """A source visible only in a mirror: a sphere in a planar mirror
    (:549), a sphere (:619) and a rect (:690) in a polished-sphere
    mirror.  Without the mirror family the gradient misses more than half
    of the FD; with it (auto-detected) it lands within 35%."""
    rig_fn, pick, selector, off_kw, shift, eps = MIRROR_CASES[case]
    scene = rig_fn()
    assert len(getattr(P, selector)(scene)) == 1
    prim = _first(scene, pick)
    g_off, fd = _grad_and_fd(
        _Rig(scene, W, H, 48, DEPTH, prim,
             **{off_kw: np.zeros(0, np.int64)}), shift, eps)
    g_on, fd_on = _grad_and_fd(_Rig(scene, W, H, 48, DEPTH, prim), shift,
                               eps)
    print(f"{case}: grad {g_on:.5f} vs fd {fd_on:.5f} (off: {g_off:.5f})")
    assert abs(fd) > 1e-4, f"FD degenerate: {fd}"
    assert abs(g_off - fd) > 0.5 * abs(fd), (g_off, fd)
    np.testing.assert_allclose(g_on, fd_on, rtol=0.35)


# --- test_edges.py:750, :835, :924: glass ---

GW, GH, GSPP = 64, 36, 32


def _glass_rig(hollow=False):
    """A red source sphere seen through a glass ball (or a hollow shell,
    outer 0.5 and inner -0.45) in front of the camera; returns (scene,
    the source's id)."""
    b = SceneBuilder()
    glass = b.dielectric(1.5)
    b.sphere((0.0, 0.0, -1.3), 0.5, glass)
    if hollow:
        b.sphere((0.0, 0.0, -1.3), -0.45, glass)
    red = b.lambertian(b.solid((0.8, 0.1, 0.05)))
    b.sphere((0.5, 0.0, -3.0) if hollow else (1.4, 0.0, -3.0), 0.5, red)
    cam = CameraConfig((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 60.0, 0.0,
                       focus_dist=1.0)
    scene = b.finalize(cam, SKY, "hollow-glass-rig" if hollow
                       else "glass-rig")
    return scene, _first(scene, lambda pt, mt, p0: mt == MT_LAMBERTIAN)


def _disk_mask(scene, left_half=False):
    """[GW*GH, 1] float32: the pixels whose pinhole ray meets the glass
    ball's disk (center (0, 0, -1.3), radius 0.5), optionally only its
    left half."""
    basis = make_basis(scene.camera, GW, GH)
    xs = (np.arange(GW) + 0.5) / (GW - 1)
    ys = (np.arange(GH) + 0.5) / (GH - 1)
    cnp = np.array([0.0, 0.0, -1.3])
    d = (np.asarray(basis.lower_left)[None, None]
         + xs[None, :, None] * np.asarray(basis.horizontal)[None, None]
         + ys[:, None, None] * np.asarray(basis.vertical)[None, None]
         - np.asarray(basis.origin)[None, None])
    oc = np.asarray(basis.origin) - cnp
    bq = (d * oc).sum(-1)
    disc = bq * bq - (d * d).sum(-1) * (oc @ oc - 0.25)
    mask = disc > 0
    if left_half:
        mask &= (np.arange(GW) < GW // 2)[None, :]
    return torch.from_numpy(mask.reshape(GW * GH, 1).astype(np.float32))


def test_glass_silhouette_grad_matches_fd():
    """A sphere seen through a glass ball, the loss over the left half of
    the ball's disk (the refracted image, not the source's direct one):
    without the glass family the gradient misses more than half of the
    FD (the JAX test measured it exactly 0); with it, within 35%."""
    scene, prim = _glass_rig()
    assert len(P.glass_sphere_ids_of(scene)) == 1
    mask = _disk_mask(scene, left_half=True)
    assert mask.any()
    g_off, fd_off = _grad_and_fd(
        _Rig(scene, GW, GH, GSPP, 4, prim, n_edge=128,
             glass_sphere_ids=np.zeros(0, np.int64)), 0.2, 0.04, mask)
    g_on, fd_on = _grad_and_fd(_Rig(scene, GW, GH, GSPP, 4, prim,
                                    n_edge=128), 0.2, 0.04, mask)
    print(f"glass: grad {g_on:.6f} vs fd {fd_on:.6f} (off: {g_off:.6f})")
    assert abs(fd_on) > 1e-4, f"FD degenerate: {fd_on}"
    assert abs(g_off - fd_off) > 0.5 * abs(fd_off), (g_off, fd_off)
    np.testing.assert_allclose(g_on, fd_on, rtol=0.35)


@pytest.mark.slow
def test_glass_full_disk_residual_bound():
    """Over the ball's whole disk the solid-glass families leave a
    residual (higher-order paths): the JAX test measured a ratio of
    0.759 and holds it within (0.60, 1.15)."""
    scene, prim = _glass_rig()
    g, fd = _grad_and_fd(_Rig(scene, GW, GH, GSPP, 4, prim, n_edge=128),
                         0.2, 0.04, _disk_mask(scene))
    assert abs(fd) > 1e-4, f"FD degenerate: {fd}"
    ratio = g / fd
    print(f"glass full disk: grad {g:.6f} vs fd {fd:.6f} ratio {ratio:.3f}")
    assert 0.60 < ratio < 1.15, ratio


@pytest.mark.slow
def test_hollow_shell_silhouette_grad_matches_fd():
    """A source seen through a hollow glass shell (depth 7: four
    interfaces, the source, its scatter and the sky), the loss over the
    shell's disk: without the shell family more than a quarter of the FD
    is missing; with it (and ``_edge_blocked``'s gate on the direct
    family, the JAX package's as it is: ROADMAP F4) within 25%."""
    scene, prim = _glass_rig(hollow=True)
    assert len(P.glass_shell_pairs_of(scene)) == 1
    assert len(P.glass_sphere_ids_of(scene)) == 0  # shell outer excluded
    mask = _disk_mask(scene)
    g_off, fd_off = _grad_and_fd(
        _Rig(scene, GW, GH, GSPP, 7, prim, n_edge=128,
             glass_shells=np.zeros((0, 2), np.int64)), 0.2, 0.04, mask)
    g_on, fd_on = _grad_and_fd(_Rig(scene, GW, GH, GSPP, 7, prim,
                                    n_edge=128), 0.2, 0.04, mask)
    print(f"hollow shell: grad {g_on:.6f} vs fd {fd_on:.6f} "
          f"(direct-only: {g_off:.6f})")
    assert abs(fd_on) > 1e-4, f"FD degenerate: {fd_on}"
    assert abs(g_off - fd_off) > 0.25 * abs(fd_off), (g_off, fd_off)
    np.testing.assert_allclose(g_on, fd_on, rtol=0.25)
