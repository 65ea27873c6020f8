"""The CUDA kernels (the sphere sweep, the typed sweep, the BVH
traversal, the cluster sweep, the noise texture's marble turbulence and its backward, the
gathers' segmented sum) against their plain-PyTorch versions, and a
train step on the card against the CPU's and against itself.  Every
test here needs a CUDA device and nvcc and skips without them; on a GPU
machine run ``python -m pytest tests/test_torch_cuda.py``.

Each forward kernel performs its plain version's IEEE operations in the
same order, so the two must agree bit for bit, not only within the near-tie
rules.  The sweeps are also held at ray counts around the packet and
block edges, with two shutter intervals, and with plan tiles that span
the kernel's stages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hyper_ray_tracer_tpu_torch import (  # noqa: E402
    RenderSettings,
    build_scene,
    prepare_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import (  # noqa: E402
    TT_NOISE,
    CameraConfig,
    SceneBuilder,
)
from hyper_ray_tracer_tpu_torch.ops import perlin  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.bvh import (  # noqa: E402
    bvh_traverse,
    bvh_traverse_plain,
)
from hyper_ray_tracer_tpu_torch.ops.cluster_sweep import (  # noqa: E402
    cluster_sweep,
    cluster_sweep_plain,
    cut_run,
)
from hyper_ray_tracer_tpu_torch.ops.gather import (  # noqa: E402
    CHUNK,
    FAN_OUT,
    ONE_PASS_ROWS,
    gather_rows,
    segment_sum,
    segment_sum_plain,
)
from hyper_ray_tracer_tpu_torch.ops import rng as prng  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.intersect import (  # noqa: E402
    gather_prim_shade_packed,
    hit_detail,
)
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (  # noqa: E402
    sphere_sweep,
    sphere_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.ops.textures import TextureTables  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.turbulence import (  # noqa: E402
    noise_texture,
    noise_texture_grad,
    noise_texture_grad_plain,
    noise_texture_plain,
    noise_texture_saved,
    noise_texture_saved_plain,
)
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (  # noqa: E402
    typed_sweep,
    typed_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    T_MIN,
    bounce_step,
    init_state,
    trace,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    extract_params,
    make_loss_fn,
    pixel_lanes,
)
from hyper_ray_tracer_tpu_torch.utils import cuda_build  # noqa: E402
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _rays(scene, st, W, H, dev, bounces=0):
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    state = init_state(make_basis(scene.camera, W, H), W, H, pix,
                       torch.zeros_like(pix), 7)
    for b in range(bounces):
        state = bounce_step(st, scene.background, state, b)
    return state


def _both(st, o, d, time, active):
    args = (*st.spheres, o.contiguous(), d.contiguous(), time.contiguous(),
            active.contiguous())
    t_k, b_k = sphere_sweep(*args)
    torch.cuda.synchronize()
    t_p, b_p = sphere_sweep_plain(*args)
    return t_k, b_k, t_p, b_p


@pytest.mark.parametrize("name", ["random", "three-spheres", "two-spheres",
                                  "sphereflake-small", "sphereflake"])
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_kernel_equals_plain(cuda, name, bounces):
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, cuda)
    W, H = (96, 54) if name == "sphereflake" else (320, 180)
    s = _rays(scene, st, W, H, cuda, bounces)
    t_k, b_k, t_p, b_p = _both(st, s.o, s.d, s.time, s.alive)
    assert torch.equal(b_k, b_p)
    assert torch.equal(t_k, t_p)
    assert (b_k >= 0).any()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4097])
def test_ragged_ray_counts_and_inactive_rays(cuda, n):
    scene = build_scene("random")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 160, 90, cuda)
    idx = torch.randperm(160 * 90, device=cuda)[:n]
    active = torch.rand(n, device=cuda) < 0.6
    t_k, b_k, t_p, b_p = _both(st, s.o[idx], s.d[idx], s.time[idx], active)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k[~active] == -1).all()
    assert (t_k[~active] == float(np.float32(3.0e38))).all()


def test_single_sphere_and_counter(cuda):
    p0 = torch.tensor([[0.0, 0.0, -5.0]], device=cuda)
    one = torch.ones(1, device=cuda)
    o = torch.zeros(3, 3, device=cuda)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [0.0, 0.0, -2.0]],
                     device=cuda)
    time = torch.zeros(3, device=cuda)
    active = torch.ones(3, dtype=torch.bool, device=cuda)
    before = counter("K1.launches")
    t, best = sphere_sweep(p0, p0, one * 0, one, one, o, d, time, active)
    assert counter("K1.launches") == before + 1
    torch.testing.assert_close(t.cpu(), torch.tensor([4.0, 3.0e38, 2.0]))
    assert best.cpu().tolist() == [0, -1, 0]


def test_wrapper_validates_inputs(cuda):
    scene = build_scene("two-spheres")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 16, 9, cuda)
    good = (*st.spheres, s.o, s.d, s.time, s.alive)
    with pytest.raises(TypeError):
        sphere_sweep(*good[:5], s.o.double(), *good[6:])
    with pytest.raises(ValueError, match="contiguous"):
        sphere_sweep(*good[:5], s.o.t().contiguous().t(), *good[6:])
    with pytest.raises(ValueError, match="shape"):
        sphere_sweep(*good[:7], s.time[:-1], s.alive)
    with pytest.raises(ValueError, match="is on cpu"):
        sphere_sweep(*good[:7], s.time.cpu(), s.alive)


def test_render_on_card_matches_cpu(cuda):
    """Only the shading differs between the card and the CPU (ulps of
    sin/cos/acos), so the two images agree closely."""
    scene = build_scene("three-spheres")
    settings = RenderSettings(64, 36, 2, 4)
    before = counter("K1.launches")
    img_card = render_image(scene, settings, cuda)
    assert counter("K1.launches") > before
    img_cpu = render_image(scene, settings, "cpu")
    err = np.abs(img_card - img_cpu)
    assert (err <= 1e-4).mean() >= 0.99 and err.mean() < 4e-3


def _typed_both(st, s, bounce, active=None):
    bits = prng.bounce_base(s.base, bounce)
    active = s.alive if active is None else active
    args = (st.sweep, s.o.contiguous(), s.d.contiguous(),
            s.time.contiguous(), active.contiguous(), bits.contiguous())
    t_k, b_k = typed_sweep(*args)
    torch.cuda.synchronize()
    t_p, b_p = typed_sweep_plain(*args)
    return t_k, b_k, t_p, b_p


@pytest.mark.parametrize("name", ["final", "cornell", "cornell-smoke",
                                  "simple-light", "random"])
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_typed_sweep_equals_plain(cuda, name, bounces):
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 160, 90, cuda, bounces)
    t_k, b_k, t_p, b_p = _typed_both(st, s, bounces)
    assert torch.equal(b_k, b_p)
    assert torch.equal(t_k, t_p)
    assert (b_k >= 0).any()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4097])
def test_typed_sweep_ragged_counts_and_inactive_rays(cuda, n):
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 160, 90, cuda, 1)
    idx = torch.randperm(160 * 90, device=cuda)[:n]
    sub = type(s)(*(x[idx] for x in s))
    active = torch.rand(n, device=cuda) < 0.5
    t_k, b_k, t_p, b_p = _typed_both(st, sub, 1, active)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k[~active] == -1).all()
    assert (t_k[~active] == float(np.float32(3.0e38))).all()


def test_typed_sweep_counter_and_validation(cuda):
    scene = build_scene("cornell-smoke")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 16, 9, cuda)
    bits = prng.bounce_base(s.base, 0)
    before = counter("K1b.launches")
    typed_sweep(st.sweep, s.o, s.d, s.time, s.alive, bits)
    assert counter("K1b.launches") == before + 1
    with pytest.raises(TypeError):
        typed_sweep(st.sweep, s.o, s.d, s.time, s.alive, bits.int())
    with pytest.raises(ValueError, match="is on cpu"):
        typed_sweep(st.sweep, s.o, s.d, s.time, s.alive, bits.cpu())
    with pytest.raises(ValueError, match="shape"):
        typed_sweep(st.sweep, s.o, s.d, s.time[:-1], s.alive, bits)


def _noise_lanes(cuda, W=160, H=90):
    """The noise branch's inputs on `final`'s camera rays, as
    texture_value hands them to the kernel: the gathered int rows (the
    texture type is column 5), the scale and incoming value (strided
    views of the gathered float rows), the hit point and the tables."""
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, W, H, cuda)
    bb = prng.bounce_base(s.base, 0)
    t_hit, prim = trace(st, s, bb)
    idx = torch.clamp(prim, min=0).long()
    pf, sf = gather_prim_shade_packed(st.fpack, st.ipack, idx, scene.static)
    det = hit_detail(pf, s.o, s.d, s.time,
                     torch.where(prim >= 0, t_hit, 1.0), scene.static)
    return st.ipack[idx], sf.scale, det.point, sf.color1, st.tables


def _both_noise(ttype, scale, point, value, tables):
    got = noise_texture(ttype, scale, point, value, tables)
    torch.cuda.synchronize()
    return got, noise_texture_plain(ttype, scale, point, value, tables)


@pytest.mark.parametrize("mask_kind", ["scene", "all", "half"])
def test_marble_equals_plain(cuda, mask_kind):
    gi, scale, point, value, tables = _noise_lanes(cuda)
    lane = torch.arange(gi.shape[0], device=cuda)
    if mask_kind == "all":
        gi[:, 5] = TT_NOISE
    elif mask_kind == "half":
        gi[:, 5] = torch.where(lane % 2 == 0, TT_NOISE, 0)
    ttype = gi[:, 5]  # a strided view, as the row gather gives it
    noise = ttype == TT_NOISE
    assert noise.any() and ttype.stride(0) == 7 and scale.stride(0) > 1
    got, ref = _both_noise(ttype, scale, point, value, tables)
    assert torch.equal(got, ref)
    assert torch.equal(got[~noise], value[~noise])
    assert (got[noise] == got[noise][:, :1]).all()  # grey marble


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_marble_ragged_counts_and_far_points(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    point = (torch.rand((n, 3), device=cuda, generator=gen) - 0.5) * 2e3
    rows = torch.rand((n, 8), device=cuda, generator=gen)
    ttype = torch.where(rows[:, 0] < 0.7, TT_NOISE, 3).to(torch.int32)
    scale, value = rows[:, 1], rows[:, 4:7]
    keys = (17, 200, 3, 99, 255, 0, 0xDEADBEEF)
    tables = TextureTables(None, None, keys, perlin.PerlinTables(
        keys, **_hash_tables(keys, cuda)))
    before = counter("K2.launches")
    got, ref = _both_noise(ttype, scale, point, value, tables)
    assert counter("K2.launches") == before + 1
    assert torch.equal(got, ref)


def _hash_tables(keys, device):
    """The table form of the Perlin hashes of ``keys`` (what
    ``make_tables`` stores for a scene's keys)."""
    kx1, kx2, ky1, ky2, kz1, kz2, gseed = keys
    h = torch.arange(256, dtype=torch.int64)
    return dict(
        vectors=torch.stack(perlin._grad_xyz(h, gseed), -1).to(device),
        perm_x=perlin._perm8(h, kx1, kx2).to(torch.int32).to(device),
        perm_y=perlin._perm8(h, ky1, ky2).to(torch.int32).to(device),
        perm_z=perlin._perm8(h, kz1, kz2).to(torch.int32).to(device))


def test_noise_texture_validates_inputs(cuda):
    gi, scale, point, value, tables = _noise_lanes(cuda, 16, 9)
    ttype = gi[:, 5]
    with pytest.raises(TypeError):
        noise_texture(ttype.long(), scale, point, value, tables)
    with pytest.raises(ValueError, match="is on cpu"):
        noise_texture(ttype, scale.cpu(), point, value, tables)
    with pytest.raises(ValueError, match="shape"):
        noise_texture(ttype[:-1], scale, point, value, tables)
    with pytest.raises(ValueError, match="columns"):
        noise_texture(ttype, scale, point, value.t().contiguous().t(),
                      tables)


def _two_shutter_scene():
    """A ground and 300 small spheres: a third moving over [0, 1], a third
    over [0.25, 0.75], a third static, interleaved, so the kernels' lerp
    factor changes slot from one sphere to the next."""
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    for i, c in enumerate(rng.uniform(-6, 6, (300, 3))):
        c[1] = abs(c[1]) * 0.3
        if i % 3 == 0:
            b.moving_sphere(c, c + (0.0, 0.5, 0.0), 0.0, 1.0, 0.25, mat)
        elif i % 3 == 1:
            b.moving_sphere(c, c + (0.3, 0.0, 0.2), 0.25, 0.75, 0.25, mat)
        else:
            b.sphere(c, 0.25, mat)
    return b.finalize(CameraConfig((13, 2, 3), (0, 0, 0), 20.0, 0.0),
                      (0.7, 0.8, 1.0), "two-shutters")


@pytest.mark.parametrize("bounces", [0, 1])
def test_two_shutter_intervals(cuda, bounces):
    scene = _two_shutter_scene()
    st = to_device(scene.arrays, scene.static, cuda)
    assert st.sweep.shutter.shape[0] == 2
    s = _rays(scene, st, 160, 90, cuda, bounces)
    t_k, b_k, t_p, b_p = _both(st, s.o, s.d, s.time, s.alive)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    t_k, b_k, t_q, b_q = _typed_both(st, s, bounces)
    assert torch.equal(b_k, b_q) and torch.equal(t_k, t_q)
    won = b_p[b_p >= 0].long()
    sph = st.spheres
    moving = (sph.p1 != sph.p0).any(1)[won]
    assert (moving & (sph.time0[won] == 0.25)).any()
    assert (moving & (sph.time0[won] == 0.0)).any()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 511, 512, 513, 1023,
                               1024, 1025, 4097])
def test_packet_and_block_edges(cuda, n):
    """Ray counts around 128 (a packet's stride) and 4 * 128 (a block of
    R = 4 packets) and their multiples, with inactive rays, through both
    sweeps."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    for name, bounces in (("random", 0), ("final", 1)):
        scene = build_scene(name)
        st = to_device(scene.arrays, scene.static, cuda)
        s = _rays(scene, st, 80, 60, cuda, bounces)
        idx = torch.randperm(80 * 60, device=cuda, generator=gen)[:n]
        sub = type(s)(*(x[idx] for x in s))
        active = torch.rand(n, device=cuda, generator=gen) < 0.6
        if name == "random":
            t_k, b_k, t_p, b_p = _both(st, sub.o, sub.d, sub.time, active)
        else:
            t_k, b_k, t_p, b_p = _typed_both(st, sub, bounces, active)
        assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
        assert (b_k[~active] == -1).all()


def _long_tile_scene(media: bool):
    """tests/test_torch_typed_sweep.py's 700 spheres (plan tiles of 512 and
    188) and 37 boxes; with ``media``, 300 medium spheres and 40 medium
    boxes too.  Tile boundaries fall inside the kernel's stages and tiles
    span several stages."""
    rng = np.random.default_rng(9)
    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    for c in rng.uniform(-20, 20, (700, 3)):
        b.sphere(c, float(rng.uniform(0.2, 1.5)), mat)
    for c in rng.uniform(-20, 20, (37, 3)):
        b.cuboid(c, c + rng.uniform(0.5, 3.0, 3), mat)
    if media:
        tex = b.solid((0.9, 0.9, 0.9))
        for c in rng.uniform(-20, 20, (300, 3)):
            b.medium_sphere(c, float(rng.uniform(0.5, 2.0)), 0.3, tex)
        for c in rng.uniform(-20, 20, (40, 3)):
            b.medium_box(c, c + rng.uniform(0.5, 3.0, 3), 0.2, tex)
    return b.finalize(CameraConfig((0, 0, 60), (0, 0, 0), 40.0, 0.0),
                      (0.0, 0.0, 0.0), "ragged"), rng


@pytest.mark.parametrize("media", [False, True])
def test_typed_sweep_tiles_across_stages(cuda, media):
    scene, rng = _long_tile_scene(media)
    st = to_device(scene.arrays, scene.static, cuda)
    widths = [t.width for t in st.sweep.plan]
    assert max(widths) == 512 and len(widths) == (5 if media else 3)
    n = 4001
    o, d, time, bits, active = (
        torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
            rng.uniform(-25, 25, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.random(n, dtype=np.float32),
            rng.integers(0, 2**32, n).astype(np.int64),
            rng.random(n) < 0.9))
    args = (st.sweep, o, d, time, active, bits)
    t_k, b_k = typed_sweep(*args)
    torch.cuda.synchronize()
    t_p, b_p = typed_sweep_plain(*args)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_p >= 0).float().mean() > 0.2


def test_final_render_goes_through_both_kernels(cuda):
    """A render of `final` traces through K1b and shades through K6,
    whose marble is K2's arithmetic in the same launch."""
    scene = build_scene("final")
    counts = (counter("K1.launches"), counter("K1b.launches"),
              counter("K6.launches"), counter("K2.launches"))
    img = render_image(scene, RenderSettings(64, 36, 1, 3), cuda)
    assert counter("K1.launches") == counts[0]
    assert counter("K1b.launches") > counts[1]
    assert counter("K6.launches") > counts[2]
    assert counter("K2.launches") == counts[3]
    assert img.shape == (36, 64, 3) and np.isfinite(img).all()


# K2b against autograd through the plain marble: grad_value is a copy
# (bit-equal); grad_point and grad_scale sum the analytic derivative of
# each octave where autograd chains every operation, so they agree to
# rounding: 1e-4 of each output's largest magnitude.
GRAD_SHARE = 1e-4


def _grad_rules(got, ref, noise):
    (gp, gs, gv), (rp, rs, rv) = got, ref
    assert torch.equal(gv, rv)
    assert (gv[noise] == 0).all() and (gp[~noise] == 0).all() \
        and (gs[~noise] == 0).all()
    for g, r in ((gp, rp), (gs, rs)):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max() <= GRAD_SHARE * r.abs().max()


@pytest.mark.parametrize("mask_kind", ["scene", "all"])
def test_marble_grad_equals_plain(cuda, mask_kind):
    """K2 with its save, then K2b on the saved bitmask and turbulence
    sums, against autograd through the plain marble."""
    gi, scale, point, value, tables = _noise_lanes(cuda)
    if mask_kind == "all":
        gi[:, 5] = TT_NOISE
    ttype = gi[:, 5]
    noise = ttype == TT_NOISE
    gen = torch.Generator(device=cuda).manual_seed(11)
    grad_out = torch.rand(point.shape, device=cuda, generator=gen) - 0.5
    _, saved = noise_texture_saved(ttype, scale, point, value, tables)
    before = counter("K2b.launches")
    got = noise_texture_grad(scale, point, grad_out, tables, saved)
    torch.cuda.synchronize()
    assert counter("K2b.launches") == before + 1
    ref = noise_texture_grad_plain(ttype, scale, point, grad_out, tables)
    _grad_rules(got, ref, noise)
    with pytest.raises(ValueError, match="mask"):
        noise_texture_grad(scale, point, grad_out, tables,
                           (saved[0][:-1], saved[1]))


@pytest.mark.parametrize("n", [1, 31, 33, 1025, 100_003])
def test_marble_save_equals_plain(cuda, n):
    """K2's save: the bitmask bit for bit, the turbulence sums on the
    noise lanes bit for bit (K2 rounds as the plain version does), and
    the value as without the save."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    point = (torch.rand((n, 3), device=cuda, generator=gen) - 0.5) * 20.0
    rows = torch.rand((n, 8), device=cuda, generator=gen)
    ttype = torch.where(rows[:, 0] < 0.6, TT_NOISE, 3).to(torch.int32)
    scale, value = rows[:, 1] * 4.0, rows[:, 4:7]
    keys = (17, 200, 3, 99, 255, 0, 0xDEADBEEF)
    tables = TextureTables(None, None, keys, perlin.PerlinTables(
        keys, **_hash_tables(keys, cuda)))
    before = (counter("K2.launches"), counter("K2.saves"))
    out, (mask, turb) = noise_texture_saved(ttype, scale, point, value,
                                            tables)
    torch.cuda.synchronize()
    assert (counter("K2.launches"), counter("K2.saves")) == \
        (before[0] + 1, before[1] + 1)
    ref, (mask_p, turb_p) = noise_texture_saved_plain(ttype, scale, point,
                                                      value, tables)
    noise = ttype == TT_NOISE
    assert torch.equal(out, ref)
    assert torch.equal(mask, mask_p)
    assert torch.equal(turb[noise], turb_p[noise])


def test_render_without_grad_saves_nothing(cuda):
    """A render (no grad) shades its noise lanes inside K6 and launches
    no K2, so nothing is saved; a train step's forward launches K2 with
    the save, and its backward K2b."""
    scene = build_scene("final")
    before = (counter("K2.launches"), counter("K2.saves"),
              counter("K6.launches"))
    render_image(scene, RenderSettings(64, 36, 1, 3), cuda)
    assert counter("K2.launches") == before[0]
    assert counter("K2.saves") == before[1]
    assert counter("K6.launches") > before[2]
    st = to_device(scene.arrays, scene.static, cuda)
    counts = (counter("K2.saves"), counter("K2b.launches"))
    _loss_and_grads(scene, st, cuda, 32, 18, 1, 2)
    assert counter("K2.saves") > counts[0]
    assert counter("K2b.launches") > counts[1]


def test_marble_backward_runs_k2b(cuda):
    """Under autograd on the card the noise branch runs K2 forward and
    K2b backward, and its gradients are the plain version's."""
    gi, scale, point, value, tables = _noise_lanes(cuda, 64, 36)
    gi[:, 5] = torch.where(torch.arange(gi.shape[0], device=cuda) % 3 == 0,
                           TT_NOISE, 0)
    ttype = gi[:, 5]
    leaves = [x.detach().clone().requires_grad_()
              for x in (scale, point, value)]
    counts = (counter("K2.launches"), counter("K2b.launches"))
    out = noise_texture(ttype, *leaves, tables)
    weight = torch.linspace(-1, 1, out.numel(), device=cuda).view_as(out)
    got = torch.autograd.grad((out * weight).sum(), leaves)
    assert (counter("K2.launches"), counter("K2b.launches")) == \
        (counts[0] + 1, counts[1] + 1)
    rp, rs, rv = noise_texture_grad_plain(ttype, scale, point, weight,
                                          tables)
    _grad_rules((got[1], got[0], got[2]), (rp, rs, rv), ttype == TT_NOISE)


def _loss_and_grads(scene, st, dev, W, H, spp, depth):
    """The loss and every parameter's gradient (the keys the render
    reads) of ``make_loss_fn`` on ``dev`` against a constant target."""
    params = {k: v.detach().clone().requires_grad_() for k, v in
              extract_params(st.arrays).items()}
    pix, sam = pixel_lanes(W, H, spp, dev)
    loss = make_loss_fn(scene, W, H, depth)(
        params, st, make_basis(scene.camera, W, H), pix, sam, 0,
        torch.full((W * H, 3), 0.25, device=dev))
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()
                           if p.grad is not None}


@pytest.mark.parametrize("name", ["random", "final", "earth"])
def test_train_step_gradients_are_reproducible(cuda, name):
    """Two loss-and-gradient passes from one state give bit-equal losses
    and gradients: the gathers' backward (K3) sums in one fixed order."""
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, cuda)
    before = counter("K3.launches")
    loss_a, g_a = _loss_and_grads(scene, st, cuda, 64, 36, 2, 4)
    loss_b, g_b = _loss_and_grads(scene, st, cuda, 64, 36, 2, 4)
    assert counter("K3.launches") > before
    assert torch.equal(loss_a, loss_b)
    assert g_a.keys() == g_b.keys() and "geom.p0" in g_a
    for k in g_a:
        assert torch.equal(g_a[k], g_b[k]), k


def _segment_case(n, n_rows, f, kind, dev):
    gen = torch.Generator(device=dev).manual_seed(n + n_rows + f)
    src = torch.randn((n, f), device=dev, generator=gen) * 10.0 ** \
        torch.randint(-4, 4, (n, 1), device=dev, generator=gen)
    if kind == "one row":
        idx = torch.full((n,), n_rows - 1, device=dev)
    elif kind == "skew":  # seven lanes in ten into row 0, a ground sphere
        idx = torch.where(torch.rand(n, device=dev, generator=gen) < 0.7, 0,
                          torch.randint(0, n_rows, (n,), device=dev,
                                        generator=gen))
    else:  # every third row empty
        idx = torch.randint(0, n_rows // 3 + 1, (n,), device=dev,
                            generator=gen) * 3 % n_rows
    return src, idx


@pytest.mark.parametrize("n,n_rows,f,kind", [
    (0, 5, 3, "sparse"), (1, 1, 1, "one row"), (CHUNK - 1, 9, 20, "skew"),
    (CHUNK, 9, 20, "one row"), (CHUNK + 1, 486, 20, "sparse"),
    (100_003, 486, 20, "skew"), (100_003, 7, 19, "one row"),
    (70_001, 524_288, 3, "sparse"), (720_000, 486, 20, "skew"),
    (720_000, 524_288, 3, "skew"),
    (50_000, ONE_PASS_ROWS, 20, "sparse"), (50_000, ONE_PASS_ROWS, 20, "skew"),
    (50_000, ONE_PASS_ROWS + 1, 20, "sparse"),
    (50_000, ONE_PASS_ROWS + 1, 3, "skew"),
    (300_001, 2**20, 3, "sparse"), (300_001, 2**20, 3, "skew"),
    (3 * 8192 + 17, 486, 20, "skew"), (8192 * 5 - 1, 1409, 19, "sparse"),
    (200_000, 486, 40, "skew")])
def test_segment_sum_equals_plain(cuda, n, n_rows, f, kind):
    """K3 against its plain version, bit for bit, on ragged shapes: one
    row taking every lane, empty rows, no lanes, chunk edges, the winner
    gather of a `random` step (720,000 lanes into 486 rows of 20) and
    texel gathers (into 524,288 rows of 3; with one texel taking seven
    lanes in ten, a row over more chunks than two levels of K3 combine).
    The sort: rows at its one-pass limit (ONE_PASS_ROWS) and one above
    (two passes of 6 bits), 2^20 rows (two passes of 10 bits), lane
    counts that are not a multiple of its 8,192-lane tile; rows wider
    than one of the reduction's column slices (40 > 31)."""
    src, idx = _segment_case(n, n_rows, f, kind, cuda)
    before = counter("K3.launches")
    got = segment_sum(src, idx, n_rows)
    torch.cuda.synchronize()
    assert counter("K3.launches") == before + (n > 0)
    ref = segment_sum_plain(src, idx, n_rows)
    assert torch.equal(got, ref)
    assert torch.equal(segment_sum(src, idx, n_rows), got)


@pytest.mark.parametrize("offset", [
    0, 1, 2, 3, CHUNK - 3, CHUNK - 2, CHUNK * FAN_OUT - 3,
    CHUNK * FAN_OUT - 1, CHUNK * FAN_OUT * FAN_OUT - 2])
def test_segment_sum_tree_across_kernel_edges(cuda, offset):
    """1e8, 1, -1e8, 1 into one row after ``offset`` lanes of another
    (tests/test_torch_gather.py: their sum is 0.0 or 1.0 by where the
    tree's nodes fall): K3 equals its plain version where the four lanes
    straddle a chunk's edge, a level's unit edge and a second level's,
    and so where K3 hands a row's partial sums on."""
    src = torch.cat([torch.zeros((offset, 2), device=cuda),
                     torch.tensor([[1e8, 1.0], [1.0, 1e8], [-1e8, 1.0],
                                   [1.0, -1e8]], device=cuda)])
    idx = torch.cat([torch.zeros(offset, dtype=torch.int64, device=cuda),
                     torch.ones(4, dtype=torch.int64, device=cuda)])
    got = segment_sum(src, idx, 2)
    assert torch.equal(got, segment_sum_plain(src, idx, 2))
    assert got[1, 0].item() in (0.0, 1.0)


def test_segment_sum_counts_one_launch_and_sorts_itself(cuda, monkeypatch):
    """One call adds exactly one to ``K3.launches``, and the card
    path orders the lanes itself: ``torch.sort`` (and ``Tensor.sort``)
    raise for the duration of the call."""
    src, idx = _segment_case(100_003, 486, 20, "skew", cuda)
    ref = segment_sum_plain(src, idx, 486)

    def no_sort(*args, **kwargs):
        raise AssertionError("segment_sum called a sort on the card")

    monkeypatch.setattr(torch, "sort", no_sort)
    monkeypatch.setattr(torch.Tensor, "sort", no_sort)
    before = counter("K3.launches")
    got = segment_sum(src, idx, 486)
    torch.cuda.synchronize()
    assert counter("K3.launches") == before + 1
    monkeypatch.undo()
    assert torch.equal(got, ref)


def test_gather_rows_backward_runs_k3(cuda):
    table = torch.randn((486, 20), device=cuda, requires_grad=True)
    src, idx = _segment_case(50_000, 486, 20, "skew", cuda)
    before = counter("K3.launches")
    (g,) = torch.autograd.grad(gather_rows(table, idx), table, src)
    assert counter("K3.launches") == before + 1
    assert torch.equal(g, segment_sum_plain(src, idx, 486))
    with pytest.raises(ValueError, match="shape"):
        segment_sum(src, idx[:-1], 486)


@pytest.mark.parametrize("name", ["three-spheres", "final"])
def test_train_step_gradients_on_card_match_cpu(cuda, name):
    """The loss and every parameter's gradient of a small train step on
    the card against the CPU's: the kernels equal their plain versions
    (K3 sums the gathers in the CPU's order), so only float32 rounding
    elsewhere and K2b's separate the two.  Measured on an H100, max
    |card - cpu| over max |cpu|: 4.55e-5 (`three-spheres`) and 9.79e-6
    (`final`); each bound is the 1-2-5 step at least 3x that."""
    scene = build_scene(name)
    out = {}
    for dev in ("cpu", cuda):
        st = to_device(scene.arrays, scene.static, dev)
        loss, grads = _loss_and_grads(scene, st, dev, 32, 18, 2, 3)
        out[str(dev)] = (loss.item(), {k: g.cpu() for k, g in grads.items()})
    (loss_c, g_c), (loss_g, g_g) = out["cpu"], out[str(cuda)]
    share = 5e-5 if name == "final" else 2e-4
    assert loss_g == pytest.approx(loss_c, rel=share)
    assert g_c.keys() == g_g.keys()
    for k, ref in g_c.items():
        assert torch.isfinite(g_g[k]).all(), k
        assert (g_g[k] - ref).abs().max() <= share * ref.abs().max(), k


def _bvh_scene(name, leaf, dev):
    scene = build_scene(name)
    arrays, bvh, _ = prepare_scene(scene, "bvh", leaf)
    return scene, to_device(arrays, scene.static, dev, bvh)


def _bvh_both(st, o, d, time, active, bits):
    args = (o.contiguous(), d.contiguous(), time.contiguous(),
            active.contiguous(), bits.contiguous())
    t_k, b_k = bvh_traverse(st.bvh, *args, T_MIN)
    torch.cuda.synchronize()
    t_p, b_p = bvh_traverse_plain(st.bvh.tree, st.bvh.prims, *args, T_MIN,
                                  st.bvh.static)
    return t_k, b_k, t_p, b_p


# chip_smoke.py phase 18's scenes and leaf sizes.
BVH_CASES = [("random", 4), ("cornell", 4), ("cornell-smoke", 4),
             ("final", 1), ("final", 4), ("final", 8),
             ("sphereflake-small", 4)]


@pytest.mark.parametrize("name,leaf", BVH_CASES,
                         ids=[f"{n}-leaf{k}" for n, k in BVH_CASES])
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_bvh_traverse_equals_plain(cuda, name, leaf, bounces):
    scene, st = _bvh_scene(name, leaf, cuda)
    s = _rays(scene, st, 160, 90, cuda, bounces)
    t_k, b_k, t_p, b_p = _bvh_both(st, s.o, s.d, s.time, s.alive,
                                   prng.bounce_base(s.base, bounces))
    assert torch.equal(b_k, b_p)
    assert torch.equal(t_k, t_p)
    assert (b_k >= 0).any()


def test_bvh_traverse_sphereflake_equals_plain(cuda):
    scene, st = _bvh_scene("sphereflake", 4, cuda)
    s = _rays(scene, st, 96, 54, cuda, 1)
    t_k, b_k, t_p, b_p = _bvh_both(st, s.o, s.d, s.time, s.alive,
                                   prng.bounce_base(s.base, 1))
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)


def test_bvh_traverse_nan_slab_rays(cuda):
    from test_torch_bvh import flat_scene, slab_nan_rays

    scene = flat_scene()
    for leaf in (1, 4, 8):
        arrays, bvh, _ = prepare_scene(scene, "bvh", leaf)
        st = to_device(arrays, scene.static, cuda, bvh)
        o, d, time, bits = (torch.from_numpy(np.array(x)).to(cuda) for x in
                            slab_nan_rays(scene))
        active = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
        t_k, b_k, t_p, b_p = _bvh_both(st, o, d, time, active, bits.long())
        assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)


def test_bvh_traverse_two_launches_in_a_row_agree(cuda):
    """A second launch straight after the first, on the same stream,
    walks every ray again to the same result."""
    scene, st = _bvh_scene("sphereflake", 4, cuda)
    s = _rays(scene, st, 320, 180, cuda)
    args = (s.o, s.d, s.time, s.alive, prng.bounce_base(s.base, 0))
    t1, b1 = bvh_traverse(st.bvh, *args, T_MIN)
    t2, b2 = bvh_traverse(st.bvh, *args, T_MIN)
    torch.cuda.synchronize()
    t_p, b_p = bvh_traverse_plain(st.bvh.tree, st.bvh.prims, *args, T_MIN,
                                  st.bvh.static)
    for t_k, b_k in ((t1, b1), (t2, b2)):
        assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_p >= 0).float().mean() > 0.5


def test_bvh_traverse_tie_goes_to_the_lowest_index(cuda):
    from test_torch_bvh import tie_rays, tie_scene

    scene = tie_scene()
    arrays, bvh, _ = prepare_scene(scene, "bvh", 1)
    st = to_device(arrays, scene.static, cuda, bvh)
    o, d, time, active, bits = (torch.from_numpy(np.array(x)).to(cuda)
                                for x in tie_rays())
    t_k, b_k, t_p, b_p = _bvh_both(st, o, d, time, active, bits)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k == 0).all()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4097])
def test_bvh_traverse_ragged_counts_and_inactive_rays(cuda, n):
    scene, st = _bvh_scene("final", 4, cuda)
    s = _rays(scene, st, 160, 90, cuda, 1)
    idx = torch.randperm(160 * 90, device=cuda)[:n]
    active = torch.rand(n, device=cuda) < 0.6
    t_k, b_k, t_p, b_p = _bvh_both(
        st, s.o[idx], s.d[idx], s.time[idx], active,
        prng.bounce_base(s.base, 1)[idx])
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k[~active] == -1).all()


def test_bvh_traverse_counter_and_validation(cuda):
    scene, st = _bvh_scene("cornell", 4, cuda)
    s = _rays(scene, st, 16, 9, cuda)
    bits = prng.bounce_base(s.base, 0)
    before = counter("K4.launches")
    bvh_traverse(st.bvh, s.o, s.d, s.time, s.alive, bits)
    assert counter("K4.launches") == before + 1
    with pytest.raises(TypeError):
        bvh_traverse(st.bvh, s.o.double(), s.d, s.time, s.alive, bits)
    with pytest.raises(ValueError, match="is on cpu"):
        bvh_traverse(st.bvh, s.o, s.d, s.time.cpu(), s.alive, bits)


@pytest.mark.parametrize("name", ["random", "cornell", "sphereflake-small"])
def test_bvh_render_on_card_equals_sweep(cuda, name):
    scene = build_scene(name)
    s = dict(width=64, height=36, samples=2, depth=4)
    before = counter("K4.launches")
    bvh = render_image(scene, RenderSettings(**s, intersector="bvh"), cuda)
    assert counter("K4.launches") > before
    sweep = render_image(scene, RenderSettings(**s, intersector="sweep"),
                         cuda)
    np.testing.assert_array_equal(bvh, sweep)


def _cluster_scene(name, dev):
    if name == "sphereflake-3":
        from hyper_ray_tracer_tpu_torch.models.builders import sphereflake

        scene = sphereflake(3, "sphereflake-3")
    else:
        scene = build_scene(name)
    arrays, layout, _ = prepare_scene(scene, "cluster")
    return scene, to_device(arrays, scene.static, dev, layout)


def _cluster_both(cs, o, d, time, active, bits):
    args = (o.contiguous(), d.contiguous(), time.contiguous(),
            active.contiguous(), bits.contiguous())
    t_k, b_k = cluster_sweep(cs, *args, T_MIN)
    torch.cuda.synchronize()
    t_p, b_p = cluster_sweep_plain(cs, *args, T_MIN)
    return t_k, b_k, t_p, b_p


# chip_smoke.py phase 24's scenes: motion, boxes and media in the tail
# (`final`), transforms in the tail (`cornell`), sphere runs with pads.
CLUSTER_CASES = ["random", "final", "cornell", "cornell-smoke",
                 "sphereflake-3", "sphereflake-small"]


@pytest.mark.parametrize("name", CLUSTER_CASES)
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_cluster_sweep_equals_plain(cuda, name, bounces):
    scene, st = _cluster_scene(name, cuda)
    s = _rays(scene, st, 160, 90, cuda, bounces)
    t_k, b_k, t_p, b_p = _cluster_both(st.cluster, s.o, s.d, s.time,
                                       s.alive,
                                       prng.bounce_base(s.base, bounces))
    assert torch.equal(b_k, b_p)
    assert torch.equal(t_k, t_p)
    assert (b_k >= 0).any()


def test_cluster_sweep_sphereflake_equals_plain(cuda):
    scene, st = _cluster_scene("sphereflake", cuda)
    s = _rays(scene, st, 96, 54, cuda, 1)
    t_k, b_k, t_p, b_p = _cluster_both(st.cluster, s.o, s.d, s.time,
                                       s.alive, prng.bounce_base(s.base, 1))
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4097])
def test_cluster_sweep_ragged_counts_and_inactive_rays(cuda, n):
    scene, st = _cluster_scene("final", cuda)
    s = _rays(scene, st, 160, 90, cuda, 1)
    idx = torch.randperm(160 * 90, device=cuda)[:n]
    active = torch.rand(n, device=cuda) < 0.6
    t_k, b_k, t_p, b_p = _cluster_both(
        st.cluster, s.o[idx], s.d[idx], s.time[idx], active,
        prng.bounce_base(s.base, 1)[idx])
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k[~active] == -1).all()


def test_cluster_sweep_runs_longer_than_a_staged_chunk(cuda, monkeypatch):
    """A run of MAX_CLUSTERS_PER_RUN clusters, 16 of K5's windows of 256
    (and four of the first design's staged chunks of 1,024): the layout
    of sphereflake at 16 primitives a cluster (4,096 clusters)."""
    import hyper_ray_tracer_tpu_torch.models.clusters as C

    monkeypatch.setattr(C, "CLUSTER_TARGET_PRIMS", 16)
    scene, st = _cluster_scene("sphereflake", cuda)
    assert st.cluster.layout.runs[0].n_clusters > 1024
    s = _rays(scene, st, 64, 36, cuda, 1)
    t_k, b_k, t_p, b_p = _cluster_both(st.cluster, s.o, s.d, s.time,
                                       s.alive, prng.bounce_base(s.base, 1))
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)


@pytest.mark.parametrize("n_clusters", [255, 256, 257, 1000, 4095])
def test_cluster_sweep_ragged_last_window(cuda, monkeypatch, n_clusters):
    """Runs cut short of a whole number of K5's windows of 256: the first
    ``n_clusters`` clusters of the 4,096-cluster layout above."""
    import hyper_ray_tracer_tpu_torch.models.clusters as C

    monkeypatch.setattr(C, "CLUSTER_TARGET_PRIMS", 16)
    scene, st = _cluster_scene("sphereflake", cuda)
    cs = cut_run(st.cluster, n_clusters)
    s = _rays(scene, st, 64, 36, cuda, 1)
    t_k, b_k, t_p, b_p = _cluster_both(cs, s.o, s.d, s.time, s.alive,
                                       prng.bounce_base(s.base, 1))
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k >= 0).any()


def test_cluster_sweep_equal_entries_go_to_the_lower_cluster(cuda):
    from cluster_cases import ENTRY_TIES, two_spheres_case

    for z, boxes, winner, t_win in ENTRY_TIES:
        cs, ray, first = two_spheres_case(z, boxes)
        cs = cs._replace(**{k: getattr(cs, k).to(cuda) for k in (
            "tail_rows", "run_rows", "boxes", "geo", "aux", "tag", "xf",
            "shutter")})
        t, best = cluster_sweep(cs, *(x.to(cuda) for x in ray), T_MIN)
        assert (int(best[0]), float(t[0])) == (first[winner], t_win)


def test_cluster_sweep_tie_goes_to_the_lowest_slot(cuda):
    from cluster_cases import tie_case

    cs, ray, a, t_a, b = tie_case()
    cs = cs._replace(**{k: getattr(cs, k).to(cuda) for k in (
        "tail_rows", "run_rows", "boxes", "geo", "aux", "tag", "xf",
        "shutter")})
    t, best = cluster_sweep(cs, *(x.to(cuda) for x in ray), T_MIN)
    assert (int(best[0]), float(t[0])) == (a, t_a)


def test_cluster_sweep_counter_and_validation(cuda):
    scene, st = _cluster_scene("cornell", cuda)
    s = _rays(scene, st, 16, 9, cuda)
    bits = prng.bounce_base(s.base, 0)
    before = counter("K5.launches")
    cluster_sweep(st.cluster, s.o, s.d, s.time, s.alive, bits)
    assert counter("K5.launches") == before + 1
    with pytest.raises(TypeError):
        cluster_sweep(st.cluster, s.o.double(), s.d, s.time, s.alive, bits)
    with pytest.raises(ValueError, match="is on cpu"):
        cluster_sweep(st.cluster, s.o, s.d, s.time.cpu(), s.alive, bits)


def test_cluster_sweep_window_is_the_plain_versions(cuda, monkeypatch):
    """K5's kWindow equals WINDOW, and the wrapper refuses a kernel whose
    window differs from the plain version's."""
    import hyper_ray_tracer_tpu_torch.ops.cluster_sweep as k5

    assert cuda_build.load("cluster_sweep").hrt_cluster_sweep_window() == \
        k5.WINDOW
    scene, st = _cluster_scene("cornell", cuda)
    s = _rays(scene, st, 16, 9, cuda)
    monkeypatch.setattr(k5, "WINDOW", k5.WINDOW // 2)
    before = counter("K5.launches")
    with pytest.raises(RuntimeError, match="window"):
        cluster_sweep(st.cluster, s.o, s.d, s.time, s.alive,
                      prng.bounce_base(s.base, 0))
    assert counter("K5.launches") == before


@pytest.mark.parametrize("name", ["random", "final", "cornell",
                                  "sphereflake-3"])
def test_cluster_render_on_card_equals_sweep(cuda, name):
    scene, _ = _cluster_scene(name, "cpu")
    s = dict(width=64, height=36, samples=2, depth=4)
    before = counter("K5.launches")
    clus = render_image(scene, RenderSettings(**s, intersector="cluster"),
                        cuda)
    assert counter("K5.launches") > before
    sweep = render_image(scene, RenderSettings(**s, intersector="sweep"),
                         cuda)
    np.testing.assert_array_equal(clus, sweep)


# The partitioned form of K1b and K1 (ops/partition.py): each lane's group
# mask; a lane folds a group's primitives only when its mask has the
# group's bit.  The kernels equal their twins on any mask, and on the
# box test's masks also the unmasked kernels.


def _masked(kernel, plain, args, mask, **kw):
    t_m, b_m = kernel(*args, mask=mask, **kw)
    torch.cuda.synchronize()
    t_p, b_p = plain(*args, mask=mask, **kw)
    return t_m, b_m, t_p, b_p


@pytest.mark.parametrize("order", ["launch", "category"])
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_partitioned_typed_sweep_equals_plain(cuda, bounces, order):
    from hyper_ray_tracer_tpu_torch.ops import partition

    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 160, 90, cuda, bounces)
    mask = partition.group_mask(st.groups, s.o, s.d, st.group_aabbs)
    bits = prng.bounce_base(s.base, bounces)
    if order == "category":
        idx = torch.sort(3 - mask.int(), stable=True).indices
        s, mask, bits = type(s)(*(x[idx] for x in s)), mask[idx], bits[idx]
    args = (st.sweep, s.o.contiguous(), s.d.contiguous(),
            s.time.contiguous(), s.alive.contiguous(), bits.contiguous())
    t_m, b_m, t_p, b_p = _masked(typed_sweep, typed_sweep_plain, args,
                                 mask.contiguous())
    assert torch.equal(b_m, b_p) and torch.equal(t_m, t_p)
    t_k, b_k = typed_sweep(*args)
    assert torch.equal(b_m, b_k) and torch.equal(t_m, t_k)
    assert (mask != 3).any() and (b_k >= 0).any()


@pytest.mark.parametrize("n", [1, 127, 129, 513, 4097])
def test_partitioned_typed_sweep_any_mask(cuda, n):
    """The lane-level contract on random masks and inactive rays: the
    kernel equals its twin whatever the masks say."""
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 160, 90, cuda, 1)
    gen = torch.Generator(device=cuda).manual_seed(n)
    idx = torch.randperm(s.o.shape[0], device=cuda, generator=gen)[:n]
    s = type(s)(*(x[idx] for x in s))
    active = torch.rand(n, device=cuda, generator=gen) < 0.7
    mask = torch.randint(0, 4, (n,), device=cuda, generator=gen,
                         dtype=torch.uint8)
    args = (st.sweep, s.o.contiguous(), s.d.contiguous(),
            s.time.contiguous(), active, prng.bounce_base(s.base, 1))
    t_m, b_m, t_p, b_p = _masked(typed_sweep, typed_sweep_plain, args, mask)
    assert torch.equal(b_m, b_p) and torch.equal(t_m, t_p)
    assert (b_m[~active] == -1).all()


def _two_sphere_groups(st):
    from hyper_ray_tracer_tpu_torch.ops.partition import PartGroup

    p0 = st.spheres.p0.cpu().numpy()
    r = np.abs(st.spheres.radius.cpu().numpy())[:, None]
    return tuple(PartGroup(a, b, tuple(float(v) for v in
                                       (p0[a:b] - r[a:b]).min(0)),
                           tuple(float(v) for v in
                                 (p0[a:b] + r[a:b]).max(0)), True)
                 for a, b in ((96, 300), (300, 486)))


@pytest.mark.parametrize("case", ["random", "random-two-groups",
                                  "random-any-mask", "sphereflake"])
@pytest.mark.parametrize("bounces", [0, 1])
def test_partitioned_sphere_sweep_equals_plain(cuda, case, bounces):
    from hyper_ray_tracer_tpu_torch.ops import partition

    scene = build_scene(case.split("-")[0])
    st = to_device(scene.arrays, scene.static, cuda)
    W, H = (96, 54) if case == "sphereflake" else (320, 180)
    s = _rays(scene, st, W, H, cuda, bounces)
    sph, groups = st.spheres, st.groups
    if case == "random-two-groups":  # static centers inside the boxes
        sph, groups = sph._replace(p1=sph.p0), _two_sphere_groups(st)
    mask = partition.group_mask(groups, s.o, s.d)
    if case == "random-any-mask":
        gen = torch.Generator(device=cuda).manual_seed(bounces)
        mask = torch.randint(0, 2, mask.shape, device=cuda, generator=gen,
                             dtype=torch.uint8)
    args = (*sph, s.o.contiguous(), s.d.contiguous(), s.time.contiguous(),
            s.alive.contiguous())
    t_m, b_m, t_p, b_p = _masked(sphere_sweep, sphere_sweep_plain, args,
                                 mask, groups=groups)
    assert torch.equal(b_m, b_p) and torch.equal(t_m, t_p)
    if case != "random-any-mask":
        t_k, b_k = sphere_sweep(*args)
        assert torch.equal(b_m, b_k) and torch.equal(t_m, t_k)


@pytest.mark.parametrize("name", ["final", "random"])
def test_partitioned_render_on_card_equals_plain(cuda, name, monkeypatch):
    from hyper_ray_tracer_tpu_torch.ops import partition

    monkeypatch.setattr(partition, "PART_MIN_LANES", 1024)
    monkeypatch.setattr(partition, "PART_SAVED_MIN", 0.0)
    scene = build_scene(name)
    s = dict(width=64, height=36, samples=2, depth=6, spp_chunk=1)
    before = (counter("K1b.partitioned"), counter("K1.partitioned"))
    img = render_image(scene, RenderSettings(**s), cuda)
    assert (counter("K1b.partitioned"), counter("K1.partitioned")) != before
    plain = render_image(scene, RenderSettings(**s, partition=False), cuda)
    np.testing.assert_array_equal(img, plain)


def test_partitioned_train_step_on_card(cuda, monkeypatch):
    """A partitioned step's loss equals the plain one's, its gradients
    within 1e-5 of each key's largest (K3's addend order), and two calls
    from one state are bit-equal."""
    from hyper_ray_tracer_tpu_torch.ops import partition

    monkeypatch.setattr(partition, "PART_MIN_LANES", 1024)
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    W, H, spp, depth = 64, 36, 2, 4
    basis = make_basis(scene.camera, W, H)
    pix, sam = pixel_lanes(W, H, spp, cuda)
    target = torch.zeros((W * H, 3), device=cuda)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}

    def run(loss_fn):
        for p in params.values():
            p.grad = None
        loss = loss_fn(params, st, basis, pix, sam, 0, target)
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in params.items()
                               if p.grad is not None}

    part = make_loss_fn(scene, W, H, depth, partition=True)
    l_p, g_p = run(part)
    assert any(part.schedule().decisions)
    l_0, g_0 = run(make_loss_fn(scene, W, H, depth))
    assert torch.equal(l_p, l_0)
    for k in g_0:
        scale = g_0[k].abs().max()
        assert ((g_p[k] - g_0[k]).abs().max() <= 1e-5 * scale).item(), k
    l_2, g_2 = run(part)
    assert torch.equal(l_2, l_p)
    assert all(torch.equal(g_2[k], g_p[k]) for k in g_p)


@pytest.mark.parametrize("name", ["three-spheres", "final",
                                  "sphereflake-small"])
@pytest.mark.parametrize("bounces", [0, 1])
def test_bf16_typed_sweep_equals_plain(cuda, name, bounces):
    """K1b's bf16 form against its twin, bit for bit, unmasked and, on a
    scene with partition groups, masked (the scene's masks and random
    ones, held to the masked twin: a bf16 hit may lie outside a group's
    float32 box, which the mask leaves out)."""
    from hyper_ray_tracer_tpu_torch.ops import partition
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import bf16_engages

    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, cuda)
    assert bf16_engages(st.sweep)
    s = _rays(scene, st, 160, 90, cuda, bounces)
    args = (st.sweep, s.o.contiguous(), s.d.contiguous(),
            s.time.contiguous(), s.alive.contiguous(),
            prng.bounce_base(s.base, bounces).contiguous())
    before = counter("K1b.bf16")
    t_k, b_k = typed_sweep(*args, bf16=True)
    assert counter("K1b.bf16") == before + 1
    torch.cuda.synchronize()
    t_p, b_p = typed_sweep_plain(*args, bf16=True)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k >= 0).any()
    if st.groups:
        gen = torch.Generator(device=cuda).manual_seed(bounces)
        for mask in (partition.group_mask(st.groups, s.o, s.d,
                                          st.group_aabbs),
                     torch.randint(0, 4, (s.o.shape[0],), device=cuda,
                                   generator=gen, dtype=torch.uint8)):
            t_m, b_m, t_q, b_q = _masked(typed_sweep, typed_sweep_plain,
                                         args, mask.contiguous(), bf16=True)
            assert torch.equal(b_m, b_q) and torch.equal(t_m, t_q)


def _bf16_edge_scene(case):
    """A scene whose plan puts a bf16 tile (static spheres) at one of the
    bf16 loop's edges: an odd width (the single-sphere tail), a width of
    1 (the 513th sphere of a run: plan tiles of 512 and 1), widths above
    the kernel's 256-record stage (tiles cut by a stage), a bf16 tile
    between motion tiles of one shutter slot, beside a box and a medium
    (float32 tiles of the same launch); or
    ``tangent``: spheres that rays along +z graze (a bf16 discriminant
    of 0) or cross with roots at t = 9 and 11."""
    rng = np.random.default_rng(17)
    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))

    def spheres(k):
        for c in rng.uniform(-20, 20, (k, 3)):
            b.sphere(c, float(rng.uniform(0.2, 1.5)), mat)

    def box():
        c = rng.uniform(-20, 20, 3)
        b.cuboid(c, c + rng.uniform(0.5, 3.0, 3), mat)

    if case == "odd-width":
        spheres(37)
    elif case == "width-1":
        spheres(513)
        box()
    elif case == "stage-cut":
        box()
        spheres(701)
    elif case == "mixed-motion":  # motion tiles on both sides of bf16's
        b.moving_sphere((0, 0, 5), (0, 2, 5), 0.0, 1.0, 2.0, mat)
        spheres(1100)
        b.moving_sphere((4, 0, 5), (4, 2, 5), 0.0, 1.0, 2.0, mat)
        box()
        tex = b.solid((0.9, 0.9, 0.9))
        b.medium_sphere((0.0, 0.0, 0.0), 3.0, 0.3, tex)
    else:  # tangent
        for c, r in (((0, 0, 0), 1.0), ((3, 0, 0), 1.0), ((0, 5, 0), 2.0)):
            b.sphere(c, r, mat)
    return b.finalize(CameraConfig((0, 0, 60), (0, 0, 0), 40.0, 0.0),
                      (0.0, 0.0, 0.0), case)


def _tangent_rays(n, seed):
    """Rays from z = -10 along +z at heights that graze or cross
    _bf16_edge_scene("tangent")'s spheres."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.round(rng.uniform(-1, 4, n) * 8) / 8
    o[:, 1] = rng.choice([0.0, 1.0, 0.999, 1.001, 3.0, 7.0], n)
    o[:, 2] = -10.0
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    return o, d


@pytest.mark.parametrize("case,t_min", [
    ("odd-width", T_MIN), ("width-1", T_MIN), ("stage-cut", T_MIN),
    ("mixed-motion", T_MIN), ("final-masks", T_MIN), ("tangent", T_MIN),
    ("tangent", 9.0), ("tangent", 10.0), ("tangent", 11.0)])
def test_bf16_typed_sweep_edges(cuda, case, t_min):
    """K1b's bf16 form bit-equal to its twin at the edges of its loop: a
    bf16 tile of odd width, of width 1, cut by a stage boundary, between
    float32 motion tiles and beside box and medium ones, `final`'s plan
    (bf16 and float32 tiles) under both partition groups' masks with
    dead lanes, rays tangent to a sphere (bf16 discriminant 0), and
    t_min equal to a root (the tangent's 10, a crossing's near 9 and far
    11)."""
    from hyper_ray_tracer_tpu_torch.ops import partition
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        bf16_ray_terms,
        bf16_tile,
        dot3_bf16,
    )

    scene = build_scene("final") if case == "final-masks" \
        else _bf16_edge_scene(case)
    st = to_device(scene.arrays, scene.static, cuda)
    low = [t for t in st.sweep.plan if bf16_tile(t)]
    n = 4001
    if case == "tangent":
        o, d = (torch.from_numpy(x).to(cuda) for x in _tangent_rays(n, 5))
        active = torch.ones(n, dtype=torch.bool, device=cuda)
        time = torch.zeros(n, device=cuda)
        bits = torch.zeros(n, dtype=torch.int64, device=cuda)
    else:
        s = _rays(scene, st, 160, 90, cuda, 1 if case == "final-masks"
                  else 0)
        gen = torch.Generator(device=cuda).manual_seed(n)
        idx = torch.randperm(s.o.shape[0], device=cuda, generator=gen)[:n]
        s = type(s)(*(x[idx] for x in s))
        active = s.alive & (torch.rand(n, device=cuda, generator=gen) < 0.8)
        o, d, time = s.o.contiguous(), s.d.contiguous(), s.time
        bits = prng.bounce_base(s.base, 1)
    args = (st.sweep, o, d, time.contiguous(), active.contiguous(),
            bits.contiguous(), t_min)
    t_k, b_k = typed_sweep(*args, bf16=True)
    torch.cuda.synchronize()
    t_p, b_p = typed_sweep_plain(*args, bf16=True)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    widths = [t.width for t in low]
    if case == "odd-width":
        assert widths == [37]
    elif case == "width-1":
        assert widths == [512, 1]
    elif case == "stage-cut":
        assert widths == [512, 189]
    elif case == "mixed-motion":
        assert [(t.width, t.motion) for t in st.sweep.plan[:3]] == [
            (512, True), (512, False), (78, True)] and widths == [512]
    elif case == "final-masks":
        assert low and len(low) < len(st.sweep.plan)
    else:  # a tangent lane's bf16 discriminant is 0, and it hits there
        c16 = st.sweep.geo16[0]
        d16, a16, _ = bf16_ray_terms(d)
        oc = (o - c16[:3]).to(torch.bfloat16)
        hb = dot3_bf16(oc, d16)
        disc = hb * hb - a16 * (dot3_bf16(oc, oc)
                                - c16[3].to(torch.bfloat16))
        assert ((disc == 0) & (b_k == 0)).any() or t_min > 10.0
        assert ((t_k == t_min) & (b_k >= 0)).any() or t_min < 1.0
    if case == "final-masks":
        gen = torch.Generator(device=cuda).manual_seed(1)
        for mask in (partition.group_mask(st.groups, o, d, st.group_aabbs),
                     torch.randint(0, 4, (n,), device=cuda, generator=gen,
                                   dtype=torch.uint8)):
            t_m, b_m, t_q, b_q = _masked(typed_sweep, typed_sweep_plain,
                                         args, mask.contiguous(), bf16=True)
            assert torch.equal(b_m, b_q) and torch.equal(t_m, t_q)
            assert (b_m[~active] == -1).all()
    assert (b_k >= 0).any()


def test_bf16_sqrt_equals_plain_on_every_bf16(cuda):
    """The bf16 form's roots take MUFU's approximate square root
    (``csrc/typed_sweep.cu`` sqrt_of_bf16): rounded to bf16 it equals the
    correctly rounded root's on every non-negative bf16 value, +0 to
    +inf, and a negative value's root is 0, as the twin's clamp makes
    it."""
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        bf16_sqrt,
        bf16_sqrt_plain,
    )

    words = np.arange(1 << 16, dtype=np.uint32) << 16
    x = torch.from_numpy(words.view(np.float32))
    keep = ~torch.isnan(x) & (x != 0)
    keep[0] = True  # +0
    x = x[keep]
    got = bf16_sqrt(x.to(cuda)).cpu()
    assert torch.equal(got, bf16_sqrt_plain(x))
    assert int((x >= 0).sum()) == 32641 and (got[x < 0] == 0).all()


def test_bf16_render_goes_through_the_bf16_form(cuda):
    """A sphere-only scene with bf16_hits traces through K1b's bf16 form,
    not K1, and its image stays within tests/test_bf16.py's bound of the
    card's float32 image."""
    scene = build_scene("three-spheres")
    s = dict(width=48, height=27, samples=8, depth=5)
    img32 = render_image(scene, RenderSettings(**s), cuda)
    k1, k1b = counter("K1.launches"), counter("K1b.bf16")
    img16 = render_image(scene, RenderSettings(**s, bf16_hits=True), cuda)
    assert counter("K1.launches") == k1 and counter("K1b.bf16") > k1b
    assert np.abs(img16 - img32).mean() < 0.01


def test_camera_rays_on_card_equal_cpu(cuda):
    """F6: the card's camera rays equal the CPU's bit for bit.  torch's
    CUDA division by a Python number multiplies by its float32
    reciprocal, an ulp off the quotient the CPU computes; so parted
    `sphereflake-small`'s lanes (348, 0), (808, 1), (859, 1) and (1622, 1)
    (their x + jitter below), and so ``init_state`` divides by a tensor
    on the card (``ops/math.div_rn``)."""
    from hyper_ray_tracer_tpu_torch.ops.math import div_rn

    x = torch.tensor([28.065364837646484, 40.71052551269531,
                      27.839258193969727, 22.632497787475586])
    want = x / 63.0
    assert not torch.equal((x.to(cuda) / 63.0).cpu(), want)
    assert torch.equal(div_rn(x.to(cuda), 63.0).cpu(), want)
    scene = build_scene("sphereflake-small")
    W, H, spp = 64, 36, 2
    basis = make_basis(scene.camera, W, H)
    pix, sam = (t.reshape(-1) for t in pixel_lanes(W, H, spp, cuda))
    card = init_state(basis, W, H, pix, sam, 0)
    cpu = init_state(basis, W, H, pix.cpu(), sam.cpu(), 0)
    for name, a, b in zip(card._fields, card, cpu):
        assert torch.equal(a.cpu(), b), name
