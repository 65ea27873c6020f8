"""The port's Perlin noise, marble and noise texture against the JAX
package's.

The integer hashing is bit-exact.  The float steps are single IEEE
operations in the JAX package's order (the gradient's square root
correctly rounded), so ``turbulence_xyz`` equals the JAX function
evaluated with NumPy bit for bit.  Only ``sin`` differs by ulps between
torch and NumPy, so the marble value is held to 1e-6.

The CUDA kernel of the noise branch reads each scene's Perlin tables
where the plain version computes the hashes per lane; the two are one
function because every table entry equals its hash bit for bit, which
the tests here establish for every scene with a noise texture.

``tools/prof_tex.py::make_pallas_turb`` (the TPU kernel the port's K2
replaces) is not run here: it bakes the bench shape in at import.  Its
body is ``turbulence_xyz`` plus the marble formula, which is what these
tests hold the port to."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene as j_build_scene  # noqa: E402
from hyper_ray_tracer_tpu.ops import perlin as jp  # noqa: E402
from hyper_ray_tracer_tpu.ops.textures import (  # noqa: E402
    texture_value as j_texture_value,
)
from hyper_ray_tracer_tpu_torch import SCENES, build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models import builders  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import (  # noqa: E402
    TT_NOISE,
    SceneBuilder,
)
from hyper_ray_tracer_tpu_torch.ops import perlin as tp  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import rng as prng  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.intersect import (  # noqa: E402
    gather_prim_shade_packed,
    hit_detail,
)
from hyper_ray_tracer_tpu_torch.ops.turbulence import (  # noqa: E402
    marble_plain,
    noise_texture,
    noise_texture_plain,
)
from hyper_ray_tracer_tpu_torch.render import init_state, trace  # noqa: E402
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402

NOISE_SCENES = ["final", "simple-light", "two-perlin-spheres"]

SEEDS = [0, 7, 2**32 - 1]


def _points(seed, n=4000):
    """Seeded points, negative ones and |p| up to 1e3 among them."""
    rng = np.random.default_rng(seed)
    scale = rng.choice([0.5, 10.0, 100.0, 1000.0], size=(n, 1))
    p = (rng.uniform(-1.0, 1.0, (n, 3)) * scale).astype(np.float32)
    p[:4] = [[0.0, 0.0, 0.0], [-1.0, -1.0, -1.0], [255.5, -256.5, 1e3],
             [-1e3, 1e3, -0.25]]
    return p


def _xyz(p):
    return tuple(torch.from_numpy(np.ascontiguousarray(p[:, i]))
                 for i in range(3))


@pytest.mark.parametrize("seed", SEEDS)
def test_tables_equal_jax_package(seed):
    got, ref = tp.make_tables(seed), jp.make_tables(seed)
    for a, b in zip(got.keys, ref.keys):
        assert a.dtype == b.dtype and a.shape == b.shape and a == b
    for f in ("vectors", "perm_x", "perm_y", "perm_z"):
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("seed", SEEDS)
def test_perm8_and_grad_bit_exact_on_all_hashes(seed):
    keys = jp.make_keys(seed)
    kx1, kx2, ky1, ky2, kz1, kz2, gseed = tp.key_ints(keys)
    idx = np.arange(256, dtype=np.uint32)
    h = torch.arange(256, dtype=torch.int64)
    for k1, k2 in ((kx1, kx2), (ky1, ky2), (kz1, kz2)):
        np.testing.assert_array_equal(
            tp._perm8(h, k1, k2).numpy(),
            jp._perm8(idx, np.uint32(k1), np.uint32(k2)))
    for got, ref in zip(tp._grad_xyz(h, gseed),
                        jp._grad_xyz(idx, keys.gseed, np)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_mix32_bit_exact():
    w = np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint64)
    w = w.astype(np.uint32)
    w[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    got = tp._mix32(torch.from_numpy(w.astype(np.int64))).numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), jp._mix32(w))


@pytest.mark.parametrize("seed", [0, 7])
def test_turbulence_matches_jax(seed):
    p = _points(seed)
    keys = jp.make_keys(seed)
    got = tp.turbulence_xyz(tp.key_ints(keys), *_xyz(p)).numpy()
    ref_np = jp.turbulence_xyz(keys, p[:, 0], p[:, 1], p[:, 2], np)
    np.testing.assert_array_equal(got, ref_np)  # the same IEEE steps
    ref_xla = np.asarray(jp.turbulence_xyz(
        keys, *(jnp.asarray(p[:, i]) for i in range(3)), jnp))
    np.testing.assert_allclose(got, ref_xla, rtol=0, atol=1e-6)
    assert got.min() >= 0 and got.max() > 0.3


def test_table_noise_equals_computed_noise():
    p = _points(1)
    tables = jp.make_tables(0)
    table_form = tp.noise(tables, torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(table_form, jp.noise(tables, p, np))
    computed = tp._noise_xyz(tp.key_ints(tables.keys), *_xyz(p)).numpy()
    np.testing.assert_array_equal(computed, table_form)


def test_marble_plain_matches_jax_formula():
    p = _points(2)
    keys = jp.make_keys(0)
    mask = np.random.default_rng(2).random(len(p)) < 0.3
    mask[:4] = True
    got = marble_plain(torch.from_numpy(mask), *_xyz(p),
                       tp.key_ints(keys)).numpy()
    turb = jp.turbulence_xyz(keys, p[:, 0], p[:, 1], p[:, 2], np)
    ref = 0.5 * (1.0 + np.sin(p[:, 2] + 10.0 * turb))
    # torch's and NumPy's float32 sin differ by ulps.
    np.testing.assert_allclose(got[mask], ref[mask], rtol=0, atol=1e-6)
    assert (got[~mask] == 0).all()
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_noise_scenes_are_the_scenes_with_noise_textures():
    assert NOISE_SCENES == [n for n in sorted(SCENES)
                            if build_scene(n).static.has_noise_tex]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", NOISE_SCENES)
def test_scene_tables_equal_hashes(name, seed, monkeypatch):
    """The scene's Perlin tables, built with ``seed``, hold exactly the
    plain version's hashes: the kernel's lookups and the plain version's
    per-lane hashes are the same function."""
    monkeypatch.setattr(builders, "SceneBuilder",
                        functools.partial(SceneBuilder, perlin_seed=seed))
    tables = build_scene(name).arrays.perlin
    keys = tp.key_ints(tables.keys)
    assert keys == tp.key_ints(tp.make_keys(seed))
    kx1, kx2, ky1, ky2, kz1, kz2, gseed = keys
    h = torch.arange(tp.POINT_COUNT, dtype=torch.int64)
    vectors = torch.stack(tp._grad_xyz(h, gseed), -1).numpy()
    assert tables.vectors.dtype == np.float32
    assert (tables.vectors.view(np.uint32) == vectors.view(np.uint32)).all()
    for table, k1, k2 in ((tables.perm_x, kx1, kx2),
                          (tables.perm_y, ky1, ky2),
                          (tables.perm_z, kz1, kz2)):
        np.testing.assert_array_equal(table, tp._perm8(h, k1, k2).numpy())


def _final_first_bounce(W=32, H=18, spp=2):
    """`final`'s camera rays traced on the CPU: the scene, its tensors,
    the winners' shade fields and hit detail."""
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, "cpu")
    pix = torch.arange(W * H).repeat(spp)
    smp = torch.arange(spp).repeat_interleave(W * H)
    s = init_state(make_basis(scene.camera, W, H), W, H, pix, smp, 0)
    t_hit, prim = trace(st, s, prng.bounce_base(s.base, 0))
    pf, sf = gather_prim_shade_packed(st.fpack, st.ipack,
                                      torch.clamp(prim, min=0).long(),
                                      scene.static)
    det = hit_detail(pf, s.o, s.d, s.time,
                     torch.where(prim >= 0, t_hit, 1.0), scene.static)
    return scene, st, prim, sf, det


def test_noise_texture_plain_equals_table_form():
    """The plain branch (per-lane hashes) equals the branch written with
    the table-form noise (the kernel's lookups) bit for bit, on `final`'s
    first bounce."""
    scene, st, _, sf, det = _final_first_bounce()
    got = noise_texture_plain(sf.ttype, sf.scale, det.point, sf.color1,
                              st.tables)
    is_noise = sf.ttype == TT_NOISE
    assert 10 <= int(is_noise.sum()) < is_noise.numel() // 2
    sp = sf.scale[:, None] * det.point
    acc = None
    for k in range(tp.TURBULENCE_DEPTH):
        term = float(0.5 ** k) * tp.noise(scene.arrays.perlin,
                                          sp * float(2.0 ** k))
        acc = term if acc is None else acc + term
    marble = 0.5 * (1.0 + torch.sin(sp[:, 2] + 10.0 * torch.abs(acc)))
    ref = torch.where(is_noise[:, None], marble[:, None].expand(-1, 3),
                      sf.color1)
    assert torch.equal(got, ref)


def test_noise_texture_plain_matches_jax_texture_value():
    """On `final`'s first bounce the plain branch equals the JAX package's
    texture_value on the noise lanes (to the marble's 1e-6) and passes
    the incoming value through everywhere else."""
    scene, st, prim, sf, det = _final_first_bounce()
    got = noise_texture_plain(sf.ttype, sf.scale, det.point, sf.color1,
                              st.tables).numpy()
    jscene = j_build_scene("final")
    a = jscene.arrays
    pidx = torch.clamp(prim, min=0).numpy()
    tex_idx = a.materials.texture[a.geom.material[pidx]]
    ref = j_texture_value(a.textures, a.images, a.image_wh, a.perlin,
                          tex_idx, det.u.numpy(), det.v.numpy(),
                          det.point.numpy(), jscene.static, np)
    is_noise = (sf.ttype == TT_NOISE).numpy()
    np.testing.assert_allclose(got[is_noise], ref[is_noise], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[~is_noise], sf.color1.numpy()[~is_noise])


def _strided_inputs(n=300):
    """Noise-branch inputs laid out as the row gather gives them: the
    texture type a column of [n, 7] int rows, the scale and value columns
    of [n, 9] float rows."""
    rng = np.random.default_rng(4)
    ints = torch.from_numpy(rng.integers(0, 4, (n, 7)).astype(np.int32))
    floats = torch.from_numpy(rng.uniform(0.1, 4.0, (n, 9))
                              .astype(np.float32))
    point = torch.from_numpy(_points(4, n))
    tables = to_device(j_build_scene("two-perlin-spheres").arrays,
                       build_scene("two-perlin-spheres").static,
                       "cpu").tables
    return ints[:, 5], floats[:, 2], point, floats[:, 4:7], tables


def test_marble_wrapper_takes_plain_version_on_cpu():
    ttype, scale, point, value, tables = _strided_inputs()
    assert ttype.stride(0) == 7 and value.stride(0) == 9
    assert (ttype == TT_NOISE).any() and (ttype != TT_NOISE).any()
    before = counter("K2.launches")
    a = noise_texture(ttype, scale, point, value, tables)
    assert counter("K2.launches") == before  # no kernel launched on CPU
    assert torch.equal(a, noise_texture_plain(ttype, scale, point, value,
                                              tables))


def test_marble_wrapper_refuses_other_devices():
    ttype, scale, point, value, tables = (
        x.to("meta") if isinstance(x, torch.Tensor) else x
        for x in _strided_inputs(4))
    with pytest.raises(ValueError, match="unsupported device"):
        noise_texture(ttype, scale, point, value, tables)
