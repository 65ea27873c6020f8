"""Camera rays, the sphere hit detail and material shading of the port
against the JAX package's functions on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene  # noqa: E402
from hyper_ray_tracer_tpu.camera import get_rays as j_get_rays  # noqa: E402
from hyper_ray_tracer_tpu.camera import make_basis as j_make_basis  # noqa: E402
from hyper_ray_tracer_tpu.ops import intersect as jint  # noqa: E402
from hyper_ray_tracer_tpu.ops import materials as jmat  # noqa: E402
from hyper_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import make_scan_intersector  # noqa: E402
from hyper_ray_tracer_tpu_torch import camera as tcam  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import intersect as tint  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import math as tm  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import materials as tmat  # noqa: E402
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402

T_MIN = 1e-3
N_HITS = 4096


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", ["random", "three-spheres"])
def test_get_rays_matches_jax(name):
    scene = build_scene(name)
    W, H = 64, 36
    N = W * H
    rng = np.random.default_rng(0)
    base = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    s = rng.random(N, dtype=np.float32)
    t = rng.random(N, dtype=np.float32)
    jb = j_make_basis(scene.camera, W, H)
    tb = tcam.make_basis(scene.camera, W, H)
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    ro, rd, rt = j_get_rays(jb, jnp.asarray(base), jnp.asarray(s),
                            jnp.asarray(t), jnp)
    go, gd, gt = tcam.get_rays(tb, _t(base), _t(s), _t(t))
    np.testing.assert_allclose(go.numpy(), np.asarray(ro), rtol=1e-5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), rtol=1e-5)


def test_cbrt_substitute_within_ulps():
    """torch has no cbrt; u ** (1/3) stays within a few float32 ulps."""
    u = np.random.default_rng(1).random(100_000, dtype=np.float32)
    zero = np.zeros_like(u)
    # u1 = 0 gives the direction (0, 0, 1), so z is the radius itself.
    got = tm.in_unit_sphere_from_uniforms(_t(zero), _t(zero),
                                          _t(u))[..., 2].numpy()
    np.testing.assert_allclose(got, np.cbrt(u.astype(np.float64)),
                               rtol=5e-7)
    np.testing.assert_allclose(got, np.asarray(jnp.cbrt(u)), rtol=5e-7)


def _recorded_hits(name, seed):
    """4,096 closest hits of random rays, traced by the JAX sweep.

    Origins fill a box around the scene's spheres, so the batch holds hits
    from inside (hollow shell, glass interior) as well as from outside."""
    scene = build_scene(name)
    g, static = scene.arrays.geom, scene.static
    n = static.n_prims
    rng = np.random.default_rng(seed)
    M = 4 * N_HITS
    small = np.abs(g.radius[:n]) < 50  # leave out the ground spheres
    lo = (g.p0[:n][small] - 1.5).min(0)
    hi = (g.p0[:n][small] + 1.5).max(0)
    o = (lo + (hi - lo) * rng.random((M, 3))).astype(np.float32)
    d = rng.normal(size=(M, 3)).astype(np.float32)
    time = rng.random(M, dtype=np.float32)
    bits = np.zeros(M, np.uint32)
    scan = make_scan_intersector(static, g)
    t, prim = scan(g, jnp.asarray(o), jnp.asarray(d), jnp.asarray(time),
                   np.float32(T_MIN), jnp.asarray(bits),
                   jnp.ones(M, bool))
    t, prim = np.asarray(t), np.asarray(prim)
    keep = np.nonzero(prim >= 0)[0][:N_HITS]
    assert keep.size == N_HITS
    bb = rng.integers(0, 2**32, N_HITS, dtype=np.uint64).astype(np.uint32)
    return scene, o[keep], d[keep], time[keep], t[keep], prim[keep], bb


@pytest.mark.parametrize("name", ["random", "three-spheres"])
def test_hit_detail_and_shade_match_jax(name):
    scene, o, d, time, t, prim, bb = _recorded_hits(name, seed=5)
    static = scene.static

    # JAX package: packed row gather, hit detail, shade.
    fpack, ipack = jint.pack_prim_shade(scene.arrays, static, np)
    jpf, _, jsf = jint.gather_prim_shade_packed(
        jnp.asarray(fpack), jnp.asarray(ipack), jnp.asarray(prim), static)
    jdet = jint.make_hit_detailer(static)(
        jpf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(time),
        jnp.asarray(t), jnp)
    jsc = jmat.shade(scene.arrays, None, jdet, jnp.asarray(d),
                     jnp.asarray(bb), static, jnp, sf=jsf)

    # Port: the same inputs.
    st = to_device(scene.arrays, static, "cpu")
    tpf, tsf = tint.gather_prim_shade_packed(
        st.fpack, st.ipack, _t(prim).long(), static)
    tdet = tint.hit_detail(tpf, _t(o), _t(d), _t(time), _t(t), static)
    tsc = tmat.shade(tsf, tdet, _t(d), _t(bb), static, st.tables)

    for f in ("point", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(tdet, f).numpy(),
                                   np.asarray(getattr(jdet, f)), atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(tdet.front_face.numpy(),
                                  np.asarray(jdet.front_face))
    assert 0 < tdet.front_face.numpy().mean() < 1  # inside and outside hits
    for f in ("emitted", "attenuation", "direction"):
        np.testing.assert_allclose(getattr(tsc, f).numpy(),
                                   np.asarray(getattr(jsc, f)), atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(tsc.did_scatter.numpy(),
                                  np.asarray(jsc.did_scatter))
    # Every material of the scene is in the batch.
    mtypes = set(np.unique(tsf.mtype.numpy()).tolist())
    assert mtypes == set(static.mat_types)


def test_hollow_shell_normal_points_inward():
    """A negative radius keeps its sign: (p - c) / r of the inner glass
    shell of three-spheres points toward the center."""
    scene, o, d, time, t, prim, bb = _recorded_hits("three-spheres", seed=6)
    shell = scene.arrays.geom.radius[prim] < 0
    assert shell.any()
    st = to_device(scene.arrays, scene.static, "cpu")
    pf, _ = tint.gather_prim_shade_packed(st.fpack, st.ipack,
                                          _t(prim).long(), scene.static)
    det = tint.hit_detail(pf, _t(o), _t(d), _t(time), _t(t), scene.static)
    p = det.point.numpy()[shell]
    c = scene.arrays.geom.p0[prim[shell]]
    outward = np.where(det.front_face.numpy()[shell, None],
                       det.normal.numpy()[shell], -det.normal.numpy()[shell])
    assert ((outward * (p - c)).sum(-1) < 0).all()


def test_rng_words_feed_shade_exactly():
    """The shade streams see bit-identical uniforms in both packages."""
    bb = np.random.default_rng(2).integers(0, 2**32, 1000,
                                           dtype=np.uint64).astype(np.uint32)
    from hyper_ray_tracer_tpu_torch.ops import rng as trng

    for p in (jrng.P_LAMBERT_A, jrng.P_SPHERE_C, jrng.P_DIELECTRIC):
        np.testing.assert_array_equal(trng.uniform(_t(bb), p).numpy(),
                                      jrng.uniform(bb, p))
