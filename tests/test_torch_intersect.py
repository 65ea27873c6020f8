"""Rect, box and medium hit distances, the baked ray transform, the full
hit detailer and shading of the port against the JAX package's functions
on the same inputs: random rays through `final`, `cornell`,
`cornell-smoke` and `simple-light` (a quarter of them axis-parallel, some
from inside boxes, as tests/test_box.py builds them), and hit batches
recorded from those scenes by the JAX sweep.

The reference side runs the JAX functions with NumPy (``xp=np``), so both
sides are plain IEEE float32 steps; they differ where the two round a
square root, a log or a sum differently, by ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene  # noqa: E402
from hyper_ray_tracer_tpu.models.scene import (  # noqa: E402
    MT_DIFFUSE_LIGHT,
    MT_ISOTROPIC,
    PT_BOX,
    PT_MEDIUM_BOX,
    PT_MEDIUM_SPHERE,
    PT_RECT,
    PT_SPHERE,
)
from hyper_ray_tracer_tpu.ops import intersect as jint  # noqa: E402
from hyper_ray_tracer_tpu.ops import materials as jmat  # noqa: E402
from hyper_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import make_scan_intersector  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import intersect as tint  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import materials as tmat  # noqa: E402
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402

T_MIN = np.float32(1e-3)
BIG = np.float32(3.0e38)
SCENES = ["final", "cornell", "cornell-smoke", "simple-light"]


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


def _bounds(scene):
    """World bounds of the scene's solid primitives, media and ground
    spheres left out (the final scene's fog spans 10,000 units, the
    simple-light ground 2,000)."""
    g, n = scene.arrays.geom, scene.static.n_prims
    lo, hi = g.aabb_min[:n], g.aabb_max[:n]
    keep = ~np.isin(g.ptype[:n], (PT_MEDIUM_SPHERE, PT_MEDIUM_BOX)) \
        & ~((g.ptype[:n] == PT_SPHERE) & (g.radius[:n] >= 1000))
    return lo[keep].min(0), hi[keep].max(0)


def _rays(scene, n, seed):
    """Random rays: origins in the scene's bounds, an eighth of them inside
    a random box primitive, a quarter axis-parallel."""
    rng = np.random.default_rng(seed)
    lo, hi = _bounds(scene)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    g, nprim = scene.arrays.geom, scene.static.n_prims
    boxes = np.flatnonzero(np.isin(g.ptype[:nprim], (PT_BOX, PT_MEDIUM_BOX)))
    if boxes.size:
        k = n // 8
        pick = rng.choice(boxes, k)
        # Object-frame points inside the box, carried to the world frame.
        inside = rng.uniform(g.p0[pick], g.p1[pick]).astype(np.float32)
        o[-k:] = (np.einsum("kij,kj->ki", g.rot[pick], inside)
                  + g.trans[pick]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = n // 4
    d[:k] = 0.0
    d[np.arange(k), rng.integers(0, 3, k)] = rng.choice([-1.0, 1.0], k)
    return o, d


def _of_type(scene, ptypes):
    g, n = scene.arrays.geom, scene.static.n_prims
    return np.flatnonzero(np.isin(g.ptype[:n], ptypes))


def _fields(scene, idx):
    """The JAX PrimFields and the port's, [1, K], for primitives idx."""
    jpf = jint.gather_prim(scene.arrays.geom, idx[None])
    tpf = tint.PrimFields(**{f: _t(getattr(jpf, f))
                             for f in tint.PrimFields._fields})
    return jpf, tpf


def _agree(got, ref, rtol=1e-5):
    """Hit/miss agrees on >= 99.9% of pairs; matched hits to rtol."""
    hit_g, hit_r = got < 0.5 * BIG, ref < 0.5 * BIG
    assert (hit_g == hit_r).mean() >= 0.999, (hit_g != hit_r).sum()
    both = hit_g & hit_r
    np.testing.assert_allclose(got[both], ref[both], rtol=rtol, atol=1e-4)
    return both.sum()


def _obj_rays(jpf, o, d):
    """Rays in each primitive's object frame ([N, K, 3]), by the JAX
    package's _xform_ray."""
    return jint._xform_ray(jpf, o[:, None, :], d[:, None, :], np)


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke"])
def test_xform_ray_matches_jax(name):
    scene = build_scene(name)
    o, d = _rays(scene, 2048, 1)
    idx = np.flatnonzero(scene.arrays.geom.rot[:scene.static.n_prims, 0, 0]
                         != 1.0)
    assert idx.size == 2  # the two rotated boxes
    jpf, tpf = _fields(scene, idx)
    ro, rd = _obj_rays(jpf, o, d)
    go, gd = tint._xform_ray(tpf, _t(o)[:, None], _t(d)[:, None])
    np.testing.assert_allclose(go.numpy(), ro, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(gd.numpy(), rd, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_rect_t_matches_jax(name):
    scene = build_scene(name)
    o, d = _rays(scene, 4096, 2)
    idx = _of_type(scene, [PT_RECT])
    jpf, tpf = _fields(scene, idx)
    t_max = np.float32(BIG)
    ref = jint.rect_t(jpf, o[:, None], d[:, None], T_MIN, t_max, np)
    got = tint.rect_t(tpf, _t(o)[:, None], _t(d)[:, None], float(T_MIN),
                      float(t_max)).numpy()
    assert _agree(got, ref) > 10  # final has one rect, the light


@pytest.mark.parametrize("name", ["final", "cornell"])
def test_box_t_matches_jax(name):
    scene = build_scene(name)
    o, d = _rays(scene, 4096, 3)
    idx = _of_type(scene, [PT_BOX])
    jpf, tpf = _fields(scene, idx)
    if scene.static.has_ray_xform:
        ro, rd = _obj_rays(jpf, o, d)
        go, gd = tint._xform_ray(tpf, _t(o)[:, None], _t(d)[:, None])
    else:
        ro, rd, go, gd = o[:, None], d[:, None], _t(o)[:, None], \
            _t(d)[:, None]
    ref = jint.box_t(jpf, ro, rd, T_MIN, BIG, np)
    got = tint.box_t(tpf, go, gd, float(T_MIN), float(BIG)).numpy()
    assert _agree(got, ref) > 100
    # Rays from inside a box leave through it: the exit face is hit.
    k = len(o) // 8
    assert (got[-k:] < 0.5 * BIG).any(-1).mean() > 0.9


@pytest.mark.parametrize("name,ptype", [("final", PT_MEDIUM_SPHERE),
                                        ("cornell-smoke", PT_MEDIUM_BOX)])
def test_medium_t_matches_jax(name, ptype):
    """Free flight through media, with per-ray random bounds (the outcome
    depends on t_max) and per-ray RNG words."""
    scene = build_scene(name)
    o, d = _rays(scene, 4096, 4)
    rng = np.random.default_rng(4)
    t_max = rng.uniform(1.0, 3000.0, (len(o), 1)).astype(np.float32)
    bits = rng.integers(0, 2**32, (len(o), 1), dtype=np.uint64)
    bits = bits.astype(np.uint32)
    idx = _of_type(scene, [ptype])
    jpf, tpf = _fields(scene, idx)
    if scene.static.has_ray_xform:
        ro, rd = _obj_rays(jpf, o, d)
        go, gd = tint._xform_ray(tpf, _t(o)[:, None], _t(d)[:, None])
    else:
        ro, rd, go, gd = o[:, None], d[:, None], _t(o)[:, None], \
            _t(d)[:, None]
    med_u = jrng.bits_to_uniform(jrng.stream_bits(
        bits, jrng.P_MEDIUM, jpf.stable_id.astype(np.uint32)))
    got_u = tint.medium_uniform(_t(bits), tpf.stable_id)
    np.testing.assert_array_equal(got_u.numpy(), med_u)
    fn_j = jint.medium_sphere_t if ptype == PT_MEDIUM_SPHERE \
        else jint.medium_box_t
    fn_t = tint.medium_sphere_t if ptype == PT_MEDIUM_SPHERE \
        else tint.medium_box_t
    ref = fn_j(jpf, ro, rd, T_MIN, t_max, med_u, np)
    got = fn_t(tpf, go, gd, float(T_MIN), _t(t_max), got_u).numpy()
    assert _agree(got, ref, rtol=1e-4) > 100


def _recorded_hits(name, seed, n_hits=4096):
    """Closest hits of random rays, traced by the JAX package's sweep."""
    scene = build_scene(name)
    static = scene.static
    o, d = _rays(scene, 4 * n_hits, seed)
    rng = np.random.default_rng(seed)
    time = rng.random(len(o), dtype=np.float32)
    bits = rng.integers(0, 2**32, len(o), dtype=np.uint64).astype(np.uint32)
    scan = make_scan_intersector(static, scene.arrays.geom)
    t, prim = jax.jit(lambda *a: scan(*a[:4], T_MIN, *a[4:]))(
        scene.arrays.geom, o, d, time, bits, np.ones(len(o), bool))
    t, prim = np.asarray(t), np.asarray(prim)
    keep = np.nonzero(prim >= 0)[0][:n_hits]
    assert keep.size == n_hits
    return scene, o[keep], d[keep], time[keep], t[keep], prim[keep], \
        bits[keep]


def _share_close(got, ref, atol):
    return (np.abs(got - ref) <= atol).reshape(len(got), -1).all(-1).mean()


@pytest.mark.parametrize("name", SCENES)
def test_hit_detail_and_shade_match_jax(name):
    scene, o, d, time, t, prim, bb = _recorded_hits(name, seed=5)
    static = scene.static
    g = scene.arrays.geom
    fpack, ipack = jint.pack_prim_shade(scene.arrays, static, np)
    jpf, _, jsf = jint.gather_prim_shade_packed(
        jnp.asarray(fpack), jnp.asarray(ipack), jnp.asarray(prim), static)
    detail = jint.make_hit_detailer(static)

    @jax.jit
    def jax_detail_shade(arrays, jpf, jsf, o, d, time, t, bb):
        det = detail(jpf, o, d, time, t, jnp)
        return det, jmat.shade(arrays, None, det, d, bb, static, jnp,
                               sf=jsf)

    jdet, jsc = jax_detail_shade(scene.arrays, jpf, jsf, o, d, time, t, bb)

    st = to_device(scene.arrays, static, "cpu")
    tpf, tsf = tint.gather_prim_shade_packed(st.fpack, st.ipack,
                                             _t(prim).long(), static)
    tdet = tint.hit_detail(tpf, _t(o), _t(d), _t(time), _t(t), static)
    tsc = tmat.shade(tsf, tdet, _t(d), _t(bb), static, st.tables)

    ptype = g.ptype[prim]
    assert set(ptype.tolist()) == set(g.ptype[:static.n_prims].tolist())
    np.testing.assert_allclose(tdet.point.numpy(), np.asarray(jdet.point),
                               rtol=1e-6, atol=1e-3)
    # uv and normal are exact up to ulps, except where the box face or
    # the rect edge is decided by a last-bit difference of the point.
    for f in ("normal", "u", "v"):
        share = _share_close(getattr(tdet, f).numpy(),
                             np.asarray(getattr(jdet, f)), 1e-4)
        assert share >= 0.999, (f, share)
    assert (tdet.front_face.numpy() == np.asarray(jdet.front_face)).mean() \
        >= 0.999
    # Media: zero normal, front_face false, whatever the sphere or box
    # branch would give.
    media = np.isin(ptype, (PT_MEDIUM_SPHERE, PT_MEDIUM_BOX))
    assert media.any() == static.has_media
    assert (tdet.normal.numpy()[media] == 0).all()
    assert not tdet.front_face.numpy()[media].any()

    for f in ("emitted", "attenuation", "direction"):
        share = _share_close(getattr(tsc, f).numpy(),
                             np.asarray(getattr(jsc, f)), 1e-4)
        assert share >= 0.999, (f, share)
    assert (tsc.did_scatter.numpy() == np.asarray(jsc.did_scatter)).mean() \
        >= 0.999
    # Diffuse lights and isotropic media are in the batch where the scene
    # has them.
    mtypes = set(tsf.mtype.numpy().tolist())
    for mt in (MT_DIFFUSE_LIGHT, MT_ISOTROPIC):
        assert (mt in mtypes) == (mt in static.mat_types)
