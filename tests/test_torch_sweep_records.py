"""The sweep kernels' packed records (``sphere_records``,
``typed_records``), their cache, the kernel build's header hashing, and
the plain sweeps on a scene with two shutter intervals against the JAX
package's XLA sweep and its Pallas kernel in interpret mode.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what is checked here is what they read: the records must hold exactly the
values the plain version computes, so that the kernel's arithmetic on them
is the plain version's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu.camera import get_rays, make_basis  # noqa: E402
from hyper_ray_tracer_tpu.models import scene as j_scene  # noqa: E402
from hyper_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import make_scan_intersector  # noqa: E402
from hyper_ray_tracer_tpu.ops.pallas_sweep import make_pallas_sphere_sweep  # noqa: E402
from hyper_ray_tracer_tpu.render import T_MIN  # noqa: E402
from hyper_ray_tracer_tpu_torch import build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.models import scene as p_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import (  # noqa: E402
    PT_BOX,
    PT_MEDIUM_BOX,
    PT_RECT,
    PT_SPHERE,
)
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (  # noqa: E402
    device_sphere_records,
    sphere_records,
    sphere_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (  # noqa: E402
    PLAN_COLUMNS,
    typed_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402
from hyper_ray_tracer_tpu_torch.utils import cuda_build  # noqa: E402


def _slots(aux):
    return np.ascontiguousarray(np.asarray(aux)[:, 3]).view(np.int32)


def _two_shutter_scene(mod):
    """A ground and 120 small spheres: a third moving over [0, 1], a third
    over [0.25, 0.75], a third static, interleaved; built with ``mod``'s
    SceneBuilder (the JAX package's or the port's: the same arrays)."""
    rng = np.random.default_rng(5)
    b = mod.SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    for i, c in enumerate(rng.uniform(-4, 4, (120, 3))):
        c[1] = abs(c[1]) * 0.3
        if i % 3 == 0:
            b.moving_sphere(c, c + (0.0, 0.5, 0.0), 0.0, 1.0, 0.3, mat)
        elif i % 3 == 1:
            b.moving_sphere(c, c + (0.3, 0.0, 0.2), 0.25, 0.75, 0.3, mat)
        else:
            b.sphere(c, 0.3, mat)
    return b.finalize(mod.CameraConfig((13, 2, 3), (0, 0, 0), 20.0, 0.0),
                      (0.7, 0.8, 1.0), "two-shutters")


def _agree(t_a, best_a, t_b, best_b):
    """tests/test_pallas_sweep.py's rules."""
    match = best_a == best_b
    assert match.mean() > 0.999, f"winner agreement {match.mean():.5f}"
    flip = ~match & (best_a >= 0) & (best_b >= 0)
    if flip.any():
        np.testing.assert_allclose(t_a[flip], t_b[flip], rtol=1e-3)
    hit = match & (best_b >= 0)
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=5e-4, atol=1e-3)


def test_two_shutter_plain_sweeps_match_jax():
    """Both plain sweeps on a scene whose moving spheres use two shutter
    intervals, against the XLA sweep and the Pallas kernel (interpret
    mode), at 32x18 camera rays with shutter times over [0, 1]."""
    j = _two_shutter_scene(j_scene)
    p = _two_shutter_scene(p_scene)
    for a, b in zip(jax.tree_util.tree_leaves(j.arrays.geom),
                    jax.tree_util.tree_leaves(p.arrays.geom)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    W, H = 32, 18
    n = W * H
    pix = jnp.arange(n, dtype=jnp.uint32)
    base = jrng.ray_base(jnp.uint32(4), pix, jnp.zeros(n, jnp.uint32))
    o, d, tm = get_rays(make_basis(j.camera, W, H), base,
                        (pix % W).astype(jnp.float32) / (W - 1),
                        (pix // W).astype(jnp.float32) / (H - 1), jnp)
    o, d, tm = (np.asarray(x) for x in (o, d, tm))
    bits = np.asarray(jrng.bounce_base(base, jnp.uint32(0)))
    active = np.random.default_rng(1).random(n) < 0.9
    P = j.static.n_prims
    g = j.arrays.geom
    spheres = (g.p0[:P], g.p1[:P], g.time0[:P], g.time1[:P], g.radius[:P])
    t_ref, b_ref = (np.asarray(x) for x in make_scan_intersector(
        j.static, g)(g, o, d, tm, T_MIN, bits, jnp.asarray(active)))
    t_pl, b_pl = (np.asarray(x) for x in make_pallas_sphere_sweep(
        P, float(T_MIN), interpret=True)(
            *(jnp.asarray(x) for x in spheres), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(tm), jnp.asarray(active)))
    st = to_device(p.arrays, p.static, "cpu")
    assert st.sweep.shutter.shape[0] == 2
    rays = [torch.from_numpy(np.array(x)) for x in (o, d, tm, active)]
    t1, b1 = sphere_sweep_plain(*st.spheres, *rays, float(T_MIN))
    t2, b2 = typed_sweep_plain(st.sweep, *rays,
                               torch.from_numpy(bits.astype(np.int64)),
                               float(T_MIN))
    for t, best in ((t1, b1), (t2, b2)):
        _agree(t.numpy(), best.numpy(), t_ref, b_ref)
        _agree(t.numpy(), best.numpy(), t_pl, b_pl)
    won = b_ref[b_ref >= 0]
    assert {0.0, 0.25} <= set(np.asarray(g.time0)[won].tolist())


def test_sphere_records_hold_the_plain_values():
    rng = np.random.default_rng(3)
    P = 12
    p0 = rng.normal(size=(P, 3)).astype(np.float32)
    p1 = p0.copy()
    p1[[1, 4, 7]] += np.float32(0.37)
    time0 = np.zeros(P, np.float32)
    time1 = np.ones(P, np.float32)
    time0[[4, 9]], time1[[4, 9]] = 0.25, 0.75  # 9: static, odd shutter
    radius = rng.uniform(0.1, 3.0, P).astype(np.float32)
    rec = sphere_records(p0, p1, time0, time1, radius)
    assert rec.has_motion
    t = [torch.from_numpy(x) for x in (p0, p1, time0, time1, radius)]
    # The plain version's own operations, bit for bit.
    assert torch.equal(torch.from_numpy(rec.geo[:, 3]), t[4] * t[4])
    assert torch.equal(torch.from_numpy(rec.aux[:, :3]), t[1] - t[0])
    np.testing.assert_array_equal(rec.geo[:, :3], p0)
    slots = _slots(rec.aux)
    # Spheres that cannot move keep -1; every other names its interval.
    assert (slots[[0, 2, 3, 5, 6, 8, 10, 11]] == -1).all()
    assert (slots[[1, 4, 7, 9]] >= 0).all()
    table = rec.shutter[slots[[1, 4, 7, 9]]]
    np.testing.assert_array_equal(
        table, [[0, 1], [0.25, 0.5], [0, 1], [0.25, 0.5]])
    # Only the spheres the caller lerps get a slot.
    lerp = np.zeros(P, bool)
    lerp[[4]] = True
    only = sphere_records(p0, p1, time0, time1, radius, lerp)
    assert _slots(only.aux).tolist() == [-1] * 4 + [0] + [-1] * 7
    # No sphere moves: one (0, 1) row, no motion.
    still = sphere_records(p0, p0, np.zeros(P), np.ones(P), radius)
    assert not still.has_motion and still.shutter.tolist() == [[0.0, 1.0]]


def test_device_records_are_cached_per_sphere_set():
    scene = build_scene("random")
    sph = to_device(scene.arrays, scene.static, "cpu").spheres
    first = device_sphere_records(*sph)
    assert device_sphere_records(*sph) is first
    assert first.has_motion and first.shutter.tolist() == [[0.0, 1.0]]
    moving = (sph.p1 != sph.p0).any(1)
    assert torch.equal(torch.from_numpy(_slots(first.aux) >= 0), moving)
    sph.radius[0] = 2.5  # an in-place edit bumps the version: repacked
    again = device_sphere_records(*sph)
    assert again is not first and again.geo[0, 3] == 6.25
    copy = sph._replace(p1=sph.p1.clone())  # another tensor: repacked
    assert device_sphere_records(*copy) is not again


@pytest.mark.parametrize("name", ["final", "cornell-smoke"])
def test_typed_records_layout(name):
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, "cpu")
    sw, pf = st.sweep, st.sweep.prims
    rows = sw.plan_rows.numpy()
    assert rows.shape == (len(sw.plan), len(PLAN_COLUMNS))
    geo, aux = sw.geo.numpy(), sw.aux.numpy()
    p0, p1 = pf.p0.numpy(), pf.p1.numpy()
    slots = _slots(aux)
    for t, row in zip(sw.plan, rows):
        sl = slice(t.start, t.start + t.width)
        assert row[:6].tolist() == [t.start, t.width, t.ptype, t.motion,
                                    t.xform, t.rect_axis]
        if t.ptype == PT_SPHERE:
            np.testing.assert_array_equal(geo[sl, :3], p0[sl])
            moving = (p1[sl] != p0[sl]).any(1)
            assert ((slots[sl] >= 0) == (moving & t.motion)).all()
        elif t.ptype == PT_RECT:
            np.testing.assert_array_equal(geo[sl, :3], p0[sl])
            np.testing.assert_array_equal(geo[sl, 3], p1[sl, 0])
            np.testing.assert_array_equal(aux[sl, 0], p1[sl, 1])
        elif t.ptype in (PT_BOX, PT_MEDIUM_BOX):
            np.testing.assert_array_equal(geo[sl, :3], p0[sl])
            np.testing.assert_array_equal(aux[sl, :3], p1[sl])
        if t.ptype == PT_MEDIUM_BOX:
            np.testing.assert_array_equal(
                geo[sl, 3], pf.neg_inv_density.numpy()[sl])
            assert (_slots(aux)[sl] == pf.stable_id.numpy()[sl]).all()
        if t.xform:
            xf = sw.xf.numpy()[row[6]:row[6] + t.width]
            np.testing.assert_array_equal(
                xf, np.concatenate([pf.rot.numpy()[sl].reshape(-1, 9),
                                    pf.trans.numpy()[sl]], 1))


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int c;\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert [p.name for p in cuda_build.sources("k")] == ["k.cu", "a.cuh",
                                                         "b.cuh"]
    seen = {cuda_build.library_path("k")}
    (tmp_path / "other.cuh").write_text("int c2;\n")  # not included
    assert cuda_build.library_path("k") in seen
    for name, text in (("b.cuh", "int b2;\n"), ("a.cuh", '#include "b.cuh"'
                                                  '\nint a2;\n'),
                       ("k.cu", '#include "a.cuh"\nint k2;\n')):
        (tmp_path / name).write_text(text)
        path = cuda_build.library_path("k")
        assert path not in seen, name
        seen.add(path)
    assert all(p.name.startswith("libk-") for p in seen)
