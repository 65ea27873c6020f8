"""The port's plain sphere sweep against the JAX package's XLA sweep
(``make_scan_intersector``) and its Pallas kernel in interpret mode, with
the rules of tests/test_pallas_sweep.py: winner agreement > 0.999, a
flipped winner only on a near-tie (rtol 1e-3), matched t to rtol 5e-4 /
atol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene  # noqa: E402
from hyper_ray_tracer_tpu.camera import get_rays, make_basis  # noqa: E402
from hyper_ray_tracer_tpu.ops import rng as prng  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import make_scan_intersector  # noqa: E402
from hyper_ray_tracer_tpu.ops.pallas_sweep import make_pallas_sphere_sweep  # noqa: E402
from hyper_ray_tracer_tpu.render import T_MIN  # noqa: E402
from hyper_ray_tracer_tpu_torch import build_scene as p_build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis as p_make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import sphere_sweep as sweep_mod  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (  # noqa: E402
    PLAIN_TILE,
    sphere_sweep,
    sphere_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    bounce_step,
    init_state,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _camera_rays(scene, W=64, H=36, active_frac=1.0, seed=3):
    N = W * H
    basis = make_basis(scene.camera, W, H)
    pix = jnp.arange(N, dtype=jnp.uint32)
    base = prng.ray_base(jnp.uint32(seed), pix, jnp.zeros(N, jnp.uint32))
    x = (pix % W).astype(jnp.float32)
    y = (pix // W).astype(jnp.float32)
    o, d, tm = get_rays(basis, base, x / (W - 1), y / (H - 1), jnp)
    bits = prng.bounce_base(base, jnp.uint32(0))
    active = np.random.default_rng(seed).random(N) < active_frac
    return (np.asarray(o), np.asarray(d), np.asarray(tm), np.asarray(bits),
            active)


def _spheres(scene):
    g, P = scene.arrays.geom, scene.static.n_prims
    return (g.p0[:P], g.p1[:P], g.time0[:P], g.time1[:P], g.radius[:P])


def _port(scene, o, d, tm, active):
    t, best = sphere_sweep_plain(*(_t(x) for x in _spheres(scene)), _t(o),
                                 _t(d), _t(tm), _t(active), float(T_MIN))
    assert t.dtype == torch.float32 and best.dtype == torch.int32
    return t.numpy(), best.numpy()


def _assert_sweeps_agree(t_a, best_a, t_b, best_b):
    match = best_a == best_b
    assert match.mean() > 0.999, f"winner agreement {match.mean():.5f}"
    flip = ~match & (best_a >= 0) & (best_b >= 0)
    if flip.any():
        np.testing.assert_allclose(t_a[flip], t_b[flip], rtol=1e-3)
    hit = match & (best_b >= 0)
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=5e-4, atol=1e-3)


@pytest.mark.parametrize("name", ["random", "two-spheres", "three-spheres"])
def test_plain_matches_xla_sweep(name):
    scene = build_scene(name)
    o, d, tm, bits, active = _camera_rays(scene, active_frac=0.9)
    scan = make_scan_intersector(scene.static, scene.arrays.geom)
    t_ref, best_ref = scan(jax.device_put(scene.arrays.geom), o, d, tm,
                           T_MIN, bits, jnp.asarray(active))
    t_ref, best_ref = np.asarray(t_ref), np.asarray(best_ref)
    t, best = _port(scene, o, d, tm, active)
    _assert_sweeps_agree(t, best, t_ref, best_ref)
    assert (best_ref >= 0).mean() > 0.2  # the batch has real hits


@pytest.mark.parametrize("name", ["random", "two-spheres", "three-spheres"])
def test_plain_matches_pallas_interpret(name):
    scene = build_scene(name)
    o, d, tm, _, active = _camera_rays(scene, W=48, H=27)
    sweep = make_pallas_sphere_sweep(scene.static.n_prims, float(T_MIN),
                                     interpret=True)
    t_pl, best_pl = sweep(*(jnp.asarray(x) for x in _spheres(scene)),
                          jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                          jnp.asarray(active))
    t, best = _port(scene, o, d, tm, active)
    _assert_sweeps_agree(t, best, np.asarray(t_pl), np.asarray(best_pl))


def test_inactive_rays_miss():
    scene = build_scene("random")
    o, d, tm, _, _ = _camera_rays(scene, W=16, H=9)
    active = np.zeros(o.shape[0], bool)
    active[::3] = True
    t, best = _port(scene, o, d, tm, active)
    assert (best[~active] == -1).all()
    assert (t[~active] == np.float32(3.0e38)).all()
    assert (best[active] >= 0).any()


def test_ragged_shapes_and_tile_boundary_ties():
    """N and P that are no multiple of any tile; duplicate spheres on both
    sides of a plain-tile boundary tie exactly and go to the lower index."""
    rng = np.random.default_rng(7)
    P = PLAIN_TILE + 5
    p0 = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    # Exact duplicates, across a tile boundary and inside a tile, placed
    # between the ray origin (z = 30) and every other sphere.
    p0[PLAIN_TILE - 1] = p0[PLAIN_TILE + 2] = (0.0, 0.0, 20.0)
    p0[3] = p0[4] = (3.0, 3.0, 20.0)
    r = rng.uniform(0.3, 1.0, P).astype(np.float32)
    r[PLAIN_TILE + 2] = r[PLAIN_TILE - 1]
    r[3] = r[4]
    time0 = np.zeros(P, np.float32)
    time1 = np.ones(P, np.float32)
    N = 1001
    tgt = rng.integers(0, P, N)
    tgt[:40] = PLAIN_TILE - 1
    tgt[40:80] = 4
    o = np.zeros((N, 3), np.float32) + np.float32([0.0, 0.0, 30.0])
    d = (p0[tgt] - o).astype(np.float32)
    tm = rng.random(N, dtype=np.float32)
    active = np.ones(N, bool)
    t, best = sphere_sweep_plain(_t(p0), _t(p0), _t(time0), _t(time1),
                                 _t(r), _t(o), _t(d), _t(tm), _t(active))
    best = best.numpy()
    # A duplicate ties its twin exactly, so the higher index never wins.
    assert (best[:40] == PLAIN_TILE - 1).any() and (best[40:80] == 3).any()
    assert not np.isin(best, [PLAIN_TILE + 2, 4]).any()
    # Brute force over all spheres in float64: same winners except where
    # two candidates nearly tie.
    oc = o[:, None, :].astype(np.float64) - p0[None].astype(np.float64)
    dd = d.astype(np.float64)
    a = (dd * dd).sum(-1)[:, None]
    hb = (oc * dd[:, None]).sum(-1)
    c = (oc * oc).sum(-1) - r.astype(np.float64) ** 2
    disc = hb * hb - a * c
    sq = np.sqrt(np.maximum(disc, 0))
    tn, tf = (-hb - sq) / a, (-hb + sq) / a
    tt = np.where((disc >= 0) & (tn >= 1e-3), tn,
                  np.where((disc >= 0) & (tf >= 1e-3), tf, np.inf))
    ref = np.argmin(tt, axis=1)
    tmin = tt[np.arange(N), ref]
    second = np.partition(tt, 1, axis=1)[:, 1]
    clear = (second - tmin) > 1e-4 * np.abs(tmin)
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(best[clear], ref[clear])
    # float32 against float64: the half-b form loses ~1e-5 relative when
    # the origin is far from the sphere (|oc| ~ 30, r ~ 0.5).
    np.testing.assert_allclose(t.numpy()[clear], tmin[clear], rtol=1e-4)


@pytest.mark.parametrize("name", ["random", "two-spheres", "three-spheres"])
def test_sequential_fold_equals_tiled_fold(name, monkeypatch):
    """The CUDA kernel walks the spheres one at a time with its running best
    as the inclusive bound; the TPU kernel and the plain version fold
    128-sphere tiles against a stale bound.  A plain tile of one sphere is
    the kernel's loop, so the two folds must pick the same winner at the
    same t, on camera rays and on secondary rays that start on a surface."""
    scene = p_build_scene(name)
    st = to_device(scene.arrays, scene.static, "cpu")
    W, H = 24, 14
    pix = torch.arange(W * H, dtype=torch.int64)
    cam = init_state(p_make_basis(scene.camera, W, H), W, H, pix,
                     torch.zeros_like(pix), 11)
    sec = bounce_step(st, scene.background, cam, 0)
    for rays in (cam, sec):
        args = (*st.spheres, rays.o, rays.d, rays.time, rays.alive,
                float(T_MIN))
        t_tiled, b_tiled = sphere_sweep_plain(*args)
        with monkeypatch.context() as mp:
            mp.setattr(sweep_mod, "PLAIN_TILE", 1)
            t_seq, b_seq = sphere_sweep_plain(*args)
        assert torch.equal(b_seq, b_tiled)
        assert torch.equal(t_seq, t_tiled)
        assert (b_tiled >= 0).any()


def test_wrapper_takes_plain_version_on_cpu():
    scene = build_scene("three-spheres")
    o, d, tm, _, active = _camera_rays(scene, W=16, H=9)
    args = [_t(x) for x in (*_spheres(scene), o, d, tm, active)]
    before = counter("K1.launches")
    t1, b1 = sphere_sweep(*args)
    t2, b2 = sphere_sweep_plain(*args)
    assert counter("K1.launches") == before  # no kernel launched on CPU
    assert torch.equal(t1, t2) and torch.equal(b1, b2)


def test_wrapper_refuses_other_devices():
    args = [torch.zeros(s, device="meta") for s in
            ((2, 3), (2, 3), (2,), (2,), (2,), (4, 3), (4, 3), (4,))]
    args.append(torch.zeros(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sphere_sweep(*args)
