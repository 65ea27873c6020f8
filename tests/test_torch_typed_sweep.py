"""The port's typed sweep against the JAX package's planned XLA sweep
(``make_scan_intersector(static, host_geom)``), with the rules of
tests/test_pallas_sweep.py: winner agreement > 0.999, a flipped winner
only on a near-tie (rtol 1e-3), matched t to rtol 5e-4 / atol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene  # noqa: E402
from hyper_ray_tracer_tpu.camera import make_basis as j_make_basis  # noqa: E402
from hyper_ray_tracer_tpu.models.builders import SCENES  # noqa: E402
from hyper_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import SCAN_TILE, _tile_plan  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import make_scan_intersector  # noqa: E402
from hyper_ray_tracer_tpu.render import (  # noqa: E402
    T_MIN,
    make_ray_colorer,
    prepare_scene,
)
from hyper_ray_tracer_tpu_torch.ops import typed_sweep as sweep_mod  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (  # noqa: E402
    tile_plan,
    typed_sweep,
    typed_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402

W, H = 32, 18
# scene: bounces compared.  `random` (sphere-only, traced by K1 in the
# render) is held on its camera rays: its secondary rays start on small
# spheres, where XLA and torch round a root that straddles t_min
# differently (PERF.md, the K1 findings), and such a flip is no near-tie.
SWEEP_CASES = {"final": 2, "cornell": 2, "cornell-smoke": 2,
               "simple-light": 2, "random": 1}


def _t(x):
    x = np.array(x)  # a writable copy
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plan_equals_jax_tile_plan(name):
    scene = build_scene(name)
    g, n = scene.arrays.geom, scene.static.n_prims
    assert tile_plan(g, n) == _tile_plan(g, n, SCAN_TILE)


def _wavefronts(name, active_frac=1.0, bounces=2):
    """Camera rays and their first bounce at 32x18, 2 spp, from the JAX
    package's own ``init_state`` / ``bounce_step``: (o, d, time, bits,
    active) per bounce, NumPy."""
    scene = build_scene(name)
    arrays, bvh, mode = prepare_scene(scene, "sweep")
    colorer = make_ray_colorer(scene, W, H, 2, mode, differentiable=False)
    pix = jnp.asarray(np.tile(np.arange(W * H), 2), jnp.int32)
    smp = jnp.asarray(np.repeat(np.arange(2), W * H), jnp.int32)
    state = jax.jit(colorer.init_state)(j_make_basis(scene.camera, W, H),
                                        pix, smp, jnp.uint32(0))
    out = []
    for b in range(bounces):
        bits = jrng.bounce_base(state.base, jnp.uint32(b))
        active = np.asarray(state.alive) & (
            np.random.default_rng(b).random(pix.shape[0]) < active_frac)
        out.append(tuple(np.asarray(x) for x in
                         (state.o, state.d, state.time, bits)) + (active,))
        state = jax.jit(colorer.bounce_step)(arrays, bvh, state,
                                             jnp.uint32(b))
    return scene, out


def _assert_sweeps_agree(t_a, best_a, t_b, best_b):
    match = best_a == best_b
    assert match.mean() > 0.999, f"winner agreement {match.mean():.5f}"
    flip = ~match & (best_a >= 0) & (best_b >= 0)
    if flip.any():
        np.testing.assert_allclose(t_a[flip], t_b[flip], rtol=1e-3)
    hit = match & (best_b >= 0)
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=5e-4, atol=1e-3)


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_plain_matches_scan_all(name):
    scene, waves = _wavefronts(name, 0.9, SWEEP_CASES[name])
    scan = jax.jit(lambda *a: make_scan_intersector(
        scene.static, scene.arrays.geom)(*a[:4], T_MIN, *a[4:]))
    st = to_device(scene.arrays, scene.static, "cpu")
    hit_types = set()
    for o, d, time, bits, active in waves:
        t_ref, b_ref = (np.asarray(x) for x in
                        scan(scene.arrays.geom, o, d, time, bits, active))
        t, best = typed_sweep_plain(st.sweep, _t(o), _t(d), _t(time),
                                    _t(active), _t(bits), float(T_MIN))
        assert t.dtype == torch.float32 and best.dtype == torch.int32
        _assert_sweeps_agree(t.numpy(), best.numpy(), t_ref, b_ref)
        assert (b_ref >= 0).any()
        hit_types |= set(scene.arrays.geom.ptype[b_ref[b_ref >= 0]].tolist())
    n = scene.static.n_prims
    assert hit_types == set(scene.arrays.geom.ptype[:n].tolist())


def test_inactive_rays_miss():
    scene, waves = _wavefronts("cornell-smoke")
    o, d, time, bits, _ = waves[0]
    active = np.zeros(len(o), bool)
    active[::3] = True
    st = to_device(scene.arrays, scene.static, "cpu")
    t, best = typed_sweep_plain(st.sweep, _t(o), _t(d), _t(time),
                                _t(active), _t(bits))
    t, best = t.numpy(), best.numpy()
    assert (best[~active] == -1).all()
    assert (t[~active] == np.float32(3.0e38)).all()
    assert (best[active] >= 0).any()


@pytest.mark.parametrize("name", ["final", "cornell-smoke"])
def test_per_primitive_fold_equals_tiled_fold(name, monkeypatch):
    """The CUDA kernel folds one primitive at a time with the tile-start
    bound; the plain version folds PLAIN_TILE primitives at a time.  One
    primitive per step is the kernel's loop: both must pick the same
    winner at the same t, media included."""
    scene, waves = _wavefronts(name)
    st = to_device(scene.arrays, scene.static, "cpu")
    for o, d, time, bits, active in waves:
        args = (st.sweep, _t(o), _t(d), _t(time), _t(active), _t(bits))
        t_tiled, b_tiled = typed_sweep_plain(*args)
        with monkeypatch.context() as mp:
            mp.setattr(sweep_mod, "PLAIN_TILE", 1)
            t_seq, b_seq = typed_sweep_plain(*args)
        assert torch.equal(b_seq, b_tiled) and torch.equal(t_seq, t_tiled)


def test_ragged_plan_with_long_tiles():
    """A plan tile wider than PLAIN_TILE and a ragged last tile: 700
    random spheres (tiles of 512 and 188) and boxes, against scan_all."""
    from hyper_ray_tracer_tpu.models.scene import CameraConfig, SceneBuilder

    rng = np.random.default_rng(9)
    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    for c in rng.uniform(-20, 20, (700, 3)):
        b.sphere(c, float(rng.uniform(0.2, 1.5)), mat)
    for c in rng.uniform(-20, 20, (37, 3)):
        b.cuboid(c, c + rng.uniform(0.5, 3.0, 3), mat)
    scene = b.finalize(CameraConfig((0, 0, 60), (0, 0, 0), 40.0, 0.0),
                       (0.0, 0.0, 0.0), "ragged")
    plan = tile_plan(scene.arrays.geom, scene.static.n_prims)
    assert [w for _, w, *_ in plan] == [512, 188, 37]
    n = 1001
    o = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    time = rng.random(n, dtype=np.float32)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    active = np.ones(n, bool)
    scan = make_scan_intersector(scene.static, scene.arrays.geom)
    t_ref, b_ref = (np.asarray(x) for x in jax.jit(
        lambda *a: scan(*a[:4], T_MIN, *a[4:]))(
            scene.arrays.geom, o, d, time, bits, active))
    st = to_device(scene.arrays, scene.static, "cpu")
    t, best = typed_sweep_plain(st.sweep, _t(o), _t(d), _t(time),
                                _t(active), _t(bits), float(T_MIN))
    _assert_sweeps_agree(t.numpy(), best.numpy(), t_ref, b_ref)
    assert (b_ref >= 0).mean() > 0.2


def test_wrapper_takes_plain_version_on_cpu():
    scene, waves = _wavefronts("cornell")
    o, d, time, bits, active = waves[1]
    st = to_device(scene.arrays, scene.static, "cpu")
    args = (st.sweep, _t(o), _t(d), _t(time), _t(active), _t(bits))
    before = counter("K1b.launches")
    t1, b1 = typed_sweep(*args)
    t2, b2 = typed_sweep_plain(*args)
    assert counter("K1b.launches") == before  # no kernel launched on CPU
    assert torch.equal(t1, t2) and torch.equal(b1, b2)


def test_wrapper_refuses_other_devices():
    scene = build_scene("cornell")
    st = to_device(scene.arrays, scene.static, "cpu")
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        typed_sweep(st.sweep, meta, meta, meta[:, 0],
                    torch.zeros(4, dtype=torch.bool, device="meta"),
                    torch.zeros(4, dtype=torch.int64, device="meta"))
