"""BVH mode of the port against the JAX package: the builder, the slab
test, the JAX-order walk (``bvh_traverse_dfs_plain``) against
``make_bvh_traverser``, the nearer-first walk K4 follows
(``bvh_traverse_plain``) against the JAX-order walk and the port's typed
sweep, K4's two-child node records and stack bound, the render through
the BVH against the sweep's and the JAX package's, the mode's
resolution, the CLI flags and the kernel wrapper on the CPU.  K4 itself
is held to ``bvh_traverse_plain`` in tests/test_torch_cuda.py."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

import hyper_ray_tracer_tpu as J  # noqa: E402
from hyper_ray_tracer_tpu.models.bvh_build import (  # noqa: E402
    build_bvh as j_build_bvh,
)
from hyper_ray_tracer_tpu.ops.bvh import make_bvh_traverser  # noqa: E402
from hyper_ray_tracer_tpu.ops.intersect import (  # noqa: E402
    aabb_hit as j_aabb_hit,
)
from hyper_ray_tracer_tpu_torch import (  # noqa: E402
    RenderSettings,
    build_scene,
    prepare_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch.__main__ import main  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.bvh_build import build_bvh  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import (  # noqa: E402
    CameraConfig,
    SceneBuilder,
)
from hyper_ray_tracer_tpu_torch.ops import rng as prng  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import (  # noqa: E402
    PLANE_XY,
)
from hyper_ray_tracer_tpu_torch.ops import bvh as bvh_ops  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.bvh import (  # noqa: E402
    LEAF_SHIFT,
    STACK_SIZE,
    bvh_traverse,
    bvh_traverse_dfs_plain,
    bvh_traverse_plain,
    tree_depth,
)
from hyper_ray_tracer_tpu_torch.ops.intersect import (  # noqa: E402
    PrimFields,
    aabb_entry,
    aabb_hit,
    prim_hit_t_lanes,
)
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (  # noqa: E402
    sphere_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (  # noqa: E402
    sweep_scene,
    typed_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    AUTO_MIN_PRIMS,
    T_MIN,
    bounce_step,
    init_state,
    resolve_intersector,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import (  # noqa: E402
    bind_params,
    extract_params,
    to_device,
)
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402
from test_bvh import _random_rays, _soup_scene  # noqa: E402


def _t(x):
    x = np.array(x)  # a writable copy
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x)


def _bvh_tensors(scene, leaf_size):
    arrays, bvh, mode = prepare_scene(scene, "bvh", leaf_size)
    assert mode == "bvh"
    return to_device(arrays, scene.static, "cpu", bvh), bvh, arrays.geom


def flat_scene():
    """Zero-radius spheres on a grid in the plane y = 0 (every node over
    them alone is flat in y) beside ordinary spheres centered in the same
    plane (the nodes over both, the root among them, are not)."""
    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    for i in range(6):
        for j in range(6):
            b.sphere((2.0 * i, 0.0, 2.0 * j), 0.0, mat)
    for i in range(4):
        for j in range(2):
            b.sphere((30.0 + 2.0 * i, 0.0, 2.0 * j), 0.5, mat)
    return b.finalize(CameraConfig((0, 5, -20), (5, 0, 5), 40.0, 0.0),
                      (0, 0, 0), "flat")


def slab_nan_rays(scene):
    """Rays in the plane y = 0 (d.y = +-0), each aimed exactly at a
    zero-radius sphere of ``flat_scene`` from 5 directions back: the
    sphere's discriminant is exactly 0, so the sweep hits it (or one in
    front of it on the grid), but every node over it alone meets the
    ray's slab test as 0 * inf = NaN on both planes of y, and
    NaN-propagating min and max miss it."""
    g = scene.arrays.geom
    pts = np.asarray(g.p0)[np.asarray(g.radius) == 0.0]
    dirs = np.float32([[1, 0, 1], [1, -0.0, 0.5], [-1, 0, 2],
                       [0.5, -0.0, -1], [2, 0, 1]])
    c = np.repeat(pts, len(dirs), 0)
    d = np.tile(dirs, (len(pts), 1))
    o = (c - 5.0 * d).astype(np.float32)
    n = len(o)
    rng = np.random.default_rng(len(o))
    return (o, d, rng.random(n).astype(np.float32),
            rng.integers(0, 2**32, n, dtype=np.uint32))


BUILD_CASES = [("soup", 1), ("soup", 4), ("soup", 8), ("final", 4),
               ("sphereflake-small", 4)]


@pytest.mark.parametrize("name,leaf", BUILD_CASES,
                         ids=[f"{n}-leaf{k}" for n, k in BUILD_CASES])
def test_build_equals_jax_numpy_builder(name, leaf):
    geom = (_soup_scene() if name == "soup" else build_scene(name)
            ).arrays.geom
    tree, g = build_bvh(geom, leaf_size=leaf)
    j_tree, j_g = j_build_bvh(geom, leaf_size=leaf, use_native=False)
    for field, a, b in zip(tree._fields, tree, j_tree):
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field, a, b in zip(g._fields, g, j_g):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def _decode_records(rec):
    """K4's node records back into a tree in DFS order: per node, its
    bounds, leaf slots (first, count; -1, 0 for an inner node) and, for an
    inner node, its two children."""
    bits = rec.view(np.int32)
    bmin, bmax, first, count, kids = [], [], [], [], []

    def visit(lo, hi, word):
        node = len(bmin)
        bmin.append(lo)
        bmax.append(hi)
        kids.append(None)
        if word < 0:
            first.append(~word >> LEAF_SHIFT)
            count.append(~word & ((1 << LEAF_SHIFT) - 1))
            return node
        first.append(-1)
        count.append(0)
        r, b = rec[word], bits[word]
        kids[node] = (visit(r[0:3], r[4:7], b[3]),
                      visit(r[8:11], r[12:15], b[7]))
        return node

    visit(rec[0, 0:3], rec[0, 4:7], bits[0, 3])
    return (np.array(bmin), np.array(bmax), np.array(first),
            np.array(count), kids)


def _check_records(name, leaf):
    """The two-child records round-trip the tree: decoded from the root
    row, they give every node's bounds and leaf slots in DFS order, and
    each inner node n's children are n + 1 and skip[n + 1]."""
    scene = build_scene(name)
    st, tree, _ = _bvh_tensors(scene, leaf)
    rec = st.bvh.nodes.numpy()
    inner = tree.leaf_first < 0
    assert rec.shape == (1 + inner.sum(), 16)
    assert (rec.view(np.int32)[1:, [11, 15]] == 0).all()
    bmin, bmax, first, count, kids = _decode_records(rec)
    np.testing.assert_array_equal(bmin, tree.bounds_min)
    np.testing.assert_array_equal(bmax, tree.bounds_max)
    np.testing.assert_array_equal(first, tree.leaf_first)
    np.testing.assert_array_equal(count, np.where(inner, 0,
                                                  tree.leaf_count))
    for n in np.flatnonzero(inner):
        assert kids[n] == (n + 1, tree.skip[n + 1])
    assert st.bvh.depth == tree_depth(tree) <= STACK_SIZE
    assert st.bvh.tag.tolist() == st.arrays.geom.ptype.tolist()


def test_node_records_carry_the_tree():
    _check_records("final", 8)


@pytest.mark.parametrize("name,leaf", [("final", 1), ("cornell", 8),
                                       ("random", 4),
                                       ("sphereflake-small", 2)])
def test_node_records_round_trip(name, leaf):
    _check_records(name, leaf)


def test_stack_size_is_the_kernel_stack():
    from hyper_ray_tracer_tpu_torch.utils.cuda_build import CSRC_DIR

    src = (CSRC_DIR / "bvh_traverse.cu").read_text()
    assert f"constexpr int kStack = {STACK_SIZE};" in src
    assert f"constexpr int kLeafShift = {LEAF_SHIFT};" in src


def test_too_deep_tree_raises(monkeypatch):
    """A tree deeper than K4's stack is refused where it is uploaded."""
    scene = build_scene("final")
    arrays, tree, _ = prepare_scene(scene, "bvh", 1)
    depth = tree_depth(tree)
    assert depth == 11
    monkeypatch.setattr(bvh_ops, "STACK_SIZE", depth - 1)
    with pytest.raises(ValueError, match="deeper than K4's stack"):
        to_device(arrays, scene.static, "cpu", tree)
    monkeypatch.setattr(bvh_ops, "STACK_SIZE", depth)
    assert to_device(arrays, scene.static, "cpu", tree).bvh.depth == depth


def test_aabb_hit_equals_jax_with_nan_slabs():
    rng = np.random.default_rng(0)
    n = 4000
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 4, (n, 3))).astype(np.float32)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = (lo + rng.random((n, 3)) * (hi - lo) - o).astype(np.float32)
    # A quarter of the rays axis-parallel in one or two axes, with the
    # origin on a bound plane of those axes: 0 * inf = NaN there; every
    # third of those boxes flat on that axis, so both planes give NaN.
    for k in range(0, n, 4):
        for ax in rng.choice(3, 1 + (k // 4) % 2, replace=False):
            d[k, ax] = 0.0
            if k % 3 == 0:
                hi[k, ax] = lo[k, ax]
            o[k, ax] = (lo if k % 8 else hi)[k, ax]
    t_max = rng.choice([3.0e38, 5.0, 0.5], n).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = (np.float32(1.0) / d).astype(np.float32)
    with np.errstate(invalid="ignore"):
        want = np.asarray(j_aabb_hit(lo, hi, o, inv_d, np.float32(T_MIN),
                                     t_max, jax.numpy))
    got = aabb_hit(_t(lo), _t(hi), _t(o), 1.0 / _t(d), T_MIN, _t(t_max))
    np.testing.assert_array_equal(got.numpy(), want)
    with np.errstate(invalid="ignore"):
        slabs = np.concatenate([(lo - o) * inv_d, (hi - o) * inv_d], -1)
    nan = np.isnan(slabs).any(-1)
    assert nan[::4].mean() > 0.9 and not want[nan].any()
    assert 0.1 < want.mean() < 0.9


def _assert_bvh_rule(t, best, t_ref, best_ref):
    # tests/test_bvh.py's rule for its traversal against its scan:
    # indices equal, t to rtol 2e-5 / atol 1e-5 (XLA and torch round a
    # root or a medium's log differently on the CPU).
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=2e-5,
                               atol=1e-5)


def _jax_traverse(scene, leaf, o, d, time, bits, active):
    tree, geom = j_build_bvh(scene.arrays.geom, leaf_size=leaf,
                             use_native=False)
    trav = make_bvh_traverser(scene.static, leaf)
    return jax.jit(trav)(tree, geom, o, d, time, np.float32(T_MIN), bits,
                         active)


def _plain(st, o, d, time, bits, active):
    """The JAX package's walk order (bvh_traverse_dfs_plain)."""
    bvh = st.bvh
    return bvh_traverse_dfs_plain(bvh.tree, bvh.prims, _t(o), _t(d),
                                  _t(time), _t(active), _t(bits), T_MIN,
                                  bvh.static)


@pytest.mark.parametrize("leaf", [1, 4])
@pytest.mark.parametrize("media", [True, False], ids=["media", "no-media"])
def test_plain_matches_jax_traverser(media, leaf):
    scene = _soup_scene(with_media=media)
    o, d, time, bits = _random_rays(2000, 1)
    active = np.ones(len(o), bool)
    active[::17] = False  # the dead-ray path
    st, _, _ = _bvh_tensors(scene, leaf)
    t, best = _plain(st, o, d, time, bits, active)
    _assert_bvh_rule(t, best, *_jax_traverse(scene, leaf, o, d, time, bits,
                                             active))
    assert (best.numpy()[~active] == -1).all()
    assert (t.numpy()[~active] == np.float32(3.0e38)).all()
    assert (best.numpy() >= 0).mean() > 0.1


def test_plain_matches_jax_traverser_sphere_soup():
    scene = _soup_scene(n_spheres=200, with_rects=False, with_media=False,
                        seed=3)
    o, d, time, bits = _random_rays(1000, 2)
    active = np.ones(len(o), bool)
    st, _, _ = _bvh_tensors(scene, 4)
    t, best = _plain(st, o, d, time, bits, active)
    _assert_bvh_rule(t, best, *_jax_traverse(scene, 4, o, d, time, bits,
                                             active))


def test_plain_matches_jax_traverser_on_nan_slab_rays():
    scene = flat_scene()
    st, _, geom = _bvh_tensors(scene, 4)
    o, d, time, bits = slab_nan_rays(scene)
    active = np.ones(len(o), bool)
    t, best = _plain(st, o, d, time, bits, active)
    _assert_bvh_rule(t, best, *_jax_traverse(scene, 4, o, d, time, bits,
                                             active))
    # The NaN decides: the sweep hits a zero-radius sphere on every ray
    # (the aimed one at t = 5, or one in front of it on the grid).
    sw = sweep_scene(geom, st.arrays.geom, scene.static.n_prims)
    t_s, best_s = typed_sweep_plain(sw, _t(o), _t(d), _t(time), _t(active),
                                    _t(bits), T_MIN)
    assert (best_s >= 0).all() and (t_s <= 5.0).all()
    radius = st.arrays.geom.radius
    assert (radius[best_s.long()] == 0.0).all()
    # The walk misses nearly all: only a leaf that also holds an ordinary
    # sphere is not flat.
    assert (best == -1).float().mean() > 0.9


# The nearer-first walk against the JAX-order walk, camera rays and
# bounces 1-2 (32x18, 2 spp), on every scene and leaf sizes 1, 4 and 8.
# Rule, measured: winners and t equal on every ray.  Ties go to the
# lowest index in both walks, and each finds the closest hit in its own
# order; two things can still part them, where a hit is decided by the
# bound the running best sets when it is tested: a medium's free flight
# (a scattering distance at the bound itself), and a float32 hit outside
# its own leaf's box, which one walk's best culls and the other's does
# not (`sphereflake`: one camera ray in 921,600 at 1280x720,
# test_nearer_first_parts_from_dfs_only_on_a_float32_graze).  On none of
# these rays does either.
ORDER_CASES = ([(name, 4) for name in (
    "random", "two-spheres", "two-perlin-spheres", "earth", "simple-light",
    "cornell", "cornell-smoke", "final", "sphereflake", "sphereflake-small",
    "one-sphere", "three-spheres")]
    + [("final", 1), ("final", 8), ("sphereflake", 1), ("cornell", 8)])


@pytest.mark.parametrize("name,leaf", ORDER_CASES,
                         ids=[f"{n}-leaf{k}" for n, k in ORDER_CASES])
def test_nearer_first_equals_dfs_walk(name, leaf):
    scene = build_scene(name)
    st, tree, _ = _bvh_tensors(scene, leaf)
    bvh = st.bvh
    hits, box, dfs_nodes = 0, 0, 0
    for state, bb in _waves(scene, st):
        args = (state.o, state.d, state.time, state.alive, bb, T_MIN,
                bvh.static)
        near, dfs = {}, {}
        t_n, b_n = bvh_traverse_plain(bvh.tree, bvh.prims, *args,
                                      stats=near)
        t_d, b_d = bvh_traverse_dfs_plain(bvh.tree, bvh.prims, *args,
                                          stats=dfs)
        assert torch.equal(b_n, b_d) and torch.equal(t_n, t_d)
        assert near["max_stack"] <= bvh.depth
        assert near["box_tests"] == (int(state.alive.sum())
                                     + 2 * near["inner_steps"])
        hits += int((b_n >= 0).sum())
        box += near["box_tests"]
        dfs_nodes += dfs["node_tests"]
    assert hits > 50
    # Two boxes a step: fewer steps than the JAX-order walk's nodes
    # wherever the tree has more than one level.
    assert box <= 2 * dfs_nodes


def tie_scene():
    """Two rects in the plane z = 0: A (x in [0, 1]) and a wider B (x in
    [-2, 20]) that sorts after it, so A is the left leaf (index 0) and B
    the right (index 1)."""
    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    b.rect(PLANE_XY, 0.0, 1.0, 0.0, 1.0, 0.0, mat)
    b.rect(PLANE_XY, -2.0, 20.0, -2.0, 3.0, 0.0, mat)
    return b.finalize(CameraConfig((0, 0, -5), (0, 0, 0), 40.0, 0.0),
                      (0, 0, 0), "tie")


def tie_rays():
    """Rays grazing the plane (d = (1, 0, 0.01)) that meet it at x = 0.001
    + 0.001 k inside A: both rects hit at one t, and A's box is entered
    later than B's (its x slab opens after the plane's z slab)."""
    k = np.arange(8, dtype=np.float32)
    n = len(k)
    d = np.tile(np.float32([1.0, 0.0, 0.01]), (n, 1))
    p = np.stack([0.001 + 0.001 * k, 0.1 + 0.1 * k, np.zeros(n)], 1)
    o = (p - 10.0 * d).astype(np.float32)
    return (o, d, np.zeros(n, np.float32), np.ones(n, bool),
            np.arange(n, dtype=np.int64))


def test_tie_goes_to_the_lowest_index_when_the_higher_comes_first():
    scene = tie_scene()
    st, tree, geom = _bvh_tensors(scene, 1)
    bvh = st.bvh
    assert np.asarray(geom.p1)[:2, 0].tolist() == [1.0, 20.0]  # A, then B
    o, d, time, active, bits = (_t(x) for x in tie_rays())
    # The nearer-first order visits B (the right child) first ...
    inv_d = 1.0 / d
    far = torch.full((o.shape[0],), 3.0e38)
    left, right = 1, int(tree.skip[1])
    h_l, t_l = aabb_entry(bvh.tree.bounds_min[left],
                          bvh.tree.bounds_max[left], o, inv_d, T_MIN, far)
    h_r, t_r = aabb_entry(bvh.tree.bounds_min[right],
                          bvh.tree.bounds_max[right], o, inv_d, T_MIN, far)
    assert (h_l & h_r & (t_r < t_l)).all()
    # ... and both rects hit at one t, so A wins by its index alone.
    stats = {}
    t, best = bvh_traverse_plain(bvh.tree, bvh.prims, o, d, time, active,
                                 bits, T_MIN, bvh.static, stats=stats)
    assert (best == 0).all() and (t < 3.0e38).all()
    assert int(stats["prim_tests"].sum()) == 2 * o.shape[0]
    t_d, best_d = bvh_traverse_dfs_plain(bvh.tree, bvh.prims, o, d, time,
                                         active, bits, T_MIN, bvh.static)
    assert torch.equal(best_d, best) and torch.equal(t_d, t)
    for pid in (0, 1):
        pf = PrimFields(*(x[pid].expand(o.shape[0], *x.shape[1:])
                          for x in bvh.prims))
        t_one = prim_hit_t_lanes(pf, o, d, time, T_MIN, far, bits,
                                 bvh.static)
        assert torch.equal(t_one, t)


def _waves(scene, st, W=32, H=18, bounces=3):
    pix = torch.arange(W * H, dtype=torch.int64)
    state = init_state(make_basis(scene.camera, W, H), W, H, pix.repeat(2),
                       torch.arange(2).repeat_interleave(W * H), 0)
    for b in range(bounces):
        yield state, prng.bounce_base(state.base, b)
        state = bounce_step(st, scene.background, state, b)


@pytest.mark.parametrize("name", ["random", "cornell", "sphereflake-small",
                                  "soup"])
def test_plain_equals_typed_sweep_on_reordered_geometry(name):
    """Without media the sweep's stale tile bound picks the same winners
    as the running best, so on the same (reordered) geometry the walk and
    the sweep agree bit for bit: winners and t."""
    scene = (_soup_scene(with_media=False) if name == "soup"
             else build_scene(name))
    assert not scene.static.has_media
    st, _, geom = _bvh_tensors(scene, 4)
    n = scene.static.n_prims
    sw = sweep_scene(geom, st.arrays.geom, n)
    hits = 0
    for state, bb in _waves(scene, st):
        args = (state.o, state.d, state.time, state.alive, bb)
        t_b, best_b = bvh_traverse(st.bvh, *args, T_MIN)
        t_s, best_s = typed_sweep_plain(sw, *args, T_MIN)
        assert torch.equal(best_b, best_s) and torch.equal(t_b, t_s)
        hits += int((best_b >= 0).sum())
    assert hits > 100


# Camera rays (1280x720, 1 spp, seed 0) on which the sphere sweep and
# the BVH part on `sphereflake`, found on the card.
FLAKE_RAYS = [395879, 712311, 722562, 722595, 741979, 759629, 762129,
              762198, 762439, 772362, 776262, 791881, 792910, 796758,
              808185, 813610]


def test_sweep_hits_the_smallest_spheres_in_float32_only():
    """Where the sweep and the walk part on `sphereflake`, the sweep has
    hit one of the smallest spheres (r = 1/243) that the ray misses in
    float64: c = |oc|^2 - r^2 cancels in float32 (|oc|^2 >> r^2), while
    the walk's slab test culls the sphere's node."""
    scene = build_scene("sphereflake")
    W, H = 1280, 720
    ids = torch.tensor(FLAKE_RAYS, dtype=torch.int64)
    s = init_state(make_basis(scene.camera, W, H), W, H, ids,
                   torch.zeros_like(ids), 0)
    sw = to_device(scene.arrays, scene.static, "cpu")
    t_s, best_s = sphere_sweep_plain(*sw.spheres, s.o, s.d, s.time, s.alive,
                                     T_MIN)
    st, _, _ = _bvh_tensors(scene, 4)
    t_b, best_b = bvh_traverse(st.bvh, s.o, s.d, s.time, s.alive,
                               prng.bounce_base(s.base, 0), T_MIN)
    canon = torch.where(best_b >= 0, st.arrays.geom.stable_id[
        best_b.clamp(min=0).long()].to(torch.int32), -1)
    part = (canon != best_s).nonzero().squeeze(1).tolist()
    assert len(part) >= 8  # the CPU's camera rays round a few otherwise
    g = scene.arrays.geom
    for i in part:
        k = int(best_s[i])
        r = float(g.radius[k])
        assert r == float(np.float32(1.0 / 243)) and t_s[i] < t_b[i]
        o = s.o[i].double().numpy()
        d = s.d[i].double().numpy()
        oc = o - np.asarray(g.p0[k], np.float64)
        miss = np.linalg.norm(np.cross(oc, d)) / np.linalg.norm(d)
        assert r < miss < 1.5 * r


# The camera ray (1280x720, 1 spp, seed 0) of `sphereflake`, leaf 4, on
# which the nearer-first walk and the JAX-order walk part: the only one of
# the 921,600 (found on the CPU, and counted again on the card).
FLAKE_PART_RAY = 675315


def _miss_over_r(o, d, center, r):
    """The ray's distance from the sphere's center, in float64, over r."""
    oc = o.double().numpy() - np.asarray(center, np.float64)
    d = d.double().numpy()
    return np.linalg.norm(np.cross(oc, d)) / np.linalg.norm(d) / r


def test_nearer_first_parts_from_dfs_only_on_a_float32_graze():
    """The JAX-order walk enters the leaf of one of the smallest spheres
    (r = 1/243) first and takes its float32 hit, which lies before that
    leaf box's own entry: in float64 the ray misses the sphere by 1.07 r
    (c = |oc|^2 - r^2 cancels, as where the sweep parts from the walk).
    By then the nearer-first walk has taken a true hit in the leaf it
    entered first, nearer than that box's entry, and the slab test culls
    the box."""
    scene = build_scene("sphereflake")
    st, tree, _ = _bvh_tensors(scene, 4)
    bvh = st.bvh
    W, H = 1280, 720
    ids = torch.tensor([FLAKE_PART_RAY])
    s = init_state(make_basis(scene.camera, W, H), W, H, ids,
                   torch.zeros_like(ids), 0)
    args = (s.o, s.d, s.time, s.alive, prng.bounce_base(s.base, 0), T_MIN,
            bvh.static)
    t_n, b_n = bvh_traverse_plain(bvh.tree, bvh.prims, *args)
    t_d, b_d = bvh_traverse_dfs_plain(bvh.tree, bvh.prims, *args)
    k_n, k_d = int(b_n[0]), int(b_d[0])
    assert k_n != k_d and t_d[0] < t_n[0]
    g = st.arrays.geom
    r = float(g.radius[k_d])
    assert r == float(np.float32(1.0 / 243))
    assert 1.0 < _miss_over_r(s.o[0], s.d[0], g.p0[k_d], r) < 1.5
    assert _miss_over_r(s.o[0], s.d[0], g.p0[k_n], float(g.radius[k_n])) < 1
    leaf = int(np.flatnonzero((tree.leaf_first <= k_d) & (
        tree.leaf_first + tree.leaf_count > k_d) & (tree.leaf_first >= 0))[0])
    hit, t_lo = aabb_entry(bvh.tree.bounds_min[leaf],
                           bvh.tree.bounds_max[leaf], s.o, 1.0 / s.d, T_MIN,
                           torch.full((1,), 3.0e38))
    assert bool(hit[0]) and t_d[0] < t_n[0] < t_lo[0]


# Bit-equal on every scene listed: each compared lane takes the same
# winner through either mode, and the hit's shading is the winner's.
@pytest.mark.parametrize("name", ["random", "cornell", "sphereflake-small"])
def test_render_bvh_equals_sweep(name):
    scene = build_scene(name)
    s = dict(width=32, height=18, samples=2, depth=4)
    sweep = render_image(scene, RenderSettings(**s, intersector="sweep"),
                         "cpu")
    bvh = render_image(scene, RenderSettings(**s, intersector="bvh"), "cpu")
    np.testing.assert_array_equal(bvh, sweep)
    assert (sweep.sum(-1) > 0).mean() > 0.005  # lit pixels


def test_render_bvh_matches_jax_bvh():
    """As tests/test_oracle_vs_jax.py:123-129, against the JAX package's
    BVH render.  Its atol 5e-4 holds on all but one pixel of 240: there
    the port's sweep render differs from the JAX package's by the same
    0.093, a path that diverged on an ulp (a secondary ray's root that
    straddles t_min, tests/test_torch_typed_sweep.py), so the rule is
    at least 99% of pixels within 5e-4 and a mean below 1e-3."""
    s = dict(width=20, height=12, samples=2, depth=4)
    want = J.render_image(J.build_scene("random"),
                          J.RenderSettings(**s, intersector=True))
    got = render_image(build_scene("random"),
                       RenderSettings(**s, intersector="bvh"), "cpu")
    err = np.abs(got - want)
    assert (err <= 5e-4).all(-1).mean() >= 0.99
    assert err.mean() < 1e-3


def test_resolve_intersector():
    final = build_scene("final")
    assert resolve_intersector(final, None) == "sweep"
    assert resolve_intersector(final, "auto") == "sweep"
    assert resolve_intersector(final, False) == "sweep"
    assert resolve_intersector(final, "sweep") == "sweep"
    assert resolve_intersector(final, "bvh") == "bvh"
    assert resolve_intersector(final, True) == "bvh"
    assert resolve_intersector(final, "cluster") == "cluster"
    with pytest.raises(ValueError):
        resolve_intersector(final, "octree")
    big = dataclasses.replace(final, static=dataclasses.replace(
        final.static, n_prims=AUTO_MIN_PRIMS))
    assert resolve_intersector(big, None) == "bvh"
    assert resolve_intersector(big, "sweep") == "sweep"
    below = dataclasses.replace(final, static=dataclasses.replace(
        final.static, n_prims=AUTO_MIN_PRIMS - 1))
    assert resolve_intersector(below, "auto") == "sweep"
    assert AUTO_MIN_PRIMS == J.render.AUTO_CLUSTER_MIN_PRIMS


def test_prepare_scene_modes():
    scene = build_scene("cornell")
    arrays, bvh, mode = prepare_scene(scene)
    assert (arrays is scene.arrays, bvh, mode) == (True, None, "sweep")
    arrays, bvh, mode = prepare_scene(scene, "bvh", 2)
    assert mode == "bvh" and bvh.leaf_count.max() <= 2
    assert arrays.geom.ptype.shape[0] == scene.static.n_prims + 2
    with pytest.raises(ValueError, match="leaf_size"):
        prepare_scene(scene, "bvh", 9)
    st = to_device(arrays, scene.static, "cpu", bvh)
    assert st.mode == "bvh" and st.sweep is None
    # A train step binds the parameters in BVH mode too: the leaves'
    # records follow them, the tree stays as built.
    bound = bind_params(st, extract_params(st.arrays))
    assert bound.mode == "bvh" and bound.bvh.nodes is st.bvh.nodes


def test_wrapper_takes_plain_on_cpu_and_refuses_other_devices():
    scene = build_scene("cornell-smoke")
    st, _, _ = _bvh_tensors(scene, 4)
    state, bb = next(_waves(scene, st))
    args = (state.o, state.d, state.time, state.alive, bb)
    before = counter("K4.launches")
    t, best = bvh_traverse(st.bvh, *args, T_MIN)
    assert counter("K4.launches") == before
    t_p, best_p = bvh_traverse_plain(st.bvh.tree, st.bvh.prims, *args,
                                     T_MIN, st.bvh.static)
    assert torch.equal(t, t_p) and torch.equal(best, best_p)
    assert t.dtype == torch.float32 and best.dtype == torch.int32
    with pytest.raises(ValueError, match="unsupported device"):
        bvh_traverse(st.bvh, *(x.to("meta") for x in args), T_MIN)


def test_cli_bvh_writes_png(tmp_path):
    out = tmp_path / "flake.png"
    assert main(["--cpu", "--scene", "sphereflake-small", "--intersector",
                 "bvh", "--leaf-size", "2", "--width", "24", "--height",
                 "14", "--samples", "1", "--depth", "3", "--output",
                 str(out)]) == 0
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (24, 14)


def test_cli_cluster_names_the_roadmap_item(tmp_path):
    """The cluster intersector, once refused with the ROADMAP item that
    would port it, renders now (tests/test_torch_cluster.py holds it to
    the sweeps and the JAX package); the CLI's help no longer calls it
    unported."""
    from hyper_ray_tracer_tpu_torch import __main__ as cli

    assert main(["--cpu", "--scene", "cornell", "--intersector", "cluster",
                 "--width", "8", "--height", "8", "--samples", "1",
                 "--output", str(tmp_path / "x.png")]) == 0
    assert (tmp_path / "x.png").exists()
    assert "not ported" not in open(cli.__file__).read()


@pytest.mark.parametrize("verbosity,shown", [(None, True), ("2", True),
                                              ("0", False)])
def test_cli_verbosity(tmp_path, caplog, verbosity, shown):
    argv = ["--cpu", "--scene", "one-sphere", "--width", "8", "--height",
            "6", "--samples", "1", "--depth", "2", "--output",
            str(tmp_path / "x.png")]
    if verbosity is not None:
        argv += ["--verbosity", verbosity]
    assert main(argv) == 0
    # The default 2 shows debug and info lines, 0 warnings alone.
    assert ("Intersector: sweep" in caplog.text) == shown
    assert ("Rendering finished" in caplog.text) == shown
