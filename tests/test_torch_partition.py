"""The partitioned sweep of the port (``ops/partition.py``, the sweeps'
``mask`` form, ``render.PartitionSchedule``) on the CPU.

The groups, masks, categories, boxes and per-bounce decisions are held
to the JAX package's host functions (NumPy, no XLA compile).  The port's
partitioned sweep is held to its plain sweep bit for bit: the twins of
K1b and K1 with and without masks, and renders and train steps with and
without ``partition``.  ``PART_MIN_LANES`` (and, for `random`,
``PART_SAVED_MIN``) are patched down so that the partition engages at
these sizes, as ``tests/test_partition.py`` does for the JAX package.
The card's kernels are held to these twins by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import hyper_ray_tracer_tpu.ops.partition as JP
from hyper_ray_tracer_tpu_torch import RenderSettings, render_image
from hyper_ray_tracer_tpu_torch import render as render_mod
from hyper_ray_tracer_tpu_torch.camera import make_basis
from hyper_ray_tracer_tpu_torch.models.builders import SCENES, build_scene
from hyper_ray_tracer_tpu_torch.ops import partition as P
from hyper_ray_tracer_tpu_torch.ops import rng as prng
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (
    sphere_sweep,
    sphere_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
    typed_sweep,
    typed_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.render import (
    T_MIN,
    PartitionSchedule,
    WavefrontState,
    bounce_paths,
    bounce_step,
    init_state,
    render_radiance,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import bind_params, to_device
from hyper_ray_tracer_tpu_torch.train import (
    extract_params,
    make_loss_fn,
    make_train_step,
    pixel_lanes,
)

torch.set_num_threads(1)

W, H = 64, 36


@pytest.fixture
def small_lanes(monkeypatch):
    """Let the partition engage on the tests' small wavefronts."""
    monkeypatch.setattr(P, "PART_MIN_LANES", 512)


@pytest.fixture
def schedules(monkeypatch):
    """Every PartitionSchedule a render makes, in order."""
    made = []

    class Recorded(render_mod.PartitionSchedule):
        def __init__(self, groups):
            super().__init__(groups)
            made.append(self)

    monkeypatch.setattr(render_mod, "PartitionSchedule", Recorded)
    return made


def _scene(name):
    scene = build_scene(name)
    return scene, to_device(scene.arrays, scene.static, "cpu")


def _waves(scene, st, spp=1, depth=3, seed=7):
    """The wavefronts of bounces 0..depth-1 (survivors in launch order),
    with each one's bounce words."""
    basis = make_basis(scene.camera, W, H)
    ids = torch.arange(W * H * spp)
    state = init_state(basis, W, H, ids % (W * H), ids // (W * H), seed)
    out = []
    for bounce in range(depth):
        out.append((state, prng.bounce_base(state.base, bounce)))
        state = bounce_step(st, scene.background, state, bounce)
        keep = state.alive.nonzero().squeeze(1)
        state = WavefrontState(*(x[keep] for x in state))
    return out


def _jax_groups(groups):
    return tuple(JP.PartGroup(*g) for g in groups)


# (a) groups


@pytest.mark.parametrize("name", sorted(SCENES))
def test_partition_groups_equal_jax(name):
    scene = build_scene(name)
    got = P.partition_groups(scene.arrays.geom, scene.static.n_prims)
    want = JP.partition_groups(scene.arrays.geom, scene.static.n_prims)
    assert [tuple(g) for g in got] == [tuple(g) for g in want]


def test_final_has_two_groups_and_the_plan_is_cut_at_them():
    _, st = _scene("final")
    assert [(g.start, g.end, g.dynamic_ok) for g in st.groups] == [
        (6, 1006, True), (1009, 1409, True)]
    for t in st.sweep.plan:
        in_group = [i for i, g in enumerate(st.groups)
                    if g.start <= t.start < g.end]
        assert t.group == (in_group[0] if in_group else -1)
        if t.group >= 0:  # a tile never straddles a group's bound
            assert t.start + t.width <= st.groups[t.group].end
    assert st.sweep.plan_rows[:, 7].tolist() == [t.group
                                                 for t in st.sweep.plan]


# (b) masks and categories


def _seeded_rays(n, seed, lo=-600.0, hi=1200.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # Axis-parallel directions, zero components and rays on slab planes.
    d[: n // 8, 1:] = 0.0
    d[n // 8: n // 4, 0] = 0.0
    d[n // 4: n // 4 + 16] = rng.choice([-1e-25, 0.0, 1e-25], (16, 3))
    return o, d


def _box_rays(groups, seed):
    """Rays aimed near each group's box (about half meet it), with some
    of their origins on its faces."""
    rng = np.random.default_rng(seed)
    os, ds = [], []
    for g in groups:
        bmin, bmax = np.float32(g.bmin), np.float32(g.bmax)
        c, ext = (bmin + bmax) / 2, bmax - bmin
        o = (c + rng.normal(size=(512, 3)) * ext * 2).astype(np.float32)
        tgt = c + rng.uniform(-0.8, 0.8, (512, 3)) * ext
        d = (tgt - o).astype(np.float32)
        o[:32, 0] = bmin[0]  # on the x = bmin face
        d[:32, 0] = 0.0
        os.append(o)
        ds.append(d)
    return np.concatenate(os), np.concatenate(ds)


def _conservative_case():
    """tests/test_partition.py::test_overlap_masks_conservative's case."""
    g = JP.PartGroup(0, 1, np.float32([0, 0, 0]), np.float32([1, 1, 1]))
    o = np.float32([[0.5, 0.5, -1.0], [0.5, 0.5, -1.0], [0.5, 0.5, 0.5],
                    [0.5, 0.5, 2.0], [0.0, 0.5, -1.0]])
    d = np.float32([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 0, 1], [0, 0, 1]])
    return (g,), o, d


def test_overlap_masks_conservative():
    groups, o, d = _conservative_case()
    m = P.overlap_masks(groups, torch.from_numpy(o), torch.from_numpy(d))
    assert m[:, 0].tolist() == [True, False, True, False, True]
    np.testing.assert_array_equal(
        m.numpy(), JP.overlap_masks(groups, o, d, np))


@pytest.mark.parametrize("name", ["final", "random"])
def test_masks_and_categories_equal_jax(name):
    scene = build_scene(name)
    groups = P.partition_groups(scene.arrays.geom, scene.static.n_prims)
    o1, d1 = _seeded_rays(4096, 3)
    o2, d2 = _box_rays(groups, 4)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jg = _jax_groups(groups)
    want = JP.overlap_masks(jg, o, d, np)
    got = P.overlap_masks(groups, to, td)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    cat = P.lane_layout_cat(groups, to, td)
    np.testing.assert_array_equal(cat.numpy(),
                                  JP.lane_layout_cat(jg, o, d, np))
    mask = P.group_mask(groups, to, td)
    assert mask.dtype == torch.uint8
    np.testing.assert_array_equal(
        (1 << len(groups)) - 1 - mask.numpy().astype(np.int32), cat.numpy())
    for i in range(len(groups)):  # bit G-1-i says "meets group i"
        np.testing.assert_array_equal(
            (mask.numpy() & P.group_bit(len(groups), i)) != 0, want[:, i])
    # With boxes from the parameters (a train step's) as well.
    geom = scene.arrays.geom
    aabbs = JP.device_group_aabbs(jg, geom, np)
    t_aabbs = P.device_group_aabbs(groups, _torch_geom(geom))
    np.testing.assert_array_equal(
        P.overlap_masks(groups, to, td, t_aabbs).numpy(),
        JP.overlap_masks(jg, o, d, np, aabbs=aabbs))


# (c) boxes from the parameters


def _torch_geom(geom):
    return geom._replace(**{k: torch.from_numpy(np.asarray(getattr(geom, k)))
                            for k in ("p0", "p1", "radius")})


@pytest.mark.parametrize("name", ["final", "random"])
def test_device_group_aabbs_equal_jax_on_stepped_parameters(name):
    scene = build_scene(name)
    groups = P.partition_groups(scene.arrays.geom, scene.static.n_prims)
    rng = np.random.default_rng(11)
    g = scene.arrays.geom
    stepped = g._replace(
        p0=(g.p0 + rng.normal(size=g.p0.shape) * 3).astype(np.float32),
        p1=(g.p1 + rng.normal(size=g.p1.shape) * 3).astype(np.float32),
        radius=(g.radius * rng.uniform(0.5, 1.5, g.radius.shape)
                ).astype(np.float32))
    # Hollow spheres have a negative radius (three-spheres' glass shell):
    # make a group's largest radius one, so |r| decides its box.
    a, b = groups[0].start, groups[0].end
    big = a + int(np.argmax(stepped.radius[a:b]))
    stepped.radius[big] = -2.0 * stepped.radius[big]
    for geom in (g, stepped):
        want = JP.device_group_aabbs(_jax_groups(groups), geom, np)
        got = P.device_group_aabbs(groups, _torch_geom(geom))
        for (wmin, wmax), (gmin, gmax) in zip(want, got):
            np.testing.assert_array_equal(gmin.numpy(), wmin)
            np.testing.assert_array_equal(gmax.numpy(), wmax)
    # At the geometry as built, the boxes cover the baked ones.
    for (gmin, gmax), grp in zip(P.device_group_aabbs(groups,
                                                      _torch_geom(g)),
                                 groups):
        assert (gmin.numpy() <= np.float32(grp.bmin)).all()
        assert (gmax.numpy() >= np.float32(grp.bmax)).all()


# (d) the masked twins


@pytest.mark.parametrize("order", ["launch", "category"])
def test_masked_typed_twin_equals_unmasked(order):
    scene, st = _scene("final")
    partitioned = 0
    for bounce, (s, bb) in enumerate(_waves(scene, st)):
        mask = P.group_mask(st.groups, s.o, s.d, st.group_aabbs)
        if order == "category":
            idx = torch.sort((3 - mask).int(), stable=True).indices
            s, bb, mask = (WavefrontState(*(x[idx] for x in s)), bb[idx],
                           mask[idx])
        args = (st.sweep, s.o, s.d, s.time, s.alive, bb, T_MIN)
        t_p, b_p = typed_sweep_plain(*args)
        t_m, b_m = typed_sweep(*args, mask=mask)
        assert torch.equal(t_m, t_p) and torch.equal(b_m, b_p), bounce
        assert (b_p >= 0).any()
        partitioned += int((mask != 3).sum())
    assert partitioned > 0  # some lanes skipped a group


def _two_groups(st):
    """`random`'s spheres cut into two groups of the port's kind (a K1
    case with two groups; the scene itself has one)."""
    p0 = st.spheres.p0.numpy()
    r = np.abs(st.spheres.radius.numpy())[:, None]
    out = []
    for a, b in ((96, 300), (300, 486)):
        out.append(P.PartGroup(a, b, tuple(float(v) for v in
                                           (p0[a:b] - r[a:b]).min(0)),
                               tuple(float(v) for v in
                                     (p0[a:b] + r[a:b]).max(0)), True))
    return tuple(out)


@pytest.mark.parametrize("groups", ["scene", "two"])
def test_masked_sphere_twin_equals_unmasked(groups):
    scene, st = _scene("random")
    gs = st.groups if groups == "scene" else _two_groups(st)
    # p1 == p0 for the two-group case's boxes to bound the moving spheres.
    sph = st.spheres if groups == "scene" else st.spheres._replace(
        p1=st.spheres.p0)
    skipped = 0
    for bounce, (s, _) in enumerate(_waves(scene, st)):
        mask = P.group_mask(gs, s.o, s.d)
        args = (*sph, s.o, s.d, s.time, s.alive, T_MIN)
        t_p, b_p = sphere_sweep_plain(*args)
        t_m, b_m = sphere_sweep(*args, mask=mask, groups=gs)
        assert torch.equal(t_m, t_p) and torch.equal(b_m, b_p), bounce
        skipped += int((mask != (1 << len(gs)) - 1).sum())
    assert skipped > 0


def test_mask_and_groups_go_together():
    scene, st = _scene("random")
    s, bb = _waves(scene, st, depth=1)[0]
    mask = P.group_mask(st.groups, s.o, s.d)
    args = (*st.spheres, s.o, s.d, s.time, s.alive, T_MIN)
    with pytest.raises(ValueError, match="without partition groups"):
        sphere_sweep(*args, mask=mask)
    with pytest.raises(ValueError, match="without a mask"):
        sphere_sweep(*args, groups=st.groups)
    with pytest.raises(ValueError, match="uint8"):
        sphere_sweep(*args, mask=mask.int(), groups=st.groups)
    _, cornell = _scene("cornell")
    s2, bb2 = _waves(build_scene("cornell"), cornell, depth=1)[0]
    with pytest.raises(ValueError, match="without partition groups"):
        typed_sweep(cornell.sweep, s2.o, s2.d, s2.time, s2.alive, bb2,
                    mask=torch.zeros(s2.o.shape[0], dtype=torch.uint8))


# (e) renders


@pytest.mark.parametrize("name", ["final", "random"])
def test_partitioned_render_equals_plain(name, small_lanes, schedules,
                                         monkeypatch):
    if name == "random":  # its one group spans the view: force it
        monkeypatch.setattr(P, "PART_SAVED_MIN", 0.0)
    scene = build_scene(name)
    img = render_image(scene, RenderSettings(W, H, 2, 6, spp_chunk=1), "cpu")
    plain = render_image(scene, RenderSettings(W, H, 2, 6, spp_chunk=1,
                                               partition=False), "cpu")
    np.testing.assert_array_equal(img, plain)
    assert len(schedules) == 1  # none with partition=False
    decisions = schedules[0].decisions
    assert any(decisions), decisions
    assert decisions[0]  # the camera rays were pre-partitioned


def test_random_decisions_follow_the_rule(small_lanes, schedules):
    """`random`'s group spans the view: at this shape no bounce skips
    PART_SAVED_MIN of the pairs (its wavefronts below the lane floor
    compute no counts)."""
    render_image(build_scene("random"), RenderSettings(W, H, 1, 4), "cpu")
    sched, = schedules
    assert sched.decisions == [False] * 4
    assert all(c is None or len(c) == 2 for c in sched.counts)
    assert sched.counts[0] is not None


def test_later_chunks_reuse_the_probe_decisions(small_lanes, schedules,
                                                monkeypatch):
    """The first chunk decides; a later chunk computes no mask for a
    bounce that runs plain."""
    calls = []
    real = P.group_mask
    monkeypatch.setattr(P, "group_mask", lambda *a, **k: (
        calls.append(a[1].shape[0]) or real(*a, **k)))
    render_image(build_scene("random"), RenderSettings(W, H, 3, 4,
                                                       spp_chunk=1), "cpu")
    sched, = schedules
    assert not any(sched.decisions)
    probed = sum(c is not None for c in sched.counts)
    assert len(calls) == probed  # the first chunk's only


def test_small_wavefronts_stay_plain(schedules):
    render_image(build_scene("final"), RenderSettings(W, H, 1, 3), "cpu")
    sched, = schedules
    assert sched.decisions == [False] * 3
    assert sched.counts == [None] * 3


def test_checkpoint_records_the_partition_flag(tmp_path):
    from hyper_ray_tracer_tpu_torch.utils import checkpoint as ckpt

    for flag in (True, False):
        path = str(tmp_path / f"{flag}.ckpt")
        render_image(build_scene("final"), RenderSettings(
            16, 9, 1, 2, checkpoint_path=path, partition=flag), "cpu")
        assert ckpt.load_state(path)[2]["partition"] is flag


# (f) the compaction keeps every lane's radiance


def test_partitioned_compaction_keeps_survivor_radiance(small_lanes):
    """The partitioned compaction is a permutation: a surviving lane
    keeps its radiance (the JAX package's compact_wavefront_part
    materialises survivors' radiance as zeros, which relies on no
    material both emitting and scattering; ADVICE.md on render.py:961)."""
    scene, st = _scene("final")
    s, _ = _waves(scene, st, depth=1)[0]
    rng = np.random.default_rng(5)
    s = s._replace(radiance=torch.from_numpy(
        rng.uniform(0.5, 1.0, (s.o.shape[0], 3)).astype(np.float32)))
    sched = PartitionSchedule(st.groups)
    out = bounce_paths(st, scene.background, s, 3, schedule=sched)
    plain = bounce_paths(st, scene.background, s, 3)
    assert any(sched.decisions)
    assert torch.equal(out, plain)
    assert (out >= 0.5).all()  # nothing a lane carried was dropped


# (g) the decisions


def _jax_decisions(pre, counts, groups, n_prims):
    from hyper_ray_tracer_tpu.render import schedule_from_cat_counts

    C = len(pre)
    pre_e, entries = schedule_from_cat_counts(
        np.asarray(pre), np.asarray(counts), int(np.sum(pre)),
        _jax_groups(groups), n_prims)
    return [pre_e is not None] + [e is not None and len(e[0]) == C
                                  for e in entries]


def _decisions(pre, counts, groups, n_prims):
    """The port's decision for each bounce (PartitionSchedule's): bounce
    0 from the camera rays' counts, bounce b + 1 from those alive after
    bounce b."""
    return [P.worth(c, groups, n_prims) for c in [pre, *counts]]


@pytest.mark.parametrize("name", ["final", "random"])
def test_decisions_equal_jax_schedule(name):
    scene = build_scene(name)
    n = scene.static.n_prims
    groups = P.partition_groups(scene.arrays.geom, n)
    C = 1 << len(groups)
    rng = np.random.default_rng(17)
    seen = set()
    for trial in range(40):
        scale = rng.choice([1_000, 30_000, 200_000, 2_000_000])
        pre = rng.integers(0, scale, C)
        counts = rng.integers(0, scale, (5, C))
        counts[rng.random((5, C)) < 0.3] = 0
        want = _jax_decisions(pre, counts, groups, n)
        assert _decisions(pre, counts, groups, n) == want
        seen |= set(want)
    assert seen == {True, False}
    # The counts of a real probe (final's at the bench shape's spp).
    if name == "final":
        pre = [0, 42_102, 346_155, 1_051_743]
        counts = [[14_902, 18_013, 345_950, 592_139],
                  [9_801, 14_477, 168_009, 391_213]]
        want = _jax_decisions(pre, counts, groups, n)
        assert _decisions(pre, counts, groups, n) == want == [True] * 3


# (h) training


def _loss_and_grads(loss_fn, st, params, shape=(32, 18, 1, 3)):
    scene = build_scene("final")
    w, h, spp, _ = shape
    basis = make_basis(scene.camera, w, h)
    pix, sam = pixel_lanes(w, h, spp, "cpu")
    target = torch.zeros((w * h, 3))
    for p in params.values():
        p.grad = None
    loss = loss_fn(params, st, basis, pix, sam, 0, target)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in params.items()
                           if p.grad is not None}


def _fresh_params(st):
    return {k: v.detach().clone().requires_grad_()
            for k, v in extract_params(st.arrays).items()}


def test_partitioned_train_step_equals_plain(small_lanes, capsys):
    scene, st = _scene("final")
    shape = (32, 18, 1, 3)
    part = make_loss_fn(scene, *shape[:2], shape[3], partition=True)
    plain = make_loss_fn(scene, *shape[:2], shape[3])
    params = _fresh_params(st)
    l_p, g_p = _loss_and_grads(part, st, params, shape)
    assert part.schedule() is not None and any(part.schedule().decisions)
    l_0, g_0 = _loss_and_grads(plain, st, params, shape)
    assert torch.equal(l_p, l_0)
    gaps = {}
    for k in g_0:
        scale = g_0[k].abs().max().item()
        gaps[k] = ((g_p[k] - g_0[k]).abs().max().item() / scale
                   if scale > 0 else 0.0)
        assert gaps[k] <= 1e-5, (k, gaps)
    with capsys.disabled():
        print(f"\npartitioned vs plain gradient gaps (of each key's "
              f"largest): {max(gaps.values()):.3e} at most")
    # A second call from the same state repeats the first bit for bit.
    l_2, g_2 = _loss_and_grads(part, st, params, shape)
    assert torch.equal(l_2, l_p)
    assert all(torch.equal(g_2[k], g_p[k]) for k in g_p)


def test_two_partitioned_steps_from_one_state_are_bit_equal(small_lanes):
    from hyper_ray_tracer_tpu_torch.train import restore, snapshot

    scene, st = _scene("final")
    w, h, spp, depth = 32, 18, 1, 3
    init, step = make_train_step(scene, w, h, depth, partition=True)
    basis = make_basis(scene.camera, w, h)
    pix, sam = pixel_lanes(w, h, spp, "cpu")
    target = torch.zeros((w * h, 3))
    state = init(st)
    start = snapshot(state)
    out = []
    for _ in range(2):
        restore(state, start)
        state, loss = step(state, st, basis, pix, sam, 0, target)
        out.append((loss, {k: p.detach().clone()
                           for k, p in state.params.items()}))
    assert any(step.schedule().decisions)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


def test_partitioned_step_follows_moved_geometry(small_lanes):
    """After an adam step, a cloud sphere moved out of the group's baked
    box into the camera's view: the partitioned loss still equals the
    plain one, because the boxes come from the bound parameters.  With
    the baked boxes it would not (the witness that the case can tell)."""
    scene, st = _scene("final")
    w, h, spp, depth = 32, 18, 1, 3
    init, step = make_train_step(scene, w, h, depth, partition=True)
    basis = make_basis(scene.camera, w, h)
    pix, sam = pixel_lanes(w, h, spp, "cpu")
    target = torch.zeros((w * h, 3))
    state = init(st)
    state, _ = step(state, st, basis, pix, sam, 0, target)
    cloud = st.groups[0]
    k = cloud.start
    with torch.no_grad():  # in front of the camera, far from the cloud
        state.params["geom.p0"][k] = torch.tensor([278.0, 278.0, -400.0])
        state.params["geom.p1"][k] = state.params["geom.p0"][k]
        state.params["geom.radius"][k] = 60.0
    assert not (np.float32(cloud.bmin) <= np.float32([278.0, 278.0, -400.0])
                ).all() or not (np.float32([278.0, 278.0, -400.0])
                                <= np.float32(cloud.bmax)).all()
    part = make_loss_fn(scene, w, h, depth, partition=True)
    plain = make_loss_fn(scene, w, h, depth)
    args = (state.params, st, basis, pix, sam, 0, target)
    with torch.no_grad():
        l_p = part(*args)
        l_0 = plain(*args)
    assert torch.equal(l_p, l_0)
    assert any(part.schedule().decisions)
    # Stale boxes would cull the moved sphere from the lanes that meet it.
    bound = bind_params(st, state.params)
    stale = bound._replace(group_aabbs=st.group_aabbs)
    sched = PartitionSchedule(st.groups)
    with torch.no_grad():
        rad_stale = render_radiance(stale, scene.background, basis, w, h,
                                    pix.reshape(-1), sam.reshape(-1), 0,
                                    depth, schedule=sched)
        rad = render_radiance(bound, scene.background, basis, w, h,
                              pix.reshape(-1), sam.reshape(-1), 0, depth)
    assert not torch.equal(rad_stale, rad)


def test_step_runs_plain_without_parameter_boxes(small_lanes, caplog):
    import logging

    scene, st = _scene("final")
    groups = tuple(g._replace(dynamic_ok=False) for g in st.groups)
    st2 = st._replace(sweep=st.sweep._replace(groups=groups))
    loss_fn = make_loss_fn(scene, 16, 9, 2, partition=True)
    # The port's own logger: a CLI run earlier in the process leaves it
    # at its verbosity's level, above INFO.
    with caplog.at_level(logging.INFO, logger="hyper_ray_tracer_tpu_torch"):
        _loss_and_grads(loss_fn, st2, _fresh_params(st2), (16, 9, 1, 2))
    assert loss_fn.schedule() is None
    assert "runs plain" in caplog.text


# The port against the JAX package's partitioned render (slow: XLA
# compiles the JAX package's compacting renderer).


@pytest.mark.slow
def test_partitioned_render_close_to_jax_partitioned(monkeypatch):
    """The port's partitioned render against the JAX package's at
    tests/test_partition.py's shape, seed and drift bounds (under 2% of
    pixels differ; the L1 drift 5e-3 of the image's).  The port's plain
    render already parts from the JAX package's fixed scan on a few
    lanes under `final`'s 7.0 light (tests/test_torch_render.py; 0.0150
    of the image's L1 here), and its partitioned render equals its plain
    one bit for bit, so the L1 bound is taken on top of that gap."""
    import jax
    import jax.numpy as jnp

    import hyper_ray_tracer_tpu.render as JR
    from hyper_ray_tracer_tpu import build_scene as jax_build_scene
    from hyper_ray_tracer_tpu.camera import make_basis as jax_basis
    from hyper_ray_tracer_tpu_torch.render import trace_paths

    jax.config.update("jax_platforms", "cpu")
    monkeypatch.setattr(JR, "_COMPACT_MIN_BUCKET", 256)
    monkeypatch.setattr(JP, "PART_MIN_LANES", 1024)
    monkeypatch.setattr(P, "PART_MIN_LANES", 1024)
    spp, depth, seed = 4, 6, 5
    jscene = jax_build_scene("final")
    arrays, bvh, mode = JR.prepare_scene(jscene)
    perm = jnp.asarray(JR.block_order(W, H))
    run = JR.make_compacting_renderer(jscene, W, H, depth, mode)
    jbasis = jax_basis(jscene.camera, W, H)
    probe = np.asarray(run(arrays, bvh, jbasis, perm, 0, spp,
                           np.uint32(seed)))  # the fixed scan
    want = np.asarray(run(arrays, bvh, jbasis, perm, 0, spp,
                          np.uint32(seed)))
    (_, (pre, entries)), = run.schedules.items()
    assert any(e is not None and len(e[0]) > 1 for e in entries)
    scene, st = _scene("final")
    pix = torch.from_numpy(np.asarray(perm).astype(np.int64)).repeat(spp)
    sam = torch.arange(spp).repeat_interleave(W * H)
    basis = make_basis(scene.camera, W, H)
    sched = PartitionSchedule(st.groups)
    got = trace_paths(st, scene.background, basis, W, H, pix, sam, seed,
                      depth, schedule=sched)
    plain = trace_paths(st, scene.background, basis, W, H, pix, sam, seed,
                        depth)
    assert any(sched.decisions)
    assert torch.equal(got, plain)
    got = got.reshape(spp, W * H, 3).sum(0).numpy()

    def l1(a, b):
        return np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-6)

    flipped = np.any(got != want, axis=-1)
    assert flipped.mean() < 0.02, f"{flipped.mean():.4f} of pixels differ"
    assert l1(got, want) < l1(got, probe) + 5e-3, (l1(got, want),
                                                   l1(got, probe))
