"""The port's adam train step against the JAX package's
``make_train_step``, the parameter plumbing (``bind_params`` and the
sweeps' records after an in-place optimizer step) and the train CLI's
command line, on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene as j_build_scene  # noqa: E402
from hyper_ray_tracer_tpu.camera import make_basis as j_make_basis  # noqa: E402
from hyper_ray_tracer_tpu.models.scene import (  # noqa: E402
    SceneBuilder as JSceneBuilder,
)
from hyper_ray_tracer_tpu.render import prepare_scene  # noqa: E402
from hyper_ray_tracer_tpu.train import PARAM_PATHS as J_PARAM_PATHS  # noqa: E402
from hyper_ray_tracer_tpu.train import (  # noqa: E402
    make_train_step as j_make_train_step,
)
from hyper_ray_tracer_tpu_torch import build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import CameraConfig  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (  # noqa: E402
    device_sphere_records,
    sphere_records,
)
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import typed_records  # noqa: E402
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    prepare_scene as port_prepare_scene,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import (  # noqa: E402
    bind_params,
    to_device,
)
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    PARAM_PATHS,
    extract_params,
    main,
    make_loss_fn,
    make_train_step,
    merge_params,
    params_from_jax,
    pixel_lanes,
    restore,
    snapshot,
)

W, H, SPP, DEPTH = 16, 9, 1, 3


def _moving_spheres():
    """three-spheres with one moving metal sphere under the gradient sky:
    a scene with motion whose geometry gradients are not zero (`random`'s
    flat sky and solid textures leave every geometry gradient at 0 in
    both packages).  Its one plan tile has motion, so every sphere's p1
    takes a gradient in the first step and is traced lerped after it."""
    b = JSceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0,
             b.lambertian(b.solid((0.8, 0.8, 0.0))))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.solid((0.1, 0.2, 0.5))))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.1))
    b.moving_sphere((-0.9, -0.2, -0.6), (-0.8, -0.1, -0.6), 0.0, 1.0, 0.3,
                    b.metal((0.7, 0.7, 0.9), 0.0))
    cam = CameraConfig((-2.0, 2.0, 1.0), (0.0, 0.0, -1.0), 90.0, 0.0,
                       focus_dist=1.0)
    s = b.finalize(cam, (0.7, 0.8, 1.0), "moving-spheres")
    s.background = None
    return s


def _two_steps_against_jax(scene, intersector, w, h, spp, depth):
    """Two adam steps of the port and of ``make_train_step`` from the
    scene's parameters in ``intersector``'s mode: (the port's losses,
    the JAX package's, the port's state, the JAX package's, the port's
    starting parameters)."""
    target = np.random.default_rng(1).uniform(0, 1, (w * h, 3)).astype(
        np.float32)
    arrays, bvh, mode = prepare_scene(scene, intersector)
    init_j, step_j = j_make_train_step(scene, w, h, depth, mode)
    state_j = init_j(arrays)
    step_j = jax.jit(step_j)
    pix_j = jnp.broadcast_to(jnp.arange(w * h, dtype=jnp.int32),
                             (spp, w * h))
    sam_j = jnp.broadcast_to(jnp.arange(spp, dtype=jnp.int32)[:, None],
                             (spp, w * h))
    losses_j = []
    for _ in range(2):
        state_j, loss = step_j(state_j, arrays, bvh,
                               j_make_basis(scene.camera, w, h), pix_j,
                               sam_j, np.uint32(0), jnp.asarray(target))
        losses_j.append(float(loss))

    arrays_t, bvh_t, _ = port_prepare_scene(scene, intersector)
    st = to_device(arrays_t, scene.static, "cpu", bvh_t)
    init, step = make_train_step(scene, w, h, depth, mode)
    state = init(st)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    pix, sam = pixel_lanes(w, h, spp, "cpu")
    losses = []
    for _ in range(2):
        state, loss = step(state, st, make_basis(scene.camera, w, h), pix,
                           sam, 0, torch.from_numpy(target))
        losses.append(float(loss))
    return losses, losses_j, state, state_j, start


def _assert_steps_match(losses, losses_j, state, state_j):
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    for k, ref in state_j.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   np.asarray(ref), rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["three-spheres", "moving-spheres"])
def test_two_adam_steps_match_jax(name):
    """Two steps of the port's adam (torch.optim.Adam, optax.adam's
    betas and eps) against two of ``make_train_step``: the losses, and
    every parameter after the second step.  Adam's first steps move a
    coordinate by ~lr * sign(g) whatever |g|, so the parameters differ by
    the steps' rounding, not by the gradients': measured <= 3.4e-6 at lr
    1e-2, bound 1e-4.  The second step traces the geometry the first one
    moved (spheres' p1 too, in the scene with motion)."""
    scene = _moving_spheres() if name == "moving-spheres" \
        else j_build_scene(name)
    losses, losses_j, state, state_j, start = _two_steps_against_jax(
        scene, "sweep", W, H, SPP, DEPTH)
    _assert_steps_match(losses, losses_j, state, state_j)
    assert not torch.equal(state.params["geom.p0"], start["geom.p0"])
    moved_p1 = not torch.equal(state.params["geom.p1"], start["geom.p1"])
    assert moved_p1 == (name == "moving-spheres")


@pytest.mark.parametrize("name", ["three-spheres", "sphereflake-small"])
def test_two_adam_steps_match_jax_through_the_bvh(name):
    """The same two steps in BVH mode, at tests/test_torch_grad.py's
    16x9x2 d4: the second step's loss traces the geometry the first step
    moved, so it holds K4's leaf records to the parameters (records left
    at the build's values pass the first step and fail the second).
    `sphereflake-small`'s flat sky leaves its geometry where it is."""
    scene = j_build_scene(name)
    losses, losses_j, state, state_j, start = _two_steps_against_jax(
        scene, "bvh", 16, 9, 2, 4)
    _assert_steps_match(losses, losses_j, state, state_j)
    moved = not torch.equal(state.params["geom.p0"], start["geom.p0"])
    assert moved == (name == "three-spheres")


def test_bind_params_rebuilds_the_bvh_leaves_not_the_tree():
    """After an in-place adam step, ``bind_params`` in BVH mode equals a
    ``to_device`` of the moved geometry record for record (K4's leaf
    records and the plain walk's fields), and the tree, its node records
    and depth are the ones built."""
    scene = build_scene("three-spheres")
    arrays, bvh, _ = port_prepare_scene(scene, "bvh", 2)
    st = to_device(arrays, scene.static, "cpu", bvh)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    bound = bind_params(st, params)
    moved = arrays._replace(geom=arrays.geom._replace(
        **{k: params[f"geom.{k}"].detach().numpy() for k in ("p0", "p1",
                                                            "radius")}))
    want = to_device(moved, scene.static, "cpu", bvh).bvh
    for field in ("geo", "aux", "tag", "xf", "shutter"):
        # Bit for bit: a record's slots hold ints (and NaN words) too.
        got, ref = getattr(bound.bvh, field), getattr(want, field)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            field
    for got, ref in zip(bound.bvh.prims, want.prims):
        assert torch.equal(got, ref)
    assert not torch.equal(bound.bvh.geo, st.bvh.geo)
    assert bound.bvh.nodes is st.bvh.nodes and bound.bvh.tree is st.bvh.tree
    assert bound.bvh.depth == st.bvh.depth and bound.sweep is None
    assert bound.fpack.requires_grad


def test_records_follow_an_in_place_adam_step():
    """An in-place ``Adam.step`` on the geometry changes what the sweeps
    trace next: ``bind_params`` rebuilds the typed sweep's records equal
    to ``typed_records`` of the new values on the scene's own plan, and
    the sphere sweep's cached records (keyed on the tensors' version
    counters) are packed anew."""
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, "cpu")
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    geom = [params["geom.p0"], params["geom.p1"], st.arrays.geom.time0,
            st.arrays.geom.time1, params["geom.radius"]]
    first = device_sphere_records(*geom)
    before = bind_params(st, params).sweep
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    after = bind_params(st, params).sweep
    n = scene.static.n_prims
    host = st.host_geom._replace(
        **{k: params[f"geom.{k}"].detach().numpy() for k in ("p0", "p1",
                                                            "radius")})
    want = typed_records(host, after.plan, n)
    got = (after.plan_rows, after.geo, after.aux, after.xf, after.shutter)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert after.plan == before.plan == st.sweep.plan
    assert not torch.equal(after.geo, before.geo)
    torch.testing.assert_close(after.prims.p0, params["geom.p0"][:n],
                               rtol=0, atol=0, check_stride=False)
    second = device_sphere_records(*geom)
    assert not np.array_equal(second.geo.numpy(), first.geo.numpy())
    np.testing.assert_array_equal(second.geo.numpy(), sphere_records(
        *(x.detach().numpy() for x in geom)).geo)


def test_bind_params_follows_the_plan_and_the_graph():
    """The sphere fields are views of the parameters, p1 is p0 in a scene
    planned without motion, and the shade rows carry the graph."""
    scene = build_scene("three-spheres")
    st = to_device(scene.arrays, scene.static, "cpu")
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    bound = bind_params(st, params)
    assert bound.spheres.p0._base is params["geom.p0"]
    assert bound.spheres.p1._base is params["geom.p0"]  # no motion tile
    assert bound.fpack.requires_grad and bound.tables.images is \
        params["images.None"]
    scene = build_scene("random")  # one plan tile, with motion
    st = to_device(scene.arrays, scene.static, "cpu")
    params = {k: v.detach().clone() for k, v in
              extract_params(st.arrays).items()}
    assert bind_params(st, params).spheres.p1._base is params["geom.p1"]


def test_params_carry_the_jax_package_keys():
    scene = j_build_scene("earth")
    assert PARAM_PATHS == J_PARAM_PATHS
    params = params_from_jax({k: np.asarray(v) for k, v in
                              extract_params(scene.arrays).items()})
    assert list(params) == [f"{g}.{f}" for g, f in J_PARAM_PATHS]
    assert all(p.requires_grad and p.is_leaf for p in params.values())
    st = to_device(scene.arrays, scene.static, "cpu")
    merged = merge_params(st.arrays, params)
    assert merged.images is params["images.None"]
    assert merged.geom.p0 is params["geom.p0"]


def test_silhouette_is_not_ported_yet():
    """The name is this test's history: ``silhouette=True`` raised until
    the edge term was ported (ROADMAP queue 1 item 6).  It now builds the
    correction, which adds exactly 0 to the loss's forward value
    (tests/test_torch_edges.py holds its gradients to the JAX
    package's); a scene uploaded in another mode than the loss's is
    refused."""
    scene = build_scene("one-sphere")
    st = to_device(scene.arrays, scene.static, "cpu")
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    pix, sam = pixel_lanes(8, 6, 1, "cpu")
    args = (params, st, make_basis(scene.camera, 8, 6), pix, sam, 0,
            torch.full((48, 3), 0.25))
    with_edges = make_loss_fn(scene, 8, 6, 2, silhouette=True)(*args)
    assert torch.equal(with_edges, make_loss_fn(scene, 8, 6, 2)(*args))
    arrays, bvh, _ = port_prepare_scene(scene, "bvh")
    with pytest.raises(ValueError, match="bvh mode"):
        make_loss_fn(scene, 8, 6, 2)(params, to_device(
            arrays, scene.static, "cpu", bvh), *args[2:])


def test_train_main_on_cpu(capsys):
    """The CLI's JSON line at a small shape; depth above 16 switches
    remat on, as bench_grad.py does."""
    assert main(["--cpu", "three-spheres", "8", "6", "1", "3",
                 "--steps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "three-spheres_fwd_bwd_camera_mrays_per_s_depth3"
    assert line["value"] > 0 and np.isfinite(line["loss"])
    assert line["remat"] is False
    assert main(["--cpu", "one-sphere", "4", "3", "1", "17",
                 "--steps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["remat"] is True and np.isfinite(line["loss"])


def test_train_main_through_the_bvh_with_the_silhouette(capsys):
    """``--intersector bvh --silhouette``: the scene uploaded in BVH mode
    through ``prepare_scene``, the correction in the loss; auto still
    takes the sweeps below 30,000 primitives."""
    assert main(["--cpu", "one-sphere", "8", "6", "1", "2", "--steps",
                 "1", "--intersector", "bvh", "--silhouette"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["intersector"] == "bvh" and line["silhouette"] is True
    assert np.isfinite(line["loss"]) and line["value"] > 0
    assert main(["--cpu", "one-sphere", "4", "3", "1", "2", "--steps",
                 "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["intersector"] == "sweep" and line["silhouette"] is False


def test_train_main_times_every_step_from_the_initial_state(capsys):
    """As bench_grad.py does, every step starts from the initial state:
    ``--steps 1`` and ``--steps 3`` print the same loss, the first step's,
    which is ``loss_fn`` at the initial parameters."""
    w, h, depth = 8, 6, 3
    losses = []
    for steps in ("1", "3"):
        assert main(["--cpu", "three-spheres", str(w), str(h), "1",
                     str(depth), "--steps", steps]) == 0
        losses.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])["loss"])
    scene = build_scene("three-spheres")
    st = to_device(scene.arrays, scene.static, "cpu")
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    pix, sam = pixel_lanes(w, h, 1, "cpu")
    loss = make_loss_fn(scene, w, h, depth)(
        params, st, make_basis(scene.camera, w, h), pix, sam, 0,
        torch.zeros((w * h, 3)))
    assert losses[0] == losses[1] == loss.item()


def test_snapshot_and_restore_repeat_a_step():
    """After two adam steps, ``restore`` puts back the parameters and an
    empty optimizer state: the next step repeats the first one bit for
    bit (its loss and the parameters it leaves)."""
    scene = build_scene("three-spheres")
    st = to_device(scene.arrays, scene.static, "cpu")
    init, step = make_train_step(scene, W, H, DEPTH)
    state = init(st)
    snap = snapshot(state)
    args = (st, make_basis(scene.camera, W, H), *pixel_lanes(W, H, SPP,
                                                              "cpu"),
            0, torch.full((W * H, 3), 0.25))
    state, first = step(state, *args)
    after_first = {k: p.detach().clone() for k, p in state.params.items()}
    state, _ = step(state, *args)
    restore(state, snap)
    for k, p in state.params.items():
        assert torch.equal(p, snap["params"][k]) and p.grad is None, k
    assert not state.optimizer.state
    state, again = step(state, *args)
    assert torch.equal(again, first)
    for k, p in state.params.items():
        assert torch.equal(p, after_first[k]), k


def test_train_main_without_cuda_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="--cpu"):
        main(["three-spheres", "8", "6", "1", "2"])
