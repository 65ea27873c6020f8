"""The port's multi-GPU layer (``hyper_ray_tracer_tpu_torch/parallel/``)
on the CPU: the mesh and the launch layout against the JAX package's
``P(spp, rays)`` sharding, the deterministic fold, the image assembly
against the JAX package's ``finish_image``, every rank's shard rendered
in one process and assembled ("virtual shards") against
``render_image``, and one spawn of four ``gloo`` ranks that renders on a
2x2 and a 4x1 mesh, takes sharded gradients and two sharded adam steps,
and times the scaling points, held against the port's single-process
render and gradients and the JAX package's sharded render.

The JAX side is imported inside the tests: the spawned ranks import this
module to find their target and need only torch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

import torch.multiprocessing as mp  # noqa: E402

from hyper_ray_tracer_tpu_torch import build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch import render as R  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.builders import (  # noqa: E402
    sphereflake,
)
from hyper_ray_tracer_tpu_torch.parallel import mesh as M  # noqa: E402
from hyper_ray_tracer_tpu_torch.parallel.collectives import fold  # noqa: E402
from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (  # noqa: E402
    finish_image,
    gather_image,
    make_sharded_loss_fn,
    make_sharded_renderer,
    make_sharded_train_step,
    place_pixels,
    reduce_gradients,
    shard_lanes,
)
from hyper_ray_tracer_tpu_torch.parallel.scaling import (  # noqa: E402
    measure_scaling,
)
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    RenderSettings,
    block_order,
    gamma_image,
    prepare_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    make_loss_fn,
    params_from_jax,
    pixel_lanes,
)

W, H, DEPTH, SPP = 32, 16, 4, 4  # tests/test_sharding.py's shape
WORLD = 4
# The four-rank spawn's scene: the port's render of `cornell` equals the
# JAX package's bit for bit at this shape, so the 2e-6 against the JAX
# package's sharded image measures the sharding alone (`three-spheres`,
# tests/test_sharding.py's scene, parts from it by 2.6e-6 on one pixel
# unsharded: the JAX package's jit rounding, ROADMAP F5).
RANKS_SCENE = "cornell"


def _upload(scene, intersector=None):
    arrays, structure, mode = prepare_scene(scene, intersector)
    return to_device(arrays, scene.static, "cpu", structure), mode


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)])
def test_shard_lanes_match_jax_layout(shape):
    """Mesh rank r = i * n_spp + j holds what the JAX package's
    ``_ids_for_block`` sharded ``P(spp, rays)`` puts on mesh device
    (i, j) of ``make_render_mesh(*shape)``."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from hyper_ray_tracer_tpu.parallel.mesh import (
        AXIS_RAYS,
        AXIS_SPP,
        make_render_mesh,
    )
    from hyper_ray_tracer_tpu.parallel.render_sharded import _ids_for_block

    jmesh = make_render_mesh(*shape)
    sharding = NamedSharding(jmesh, P(AXIS_SPP, AXIS_RAYS))
    sample0, n_samples = 3, 8
    pix, sam = (jax.device_put(a, sharding)
                for a in _ids_for_block(W, H, sample0, n_samples))
    mesh = M.RenderMesh(*shape)
    for r in range(mesh.size):
        i, j = mesh.coords(r)
        dev = jmesh.devices[i, j]
        want = [np.asarray(next(s.data for s in a.addressable_shards
                                if s.device == dev)) for a in (pix, sam)]
        got = shard_lanes(mesh, r, W, H, sample0, n_samples)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)


def test_shards_must_divide_the_launch():
    with pytest.raises(ValueError, match="divisible"):
        shard_lanes(M.RenderMesh(3, 1), 0, W, H, 0, SPP)  # 512 pixels
    with pytest.raises(ValueError, match="divisible"):
        shard_lanes(M.RenderMesh(1, 3), 0, W, H, 0, SPP)  # 4 samples
    with pytest.raises(ValueError, match="outside"):
        M.RenderMesh(2, 2).coords(4)


def test_fold_is_left_to_right_in_rank_order():
    """1e8 + 1 rounds to 1e8 in float32, so these four parts sum to 1,
    0 or 2 by the order of the adds: the fold gives the rank order's
    left-to-right sum, the same on every rank and backend."""
    parts = [torch.tensor([v], dtype=torch.float32)
             for v in (1e8, 1.0, -1e8, 1.0)]
    assert fold(parts).item() == 1.0
    assert fold(parts[::-1]).item() == 0.0
    assert ((parts[0] + parts[1]) + (parts[2] + parts[3])).item() == 0.0
    assert (parts[0] + parts[2] + parts[1] + parts[3]).item() == 2.0


def test_finish_image_equals_jax():
    from hyper_ray_tracer_tpu.parallel.render_sharded import (
        finish_image as j_finish_image,
    )

    acc = np.random.default_rng(0).normal(1.0, 2.0, (W * H, 3))
    acc = acc.astype(np.float32).astype(np.float64)
    got, want = finish_image(acc, SPP, W, H), j_finish_image(acc, SPP, W, H)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_init_distributed_refuses_a_missing_card(monkeypatch):
    """No device asked for and no CUDA: an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_distributed()
    with pytest.raises(ValueError, match="nccl"):
        M.init_distributed("cpu", backend="nccl")


def _virtual_image(scene, W_, H_, spp, depth, shape, intersector=None):
    """Every rank's ``run.local`` sum rendered in this process, each rays
    shard's spp shards folded in rank order and put at its pixels, as
    ``run`` assembles them across ranks."""
    scene_t, mode = _upload(scene, intersector)
    mesh = M.RenderMesh(*shape)
    run = make_sharded_renderer(scene, W_, H_, depth, mesh, mode)
    basis = make_basis(scene.camera, W_, H_)
    order = block_order(W_, H_) if mode == "cluster" else None
    pixels, sums = [], []
    for i in range(mesh.n_rays):
        ranks = [i * mesh.n_spp + j for j in range(mesh.n_spp)]
        sums.append(fold([run.local(scene_t, basis, 0, spp, 0, r)
                          for r in ranks]))
        pixels.append(shard_lanes(mesh, ranks[0], W_, H_, 0, spp,
                                  order)[0][0])
    return place_pixels(W_ * H_, pixels, sums).numpy()


@pytest.mark.parametrize("case", [
    # (scene, W, H, spp, depth, intersector, global chunk in samples)
    ("three-spheres", 32, 16, 4, 4, None, 2),
    # sphereflake(3): 821 spheres in 4 clusters; 80x36 spans 2x2 of
    # block_order's 64x32 blocks (48x24 would fit one: row-major order)
    ("sphereflake3", 80, 36, 2, 3, "cluster", 1),
])
def test_virtual_shards_equal_render_image(case, monkeypatch):
    """A rays mesh renders each pixel's samples as ``render_image`` does,
    in the chunks of the global settings (forced here below the samples:
    a shard of 1/n of the pixels would otherwise fit n times as many), so
    its image is bit-identical; a 2x2 mesh folds two partial sums and
    stays within 2e-6."""
    name, W_, H_, spp, depth, intersector, chunk = case
    monkeypatch.setattr(R, "CHUNK_LANES", chunk * W_ * H_)
    scene = sphereflake(3) if name == "sphereflake3" else build_scene(name)
    ref = render_image(scene, RenderSettings(W_, H_, spp, depth,
                                             intersector=intersector), "cpu")
    for shape in [(4, 1), (2, 1)]:
        img = gamma_image(_virtual_image(scene, W_, H_, spp, depth, shape,
                                         intersector), spp, W_, H_)
        np.testing.assert_array_equal(img, ref, err_msg=str(shape))
    img = finish_image(_virtual_image(scene, W_, H_, spp, depth, (2, 2),
                                      intersector), spp, W_, H_)
    np.testing.assert_allclose(img, ref, rtol=0, atol=2e-6)


def _rank_checks(r, world, init_method, out_dir, jax_params):
    """A rank of the four-rank spawn: renders on a 2x2 mesh (twice) and a
    4x1 mesh, the sharded loss and gradients on the 2x2 mesh from the
    JAX package's parameters, two sharded adam steps, and the scaling
    points; writes what it got to ``out_dir`` for the test to hold."""
    torch.set_num_threads(1)
    rank, _, dev = M.init_distributed("cpu", init_method=init_method,
                                      rank=r, world_size=world)
    try:
        scene = build_scene(RANKS_SCENE)
        scene_t, mode = _upload(scene)
        basis = make_basis(scene.camera, W, H)
        out = {}
        for shape in [(2, 2), (4, 1)]:
            mesh = M.make_render_mesh(*shape)
            run = make_sharded_renderer(scene, W, H, DEPTH, mesh, mode)
            out[f"sum{shape}"] = run(scene_t, basis, 0, SPP, 0).numpy()
        mesh = M.make_render_mesh(2, 2)
        run = make_sharded_renderer(scene, W, H, DEPTH, mesh, mode)
        out["sum(2, 2) again"] = run(scene_t, basis, 0, SPP, 0).numpy()

        pix, sam = pixel_lanes(W, H, SPP, dev)
        target = torch.zeros((W * H, 3))
        params = params_from_jax(jax_params)
        loss_fn = make_sharded_loss_fn(scene, W, H, DEPTH, mesh, mode)
        loss = loss_fn(params, scene_t, basis, pix, sam, 0, target)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        reduce_gradients(params, mesh)
        out["loss"] = loss.detach().numpy()
        for k, p in params.items():
            out[f"grad {k}"] = p.grad.numpy()

        init, step = make_sharded_train_step(scene, W, H, DEPTH, mesh, mode)
        state = init(scene_t)
        for _ in range(2):
            state, step_loss = step(state, scene_t, basis, pix, sam, 0,
                                    target)
        out["step loss"] = step_loss.numpy()
        for k, p in state.params.items():
            out[f"param {k}"] = p.detach().numpy()

        points = measure_scaling(scene, W, H, DEPTH, SPP, reps=1,
                                 device="cpu")
        out["scaling"] = np.array([[p.n_devices, p.seconds, p.mrays_per_s,
                                    p.efficiency] for p in points])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        M.dist.destroy_process_group()


def test_four_gloo_ranks(tmp_path):
    """One spawn of four CPU ranks (gloo, a file rendezvous under
    ``tmp_path``).  The rays-only mesh is byte-equal to ``render_image``;
    the 2x2 mesh is within 2e-6 of it and of the JAX package's
    ``make_pjit_renderer`` + ``gather_image`` on a (2, 2) mesh of its
    virtual CPU devices (as tests/test_sharding.py holds JAX to itself),
    and bit-equal run to run; sharded gradients equal the unsharded
    port's within rtol 1e-4, atol 1e-6 (tests/test_sharding.py's bound);
    after two sharded adam steps every rank holds the same parameters,
    bit for bit; every rank gets the same scaling points."""
    import jax

    from hyper_ray_tracer_tpu import build_scene as j_build_scene
    from hyper_ray_tracer_tpu.camera import make_basis as j_make_basis
    from hyper_ray_tracer_tpu.parallel.mesh import make_render_mesh
    from hyper_ray_tracer_tpu.parallel.render_sharded import (
        gather_image as j_gather_image,
    )
    from hyper_ray_tracer_tpu.parallel.render_sharded import (
        make_pjit_renderer,
    )
    from hyper_ray_tracer_tpu.render import prepare_scene as j_prepare_scene
    from hyper_ray_tracer_tpu.train import extract_params

    j_scene = j_build_scene(RANKS_SCENE)
    j_arrays, j_bvh, j_mode = j_prepare_scene(j_scene)
    jax_params = {k: np.asarray(v)
                  for k, v in extract_params(j_arrays).items()}
    ranks = mp.spawn(_rank_checks, nprocs=WORLD, join=False,
                     args=(WORLD, f"file://{tmp_path}/rendezvous",
                           str(tmp_path), jax_params))

    # While the ranks run: the JAX package's sharded image and the port's
    # single-process render and gradients.
    jrun = make_pjit_renderer(j_scene, W, H, DEPTH, make_render_mesh(2, 2),
                              j_mode)
    j_img = j_gather_image(jrun(j_arrays, j_bvh,
                                j_make_basis(j_scene.camera, W, H),
                                np.int32(0), SPP, 0), SPP, W, H)
    jax.clear_caches()
    scene = build_scene(RANKS_SCENE)
    ref = render_image(scene, RenderSettings(W, H, SPP, DEPTH), "cpu")
    scene_t, mode = _upload(scene)
    params = params_from_jax(jax_params)
    loss = make_loss_fn(scene, W, H, DEPTH, mode)(
        params, scene_t, make_basis(scene.camera, W, H),
        *pixel_lanes(W, H, SPP, "cpu"), 0, torch.zeros((W * H, 3)))
    loss.backward()

    while not ranks.join():
        pass
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    for g in got[1:]:  # every rank holds the same results
        assert g.keys() == got[0].keys()
        for k in g:
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
    g = got[0]
    np.testing.assert_array_equal(gamma_image(g["sum(4, 1)"], SPP, W, H),
                                  ref)
    img = gather_image(torch.from_numpy(g["sum(2, 2)"]), SPP, W, H)
    np.testing.assert_array_equal(img, finish_image(
        g["sum(2, 2)"].astype(np.float64), SPP, W, H))
    np.testing.assert_allclose(img, ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(img, j_img, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(g["sum(2, 2)"], g["sum(2, 2) again"])

    np.testing.assert_allclose(g["loss"], loss.item(), rtol=1e-4,
                               atol=1e-6)
    for k, p in params.items():
        want = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(g[f"grad {k}"], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert any(np.any(g[f"grad {k}"] != 0) for k in params)
    moved = [k for k in params
             if not np.array_equal(g[f"param {k}"], jax_params[k])]
    assert moved, "two sharded steps moved no parameter"
    np.testing.assert_array_equal(g["scaling"][:, 0], [1, 2, 4])
    assert np.all(g["scaling"][:, 1:3] > 0)
