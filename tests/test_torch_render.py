"""The port's wavefront render against the JAX package's fixed scan, its
own uncompacted loop, the committed goldens, and its CLI."""

from pathlib import Path

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
from hyper_ray_tracer_tpu.render import (  # noqa: E402
    make_ray_colorer,
    prepare_scene,
)
from hyper_ray_tracer_tpu_torch import (  # noqa: E402
    SCENES,
    RenderSettings,
    build_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch.__main__ import main  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.scene import PT_SPHERE  # noqa: E402
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    bounce_step,
    init_state,
    spp_per_chunk,
    trace_paths,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402

GOLDEN = Path(__file__).parent / "golden"
W, H, SPP, DEPTH = 32, 18, 2, 4


def _lanes():
    pix = np.tile(np.arange(W * H), SPP)
    smp = np.repeat(np.arange(SPP), W * H)
    return pix, smp


def _port_radiance(scene, pix, smp, seed=0, depth=DEPTH):
    st = to_device(scene.arrays, scene.static, "cpu")
    return trace_paths(st, scene.background, make_basis(scene.camera, W, H),
                       W, H, torch.from_numpy(pix), torch.from_numpy(smp),
                       seed, depth)


# name: (per-lane tolerance, least share of lit lanes).  The Cornell boxes
# and simple-light are dark at 2 spp: few paths reach their small lights.
RADIANCE_CASES = {
    "random": (1e-4, 0.5),
    "three-spheres": (1e-4, 0.5),
    "earth": (1e-4, 0.5),
    "cornell": (1e-4, 0.005),
    "cornell-smoke": (1e-4, 0.005),
    "simple-light": (1e-4, 0.005),
    "final": (1e-4, 0.02),
    # The marble texture, 0.5 (1 + sin(z + 10 turb(4 p))), amplifies the
    # hit point's ulp-level difference (XLA and torch round the camera
    # rays differently) by |d marble / d p| ~ 1e2-1e3 on the r = 1000
    # ground: ~11% of lanes differ by more than 1e-4, 0.3% by more than
    # 1e-2, with mean |diff| ~8e-4.
    "two-perlin-spheres": (1e-2, 0.5),
}


@pytest.mark.parametrize("name", sorted(RADIANCE_CASES))
def test_radiance_matches_jax_fixed_scan(name):
    lane_tol, lit = RADIANCE_CASES[name]
    scene = j_build_scene(name)
    arrays, bvh, mode = prepare_scene(scene, "sweep")
    colorer = make_ray_colorer(scene, W, H, DEPTH, mode,
                               differentiable=False)
    pix, smp = _lanes()
    ref = np.asarray(jax.jit(colorer)(
        arrays, bvh, j_make_basis(scene.camera, W, H),
        jnp.asarray(pix, jnp.int32), jnp.asarray(smp, jnp.int32),
        jnp.uint32(0)))
    got = _port_radiance(scene, pix, smp).numpy()
    diff = np.abs(got - ref)
    lane_ok = (diff <= lane_tol).all(-1)
    assert lane_ok.mean() >= 0.99, f"lanes within {lane_tol}: " \
        f"{lane_ok.mean()}"
    # A lane whose path diverged (a free-flight or winner decision taken
    # the other way on an ulp) differs by a whole MC sample.  At most 0.5%
    # of lanes may; `final` has 2 of 1,152, each off by several units
    # under its 7.0 light, so its mean is taken over the other lanes.
    diverged = (diff > 1e-2).any(-1)
    assert diverged.mean() <= 0.005, f"{diverged.sum()} diverged lanes"
    kept = ~diverged if name == "final" else np.ones_like(diverged)
    assert diff[kept].mean() < 4e-3, f"mean |diff| {diff[kept].mean()}"
    assert (ref.sum(-1) > 0).mean() > lit  # lit lanes, not an empty image


@pytest.mark.parametrize("name", ["random", "three-spheres", "final"])
def test_compaction_is_exact(name):
    """Compacting dead lanes changes no lane's radiance: the compacted
    trace equals a fixed-width loop over all lanes bit for bit."""
    scene = build_scene(name)
    pix, smp = _lanes()
    depth = 6
    got = _port_radiance(scene, pix, smp, seed=5, depth=depth)
    st = to_device(scene.arrays, scene.static, "cpu")
    state = init_state(make_basis(scene.camera, W, H), W, H,
                       torch.from_numpy(pix), torch.from_numpy(smp), 5)
    alive_counts = []
    for b in range(depth):
        state = bounce_step(st, scene.background, state, b)
        alive_counts.append(int(state.alive.sum()))
    assert alive_counts[-1] < alive_counts[0] < pix.size  # lanes did die
    assert torch.equal(got, state.radiance)


def test_chunking_does_not_change_the_image():
    scene = build_scene("three-spheres")
    a = render_image(scene, RenderSettings(W, H, 3, 3, spp_chunk=1), "cpu")
    b = render_image(scene, RenderSettings(W, H, 3, 3, spp_chunk=2), "cpu")
    c = render_image(scene, RenderSettings(W, H, 3, 3), "cpu")
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(a, c, atol=1e-6)
    assert a.shape == (H, W, 3) and a.dtype == np.float32
    assert np.isfinite(a).all() and a.max() > 0.1


def test_spp_per_chunk():
    assert spp_per_chunk(RenderSettings(1280, 720, 100, 10)) == 9
    assert spp_per_chunk(RenderSettings(16, 16, 4, 10)) == 4
    assert spp_per_chunk(RenderSettings(16, 16, 4, 10, spp_chunk=3)) == 3
    assert spp_per_chunk(RenderSettings(16, 16, 4, 10, spp_chunk=64)) == 4


@pytest.mark.parametrize("name", sorted(SCENES))
def test_every_scene_renders(name):
    """Every scene renders; sphere-only ones trace through the sphere
    sweep, the others through the typed sweep."""
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, "cpu")
    kinds = set(scene.arrays.geom.ptype[:scene.static.n_prims].tolist())
    assert st.sphere_only == (kinds == {PT_SPHERE}
                              and not scene.static.has_media
                              and not scene.static.has_ray_xform)
    img = render_image(scene, RenderSettings(8, 6, 1, 2), "cpu")
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert img.min() >= 0


def test_cli_renders_png_on_cpu(tmp_path):
    out = tmp_path / "img.png"
    assert main(["--cpu", "--width", "32", "--height", "18", "--samples",
                 "2", "--depth", "3", "--scene", "three-spheres",
                 "--output", str(out)]) == 0
    data = out.read_bytes()
    assert data.startswith(b"\x89PNG\r\n\x1a\n") and len(data) > 100
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (32, 18)


def test_cli_without_cuda_refuses_to_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="--cpu"):
        main(["--width", "8", "--height", "8", "--samples", "1",
              "--output", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


# scene, spp, depth of the committed 160x90 goldens (tests/test_golden.py).
GOLDEN_CASES = [("three-spheres", 4, 8), ("two-spheres", 4, 8),
                ("random", 2, 8), ("sphereflake-small", 4, 8),
                ("two-perlin-spheres", 4, 8), ("earth", 4, 8),
                ("simple-light", 4, 8), ("cornell", 4, 8),
                ("cornell-smoke", 4, 8), ("final", 1, 5)]


@pytest.mark.slow
@pytest.mark.parametrize("name,spp,depth", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_image_on_cpu(name, spp, depth):
    golden = np.load(GOLDEN / f"{name}_160x90_{spp}spp_d{depth}.npy")
    img = render_image(build_scene(name),
                       RenderSettings(160, 90, spp, depth), "cpu")
    err = np.abs(img - golden)
    # The bounds of tests/test_golden.py:58-61.
    assert float(np.median(err)) < 1e-3, f"median err {np.median(err):.3e}"
    assert float(err.mean()) < 4e-3, f"mean err {err.mean():.3e}"
    assert float(np.mean(err > 3e-2)) < 0.02, (
        f"outlier fraction {np.mean(err > 3e-2):.4f}")
