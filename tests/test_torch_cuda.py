"""The CUDA sphere-sweep kernel against its plain-PyTorch version, on the
card.  Every test here needs a CUDA device and nvcc and skips without
them; on a GPU machine run ``python -m pytest tests/test_torch_cuda.py``.

The kernel performs the plain version's IEEE operations in the same order,
so the two must agree bit for bit, not only within the near-tie rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hyper_ray_tracer_tpu_torch import (  # noqa: E402
    RenderSettings,
    build_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (  # noqa: E402
    sphere_sweep,
    sphere_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    bounce_step,
    init_state,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _rays(scene, st, W, H, dev, bounces=0):
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    state = init_state(make_basis(scene.camera, W, H), W, H, pix,
                       torch.zeros_like(pix), 7)
    for b in range(bounces):
        state = bounce_step(st, scene.background, state, b)
    return state


def _both(st, o, d, time, active):
    args = (*st.spheres, o.contiguous(), d.contiguous(), time.contiguous(),
            active.contiguous())
    t_k, b_k = sphere_sweep(*args)
    torch.cuda.synchronize()
    t_p, b_p = sphere_sweep_plain(*args)
    return t_k, b_k, t_p, b_p


@pytest.mark.parametrize("name", ["random", "three-spheres", "two-spheres",
                                  "sphereflake-small", "sphereflake"])
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_kernel_equals_plain(cuda, name, bounces):
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, cuda)
    W, H = (96, 54) if name == "sphereflake" else (320, 180)
    s = _rays(scene, st, W, H, cuda, bounces)
    t_k, b_k, t_p, b_p = _both(st, s.o, s.d, s.time, s.alive)
    assert torch.equal(b_k, b_p)
    assert torch.equal(t_k, t_p)
    assert (b_k >= 0).any()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4097])
def test_ragged_ray_counts_and_inactive_rays(cuda, n):
    scene = build_scene("random")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 160, 90, cuda)
    idx = torch.randperm(160 * 90, device=cuda)[:n]
    active = torch.rand(n, device=cuda) < 0.6
    t_k, b_k, t_p, b_p = _both(st, s.o[idx], s.d[idx], s.time[idx], active)
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p)
    assert (b_k[~active] == -1).all()
    assert (t_k[~active] == float(np.float32(3.0e38))).all()


def test_single_sphere_and_counter(cuda):
    p0 = torch.tensor([[0.0, 0.0, -5.0]], device=cuda)
    one = torch.ones(1, device=cuda)
    o = torch.zeros(3, 3, device=cuda)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [0.0, 0.0, -2.0]],
                     device=cuda)
    time = torch.zeros(3, device=cuda)
    active = torch.ones(3, dtype=torch.bool, device=cuda)
    before = sphere_sweep.launches
    t, best = sphere_sweep(p0, p0, one * 0, one, one, o, d, time, active)
    assert sphere_sweep.launches == before + 1
    torch.testing.assert_close(t.cpu(), torch.tensor([4.0, 3.0e38, 2.0]))
    assert best.cpu().tolist() == [0, -1, 0]


def test_wrapper_validates_inputs(cuda):
    scene = build_scene("two-spheres")
    st = to_device(scene.arrays, scene.static, cuda)
    s = _rays(scene, st, 16, 9, cuda)
    good = (*st.spheres, s.o, s.d, s.time, s.alive)
    with pytest.raises(TypeError):
        sphere_sweep(*good[:5], s.o.double(), *good[6:])
    with pytest.raises(ValueError, match="contiguous"):
        sphere_sweep(*good[:5], s.o.t().contiguous().t(), *good[6:])
    with pytest.raises(ValueError, match="shape"):
        sphere_sweep(*good[:7], s.time[:-1], s.alive)
    with pytest.raises(ValueError, match="is on cpu"):
        sphere_sweep(*good[:7], s.time.cpu(), s.alive)


def test_render_on_card_matches_cpu(cuda):
    """Only the shading differs between the card and the CPU (ulps of
    sin/cos/acos), so the two images agree closely."""
    scene = build_scene("three-spheres")
    settings = RenderSettings(64, 36, 2, 4)
    before = sphere_sweep.launches
    img_card = render_image(scene, settings, cuda)
    assert sphere_sweep.launches > before
    img_cpu = render_image(scene, settings, "cpu")
    err = np.abs(img_card - img_cpu)
    assert (err <= 1e-4).mean() >= 0.99 and err.mean() < 4e-3
