"""The port's copied scene builders give the JAX package's scenes exactly,
and importing the port keeps JAX out of the process."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu.models.builders import SCENES as J_SCENES  # noqa: E402
from hyper_ray_tracer_tpu_torch import SCENES, build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}.")
    else:
        yield prefix.rstrip("."), tree


def test_same_scene_names():
    assert sorted(SCENES) == sorted(J_SCENES)


@pytest.mark.parametrize("name", sorted(J_SCENES))
def test_scene_equals_jax_package(name):
    ref = J_SCENES[name]()
    got = build_scene(name)
    ref_leaves = dict(_leaves(ref.arrays))
    got_leaves = dict(_leaves(got.arrays))
    assert ref_leaves.keys() == got_leaves.keys()
    for k, v in ref_leaves.items():
        g = got_leaves[k]
        assert np.asarray(g).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    assert dataclasses.asdict(got.static) == dataclasses.asdict(ref.static)
    assert dataclasses.asdict(got.camera) == dataclasses.asdict(ref.camera)
    assert got.background == ref.background
    assert got.name == ref.name


@pytest.mark.parametrize("name", ["random", "three-spheres", "final",
                                  "cornell-smoke"])
def test_to_device_carries_every_array(name):
    """to_device turns every array of the JAX package's scene into a CPU
    tensor of the same values (uint32 words widen to int64)."""
    ref = J_SCENES[name]()
    st = to_device(ref.arrays, ref.static, "cpu")
    for (k, v), (k2, t) in zip(_leaves(ref.arrays), _leaves(st.arrays)):
        assert k == k2
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", k
        v = np.asarray(v)
        if v.dtype == np.uint32:
            assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    n = ref.static.n_prims
    np.testing.assert_array_equal(st.spheres.radius.numpy(),
                                  ref.arrays.geom.radius[:n])
    # The typed sweep's fields and plan, the texture tables.
    np.testing.assert_array_equal(st.sweep.prims.rot.numpy(),
                                  ref.arrays.geom.rot[:n])
    rows = st.sweep.plan_rows.numpy()
    assert rows[:, 0].tolist() == [t.start for t in st.sweep.plan]
    assert rows[:, 1].sum() == n
    assert st.tables.perlin_keys == tuple(int(k)
                                          for k in ref.arrays.perlin.keys)
    np.testing.assert_array_equal(st.tables.images.numpy(),
                                  ref.arrays.images)


def test_import_leaves_jax_out():
    code = ("import sys, hyper_ray_tracer_tpu_torch, "
            "hyper_ray_tracer_tpu_torch.__main__, "
            "hyper_ray_tracer_tpu_torch.ops.sphere_sweep, "
            "hyper_ray_tracer_tpu_torch.ops.typed_sweep, "
            "hyper_ray_tracer_tpu_torch.ops.turbulence, "
            "hyper_ray_tracer_tpu_torch.utils.cuda_build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hyper_ray_tracer_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_import_jax():
    pkg = ROOT / "hyper_ray_tracer_tpu_torch"
    for path in list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not mod.startswith(("jax", "hyper_ray_tracer_tpu.")), \
                    f"{path}: {s}"
                assert mod != "hyper_ray_tracer_tpu", f"{path}: {s}"
