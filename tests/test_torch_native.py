"""The port's own build and binding of the C++ BVH builder
(``hyper_ray_tracer_tpu_torch/utils/native.py``): its trees equal the
NumPy builder's array for array on every scene, ``build_bvh`` takes it by
default, and a missing compiler raises instead of falling back."""

import numpy as np
import pytest

from hyper_ray_tracer_tpu_torch import SCENES, build_scene
from hyper_ray_tracer_tpu_torch.models import bvh_build
from hyper_ray_tracer_tpu_torch.models.bvh_build import _build_numpy, build_bvh
from hyper_ray_tracer_tpu_torch.models.scene import PT_NONE
from hyper_ray_tracer_tpu_torch.utils import native

LEAVES = (1, 4, 8)
# sphereflake's NumPy build takes 0.7-3.2 s a leaf size on the CPU: leaf
# 8 (the cheapest) runs in tier 1, leaves 1 and 4 are slow.
CASES = [pytest.param(name, leaf, marks=pytest.mark.slow)
         if name == "sphereflake" and leaf != 8 else (name, leaf)
         for name in sorted(SCENES) for leaf in LEAVES]


def _real_boxes(name):
    g = build_scene(name).arrays.geom
    real = np.asarray(g.ptype) != PT_NONE
    return np.asarray(g.aabb_min)[real], np.asarray(g.aabb_max)[real]


@pytest.mark.parametrize("name,leaf", CASES)
def test_native_tree_equals_numpy(name, leaf):
    amin, amax = _real_boxes(name)
    got = native.build_bvh_arrays(amin, amax, leaf)
    want = _build_numpy(amin, amax, leaf)
    assert len(got) == len(want) == 6
    for field, a, b in zip(("bounds_min", "bounds_max", "leaf_first",
                            "leaf_count", "skip", "perm"), got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_build_bvh_takes_the_native_builder_by_default(monkeypatch):
    geom = build_scene("final").arrays.geom
    calls = []
    real = native.build_bvh_arrays

    def spy(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(native, "build_bvh_arrays", spy)
    tree, g = build_bvh(geom, leaf_size=4)
    assert calls == [4]
    tree_np, g_np = build_bvh(geom, leaf_size=4, use_native=False)
    assert calls == [4]
    for a, b in zip(tree + g, tree_np + g_np):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_library_is_built_from_the_checkout_into_build_native():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert lib.name.startswith("libhrt_bvh-") and lib.exists()
    assert native.SOURCE.name == "bvh_builder.cpp"
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)
    assert lib == native.library_path()  # keyed by source and flags


def test_missing_compiler_raises_and_names_the_numpy_builder(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setenv("CXX", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    amin, amax = _real_boxes("cornell")
    with pytest.raises(RuntimeError, match="use_native=False"):
        native.build_bvh_arrays(amin, amax, 4)
    geom = build_scene("cornell").arrays.geom
    with pytest.raises(RuntimeError, match="use_native=False"):
        bvh_build.build_bvh(geom, 4)
    # The NumPy builder needs no compiler.
    tree, _ = bvh_build.build_bvh(geom, 4, use_native=False)
    assert tree.skip.shape[0] > 0
