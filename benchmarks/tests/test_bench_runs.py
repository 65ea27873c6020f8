"""The harness end to end at tiny sizes on the CPU, with the port's plain
paths in place of its kernels: the result line, correctness against the
reference, the lower-precision control and the planted faults, a cell
and a metric added as files only, and the modules a run loads."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from benchmarks import spec
from benchmarks.tests.conftest import run_cell, tiny_root

RENDER = {"width": 48, "height": 27, "samples": 8, "depth": 6}
FIT = {"width": 24, "height": 16, "spp": 2, "depth": 4}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("root"), RENDER, FIT)


@pytest.mark.parametrize("cell", ["render.final.cli", "fit.random"])
def test_sound_run_is_correct_and_prints_the_contract_line(root, cell):
    rc, line = run_cell(root, "--workload", cell, "--seed", "4294967311",
                        "--seconds", "0.1")
    assert rc == 0
    assert list(line) == KEYS + ["check"]
    assert line["correct"] is True and line["failed"] == 0
    e2e = {m["name"] for m in spec.end_to_end(spec.benchmark(root), cell)}
    assert set(line["metrics"]) == e2e
    for v in line["check"].values():
        assert v["value"] <= v["limit"]


def test_traced_line_adds_breakdown(root):
    rc, line = run_cell(root, "--workload", "fit.random", "--seed", "5",
                        "--seconds", "0.1", "--trace", "1")
    assert rc == 0
    assert list(line) == KEYS + ["breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,how", [
    ("render.final.cli", ("--control", "bf16")),
    ("render.final.cli", ("--fault", "unchanged")),
    ("render.final.cli", ("--fault", "half")),
    ("render.final.cli", ("--fault", "altered")),
    ("fit.random", ("--control", "ref_bf16")),
    ("fit.random", ("--fault", "unchanged")),
    ("fit.random", ("--fault", "half")),
    ("fit.random", ("--fault", "altered")),
])
def test_control_and_faults_come_out_not_correct(root, cell, how):
    rc, line = run_cell(root, "--workload", cell, "--seed", "21",
                        "--seconds", "0.1", *how)
    assert rc == 0
    assert line["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_in_the_window_alone_fails_the_window_step(root, fault):
    """A fault planted in the window's steps only: the set-up's steps
    still agree with the reference, the window's checked step does not."""
    rc, line = run_cell(root, "--workload", "fit.random", "--seed", "22",
                        "--seconds", "0.1", "--fault", fault + "@window")
    assert rc == 0 and line["correct"] is False
    failing = {k for k, v in line["check"].items() if v["value"] > v["limit"]}
    assert failing and all(k.startswith("window_") for k in failing)


def test_window_runs_on_until_its_drawn_step_has_run(root):
    """A drawn step past the window's seconds (``check_share`` 10 of the
    steps a 0.2 s window holds) still runs, in the window, and is
    checked."""
    bench = spec.benchmark(root)
    t = dict(spec.traffic("tiny_fit_960x540x8_d8", root), check_share=10.0)
    (root / "benchmarks/traffic/tiny_fit_late.json").write_text(json.dumps(t))
    bench["workloads"].append({"name": "fit.random.late", "config": "random",
                               "traffic": "tiny_fit_late", "chips": 1,
                               "why": "a late drawn step"})
    for m in bench["end_to_end"]:
        if "fit.random" in m.get("workloads", ()):
            m["workloads"].append("fit.random.late")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmarks/limits/fit.random.late.json").write_text(
        json.dumps(spec.limits("fit.random", root)))
    rc, line = run_cell(root, "--workload", "fit.random.late", "--seed",
                        "23", "--seconds", "0.2")
    assert rc == 0 and line["correct"] is True
    assert "window_update_norm_gap" in line["check"]


def test_reference_in_bfloat16_fails_the_render_check(root):
    bench = spec.benchmark(root)
    bench["workloads"].append({"name": "render.small.tiny",
                               "config": "sphereflake_small",
                               "traffic": "tiny_cli", "chips": 1,
                               "why": "small"})
    _add_small_config(root, bench)
    rc, line = run_cell(root, "--workload", "render.small.tiny", "--seed",
                        "8", "--seconds", "0.1", "--control", "ref_bf16")
    assert rc == 0 and line["correct"] is False


def _add_small_config(root, bench):
    cfg = json.loads((spec.ROOT / "benchmarks/configs/sphereflake.json"
                      ).read_text())
    cfg.update(name="sphereflake_small", scene="sphereflake-small")
    (root / "benchmarks/configs/sphereflake_small.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "sphereflake_small",
                             "source": "test",
                             "file": "benchmarks/configs/"
                                     "sphereflake_small.json",
                             "reduced": [],
                             "why": "a tiny sphereflake for tests"})
    lim = spec.limits("render.sphereflake.cli")
    (root / "benchmarks/limits/render.small.tiny.json").write_text(
        json.dumps(lim))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_added_cell_and_metric_are_found_and_run(root):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and entries only, no file of the harness edited."""
    bench = spec.benchmark(root)
    t = dict(spec.traffic("cli"), **RENDER)
    t.update(samples=4, trace_seconds=0.1)
    (root / "benchmarks/traffic/small_bvh.json").write_text(json.dumps(
        dict(t, intersector="bvh")))
    (root / "benchmarks/metrics/images_traced.render.py").write_text(
        textwrap.dedent('''
        def read(trace):
            return trace["work"].get("images")
        '''))
    bench["workloads"].append({"name": "render.small.tiny",
                               "config": "sphereflake_small",
                               "traffic": "small_bvh", "chips": 1,
                               "why": "small, through the BVH"})
    bench["end_to_end"][0].setdefault("workloads", []).append(
        "render.small.tiny")
    bench["per_layer"].append({"name": "images_traced.render", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry", "moves": "render_mrays_s",
                               "workloads": ["render.small.tiny"]})
    _add_small_config(root, bench)
    rc, line = run_cell(root, "--workload", "render.small.tiny", "--seed",
                        "9", "--seconds", "0.1", "--trace", "1")
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["images_traced.render"]["value"] >= 1
    rc, line = run_cell(root, "--workload", "render.small.tiny", "--seed",
                        "9", "--seconds", "0.1")
    assert rc == 0 and set(line["metrics"]) == {"render_mrays_s", "setup_s"}


FORBIDDEN = ("jax", "jaxlib", "flax", "hyper_ray_tracer_tpu")


def test_a_run_loads_no_jax_module(root):
    code = textwrap.dedent(f"""
        import io, sys
        from benchmarks import run
        rc = run.main(["--workload", "fit.random", "--seed", "3",
                       "--seconds", "0.1"], root={str(root)!r},
                      require_card=False, out=io.StringIO())
        bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
        print(rc, bad, "hyper_ray_tracer_tpu_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split()[-3:] == ["0", "[]", "True"]


def test_reference_loads_nothing_of_the_port():
    code = textwrap.dedent("""
        import sys, types
        import numpy as np, torch
        from benchmarks.reference.tracer import Reference, pixel_sums
        f = np.float32
        geom = types.SimpleNamespace(
            ptype=np.int32([0, 0]), stable_id=np.int32([0, 1]),
            p0=f([[0, 0, -1], [0, -100.5, -1]]), p1=f([[0, 0, -1],
            [0, -100.5, -1]]), radius=f([0.5, 100]), axis=np.int32([0, 0]),
            time0=f([0, 0]), time1=f([1, 1]), neg_inv_density=f([0, 0]),
            material=np.int32([0, 1]), rot=np.tile(np.eye(3, dtype=f),
            (2, 1, 1)), trans=np.zeros((2, 3), f))
        mats = types.SimpleNamespace(mtype=np.int32([0, 1]),
            texture=np.int32([0, 0]), albedo=f([[0, 0, 0], [.8, .8, .8]]),
            fuzz=f([0, .1]), ior=f([0, 0]))
        texs = types.SimpleNamespace(ttype=np.int32([0]),
            color1=f([[.5, .5, .5]]), color2=np.zeros((1, 3), f),
            scale=f([0]), image_id=np.int32([0]))
        perlin = types.SimpleNamespace(vectors=np.zeros((256, 3), f),
            perm_x=np.arange(256), perm_y=np.arange(256),
            perm_z=np.arange(256))
        arrays = types.SimpleNamespace(geom=geom, materials=mats,
            textures=texs, perlin=perlin, images=np.zeros((1, 1, 1, 3), f),
            image_wh=np.int32([[1, 1]]))
        cam = types.SimpleNamespace(look_from=(0, 0, 0),
            look_at=(0, 0, -1), fov=90.0, aperture=0.0, focus_dist=1.0,
            time0=0.0, time1=1.0)
        ref = Reference(arrays, cam, None, "cpu")
        acc = pixel_sums(ref, 8, 6, torch.arange(48), 2, 1, 4)
        assert torch.isfinite(acc).all() and acc.sum() > 0
        from benchmarks.reference.tracer import for_scene
        assert for_scene("final", "cpu").n == 1409
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not tops & {"hyper_ray_tracer_tpu_torch", *FORBIDDEN}


@pytest.mark.parametrize("name", ["final", "random", "sphereflake-small"])
def test_reference_builds_the_scene_the_port_builds(name):
    """The reference's own build of a scene (``reference/builders.py``)
    gives the arrays the port's ``build_scene`` gives, field by field."""
    import numpy as np

    from benchmarks.reference.builders import build_scene as ref_build
    from hyper_ray_tracer_tpu_torch import build_scene

    def fields(node, pre=""):
        if hasattr(node, "_fields"):
            for f in node._fields:
                yield from fields(getattr(node, f), f"{pre}.{f}")
        else:
            yield pre, np.asarray(node)

    ref, port = dict(fields(ref_build(name).arrays)), dict(
        fields(build_scene(name).arrays))
    assert ref.keys() == port.keys()
    for k in ref:
        assert ref[k].dtype == port[k].dtype, k
        np.testing.assert_array_equal(ref[k], port[k], err_msg=k)


@pytest.mark.cuda
def test_render_cell_on_the_card_at_a_small_size(tmp_path, cuda_device):
    from benchmarks import run
    import io
    root = tiny_root(tmp_path, {"width": 160, "height": 90, "samples": 16,
                                "depth": 10}, FIT)
    out = io.StringIO()
    rc = run.main(["--workload", "render.final.cli", "--seed", "3",
                   "--seconds", "1"], root=root, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("no_exchange", False)])
def test_sharded_cell_on_four_gloo_ranks(tmp_path, fault, correct):
    """The four-rank cell on the CPU (gloo), sound and with the exchange
    between ranks left out."""
    root = tiny_root(tmp_path, {"width": 32, "height": 18, "samples": 4,
                                "depth": 6}, FIT)
    # The cell, added as entries only (its files are in the benchmark).
    bench = spec.benchmark(root)
    t = dict(spec.traffic("cli_x4"), width=32, height=18, samples=4,
             depth=6)
    (root / "benchmarks/traffic/tiny_cli_x4.json").write_text(json.dumps(t))
    bench["workloads"].append({"name": "render.final.cli.x4",
                               "config": "final", "traffic": "tiny_cli_x4",
                               "chips": 4, "why": "four ranks"})
    bench["end_to_end"].append({"name": "sharded_render_mrays_s",
                                "unit": "Mrays/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["render.final.cli.x4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    args = ["--workload", "render.final.cli.x4", "--seed", "6",
            "--seconds", "0.1"] + (["--fault", fault] if fault else [])
    rc, line = run_cell(root, *args)
    assert rc == 0 and line["correct"] is correct
    assert set(line["metrics"]) == {"sharded_render_mrays_s", "setup_s"}


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, or on a machine with no card, a run exits non-zero and prints
    no result."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmarks.run",
                          "--workload", "render.final.cli", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
