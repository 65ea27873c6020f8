"""Helpers of the benchmark's own tests: a checkout root in a temporary
directory that holds ``BENCHMARK.json`` and the benchmark's data files,
with the code folders linked, so that a test can add cells, traffic and
metrics as new files and run them at a tiny size on the CPU."""

from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmarks import run, spec

CODE = ("generators", "reference")
DATA = ("configs", "traffic", "limits", "metrics")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on a GPU machine: "
                    "python -m pytest -m cuda benchmarks/tests)")
    return torch.device("cuda", 0)


def tiny_root(tmp: Path, render=None, fit=None) -> Path:
    """A root with the repository's BENCHMARK.json and data files, each
    cell's traffic replaced by a tiny copy (``render`` / ``fit``: the
    sizes to put in)."""
    root = Path(tmp)
    (root / "benchmarks").mkdir(parents=True)
    for d in CODE:
        (root / "benchmarks" / d).symlink_to(spec.ROOT / "benchmarks" / d)
    for d in DATA:
        shutil.copytree(spec.ROOT / "benchmarks" / d, root / "benchmarks" / d)
    bench = spec.benchmark()
    for w in bench["workloads"]:
        t = spec.traffic(w["traffic"])
        sizes = render if t["generator"] == "render" else fit
        if sizes:
            t.update(sizes, trace_seconds=0.1)
            name = "tiny_" + w["traffic"]
            (root / "benchmarks" / "traffic" / f"{name}.json").write_text(
                json.dumps(t))
            w["traffic"] = name
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root, *args):
    """``benchmarks.run`` on the CPU: (exit code, the result line's
    object or None)."""
    out = io.StringIO()
    rc = run.main(list(args), root=root, require_card=False, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
