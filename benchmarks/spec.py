"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

Every lookup is under a checkout ``root`` (the directory that holds
``BENCHMARK.json``), so that a cell, a traffic mix, a configuration or a
per-layer metric is added by adding its files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "benchmarks" / "traffic" / f"{_name('traffic', name)}.json"
    return json.loads(path.read_text())


def limits(cell_name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "benchmarks" / "limits" / f"{_name('cell', cell_name)}.json"
    return json.loads(path.read_text())


def _load(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str):
    """The generator module of a traffic kind: ``generators/<kind>.py``,
    imported as a module of the package (its ranks, if it spawns any,
    import it by that name)."""
    return importlib.import_module(f"benchmarks.generators.{_name('generator', kind)}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(trace)`` of a per-layer metric: ``metrics/<name>.py``, or,
    where there is none, the reader of the name without its last
    ``.suffix`` (``idle_share.render`` falls back to ``idle_share.py``),
    so that one quantity split by cells has one reader."""
    folder = Path(root) / "benchmarks" / "metrics"
    stem = _name("metric", name)
    while not (folder / f"{stem}.py").is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    return _load(folder / f"{stem}.py",
                 "benchmarks_metric_" + stem.replace(".", "_")).read


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a cell's traced run reports: those that list
    it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
