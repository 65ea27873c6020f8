"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its configuration, traffic, limits, generator and metric readers by name
(no test here renders)."""

from __future__ import annotations

import json
import re

import pytest

from benchmarks import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/")
        assert ".." not in word.split("/")
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_entries_have_only_their_keys_and_sound_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/")
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert one_line(c["why"]) and one_line(c["source"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    names = []
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in names and one_line(m["layer"])
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.per_layer(BENCH, cell)
        assert layers
        # a metric's cells report the end-to-end metric it moves
        assert all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    t = spec.traffic(w["traffic"])
    assert hasattr(spec.generator(t["generator"]), "Session")
    lim = spec.limits(cell)
    assert lim["numbers"]
    for m in spec.per_layer(BENCH, cell):
        assert callable(spec.metric_reader(m["name"]))


def test_every_configuration_is_used_and_lists_its_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]


def test_every_limit_lies_between_its_readings():
    for cell in CELLS:
        for name, n in spec.limits(cell)["numbers"].items():
            lower, upper = n.get("lower"), n.get("upper")
            if lower is not None:
                assert n["limit"] > lower, (cell, name)
            if upper is not None:
                assert n["limit"] < upper, (cell, name)
