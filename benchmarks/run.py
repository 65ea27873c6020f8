"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run builds the cell's program objects and warms up the shapes its
traffic uses (set-up, ``setup_s``: from the process's start to the first
timed call), then drives the traffic in a closed loop for ``--seconds``
of the host's clock, each call run to its end.  With ``--trace 1`` the
first ``trace_seconds`` of the window (the traffic file's) run under
``torch.profiler``, and the per-layer metrics are read from that capture.
Once the window has closed and the device's peak memory is read, the
program's state is freed and the outputs that the window produced are
held against the plain reference (``reference/``): ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``check``, each compared number beside its
limit (also the last lines of standard error).  The run exits non-zero
and prints no result when the card is missing or too few, or when a
module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "hyper_ray_tracer_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmarks.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Not used by the benchmark's own runs: the lower-precision control in
    # the program's place, or a fault planted under the timed path (a fit
    # takes ``<fault>@window``: in the window's steps only).
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    return ap.parse_args(argv)


def main(argv=None, root=None, require_card: bool = True, out=None) -> int:
    """Run a cell; returns the exit code.  ``root``: the checkout
    (``BENCHMARK.json`` and ``benchmarks/``); ``require_card=False`` (the
    tests) skips the look for a card and runs on the CPU."""
    t_enter = process_age()
    a = parse(argv)
    from pathlib import Path

    from . import spec

    root = Path(root) if root is not None else spec.ROOT
    out = out or sys.stdout
    bench = spec.benchmark(root)
    cell = spec.cell(bench, a.workload)
    chips = int(cell["chips"])

    import torch

    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")

    cfg = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root)
    lim = spec.limits(cell["name"], root)
    gen = spec.generator(traffic["generator"])
    ctx = dict(device=device, seed=a.seed, chips=chips, config=cfg,
               traffic=traffic, limits=lim, control=a.control,
               fault=a.fault, seconds=a.seconds)
    session = gen.Session(ctx)
    session.warm()
    setup_s = process_age() - (0.0 if require_card else t_enter)

    records, summaries = [], None
    trace_s = float(traffic.get("trace_seconds", a.seconds))
    t0 = time.perf_counter()
    i = 0
    if a.trace:
        summaries, traced = session.traced(
            lambda: _loop(session, records, time.perf_counter(), trace_s, 0)
            or records[:])
        i = len(records)
    if i == 0 or records[-1][1] - t0 < a.seconds or _pending(session):
        _loop(session, records, t0, a.seconds, i, finish=True)
    window_s = records[-1][1] - t0
    walls = sorted(e - s for s, e, _ in records)
    print(f"{len(walls)} calls in {window_s!r} s; a call's wall min "
          f"{walls[0]!r}, median {walls[len(walls) // 2]!r}, max "
          f"{walls[-1]!r}", file=sys.stderr)
    metrics = session.end_to_end(records, window_s)
    session.free()
    device_info = session.device_info()
    if a.trace:
        trace = summaries
        metrics = {}
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.metric_reader(m["name"], root)(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = trace["mean_busy_us"] / 1e6
        device_info["window_s"] = traced
    else:
        wanted = {m["name"]: m["unit"]
                  for m in spec.end_to_end(bench, cell["name"])}
        metrics = {k: {"value": v, "unit": wanted[k]}
                   for k, v in metrics.items() if k in wanted}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        missing = set(wanted) - set(metrics)
        if missing:
            print(f"the cell reports no {sorted(missing)}", file=sys.stderr)
            return 3

    numbers, failed = session.check()
    correct = failed == 0 and all(v["value"] <= v["limit"]
                                  for v in numbers.values())
    for v in numbers.values():  # JSON has no NaN or infinity
        if not math.isfinite(v["value"]):
            v["value"] = sys.float_info.max
    bad = forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if a.trace:
        result["breakdown"] = {
            "device_ops": [[n, v / 1e6] for n, v in trace["top_ops"]],
            "idle_gaps": [[n, v / 1e6] for n, v in trace["gaps"]]}
    result["check"] = numbers
    for name, v in numbers.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def _pending(session) -> bool:
    """Whether the session still waits for a call it checks (a fit's
    drawn window step)."""
    return bool(getattr(session, "pending", lambda: False)())


def _loop(session, records, t0, seconds, i, finish=False):
    """Closed loop: call after call, each to its end, until ``seconds``
    of the window have passed (with ``finish``, and the call the session
    checks has run); ``records`` gets (start, end, work)."""
    while True:
        start = time.perf_counter()
        work = session.run(i)
        end = time.perf_counter()
        records.append((start, end, work))
        i += 1
        if end - t0 >= seconds and not (finish and _pending(session)):
            return


if __name__ == "__main__":
    sys.exit(main())
