"""The port's tracing: spans and counters in one registry, and the CLI's
profile capture.

* ``span(name)``: a context manager (or a function decorator) around one
  piece of work.  Under a profiler it opens
  ``torch.profiler.record_function(name)``, so that the profile holds the
  span on the same timeline as the device's kernels, nested in the span
  that caused it (a render's spans inside its ``render_image``, a step's
  inside its ``train_step``); always, it adds its host duration to the
  registry's total for ``name`` (calls and ns).
* ``count(name, n=1)``: adds ``n`` to the counter ``name``;
  ``counter(name)`` reads one.
* ``host_sync(x)``: returns ``x``, the result of an operation that made
  the host wait for the card, and counts it in ``syncs``.  Every such
  operation of the port passes its result through it.
* ``snapshot()``: a copy of the counters and the span totals;
  ``since(before)``: what was counted after an earlier snapshot;
  ``reset()``: clears both.
* ``trace(logdir)``: a ``torch.profiler`` capture of everything inside
  the block, CPU and (with a card) CUDA activity, written into LOGDIR as
  a Chrome trace that TensorBoard's profiler plugin reads; the CLI's
  ``--profile LOGDIR``.  The hand kernels appear in it under their kernel
  names, and their launches in the spans ``K1`` ... ``K6``.  The profiler
  links a kernel only to the operator whose call launched it: K6
  launches inside an operator of its own (``ops/shade.py``) and is
  linked, through it, to the ``shade`` span; a launch from plain ctypes
  (K1 ... K5) is linked to nothing, whichever CUDA runtime its library
  uses.

Spans and counters are always on, with no switch.  With no profiler
active a span costs the query whether one is (``record_function`` itself
costs some 13 us even then, as much as a few eager tensor operations)
and two reads of the clock, and a counter adds a number the host already
holds (a tensor's ``shape[0]``, a sync that has just happened), so
neither launches a kernel nor waits for the card.  Counters count on the
CPU too, where no operation waits: ``syncs`` there counts the places that
would.

Where they are opened and counted (the benchmark's readers,
``benchmarks/metrics/``, take ratios of them over a run's process).
Spans:

* ``render_image`` (``render.render_image``, one image) and inside it
  ``prepare`` (the scene's host arrays, ``render.prepare_scene``: a
  BVH's build), ``upload`` (their copy to the card,
  ``scene_tensors.to_device``), a chunk's layers ``raygen``, ``trace``,
  ``shade`` and ``compaction`` (``render.trace_paths``), in
  ``compaction`` the partition's ``partition_mask`` and
  ``partition_sort`` (``render.PartitionSchedule.lanes``), ``snapshot``
  (the checkpoint and preview writes) and ``finish`` (the readback);
* ``train_step`` (``train.train_step_of``'s step) and inside it
  ``forward`` (there ``bind_params`` and ``silhouette``), ``backward``
  and ``optimizer``;
* ``K1``, ``K1b``, ``K2``, ``K2b``, ``K3``, ``K4``, ``K5``, ``K6``: the
  host side of each hand-kernel launch (``cuda_build.launch``);
* ``all_gather`` and ``fold`` (``parallel/collectives.py``).

Counters:

* ``<K>.launches`` and ``<K>.lanes``: each hand kernel's launches and
  the lanes (rays) of each (``cuda_build.launch``); ``K1.partitioned``,
  ``K1b.partitioned``, ``K1b.bf16``, ``K2.saves``: the launches of a
  partitioned, bf16 or saving form (the kernel's wrapper);
* ``shade.lanes``: the lanes of every ``render.shade_hits`` call, on
  either of its paths (K6's own in ``K6.lanes``);
* ``camera_rays`` (``render.accumulate_samples``, a chunk at a time),
  ``images`` (``render.render_image``), ``steps`` (the train step);
* ``syncs`` (``host_sync``): compaction's ``nonzero``, the partition
  probe's ``bincount`` and copy, the readback and snapshots,
  ``bind_params``' copy of the geometry, and every copy of a host array
  or constant to the card.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled  # this thread's state


class SpanTotal(NamedTuple):
    count: int  # calls
    ns: int  # host nanoseconds over them
    first_ns: int  # of which the first call's (a process's cold one)


_lock = threading.Lock()  # autograd's threads launch kernels too
_counters: dict = {}
_spans: dict = {}  # name -> [calls, ns, first call's ns]


class span:
    """``with span(name): ...`` or ``@span(name)``: the block (each call)
    in ``record_function(name)`` under a profiler, its host time added to
    ``name``'s total."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name) if _profiling() else None
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            total = _spans.get(self.name)
            if total is None:
                _spans[self.name] = [1, ns, ns]
            else:
                total[0] += 1
                total[1] += ns
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` (0 when nothing was counted)."""
    return _counters.get(name, 0)


def host_sync(x):
    """``x``, counted in ``syncs``: the result of an operation that made
    the host wait for the card (a copy to or from the host, ``nonzero``,
    ``bincount`` without an upper bound, ``item``)."""
    count("syncs")
    return x


def snapshot() -> dict:
    """{"counters": {name: int}, "spans": {name: SpanTotal}}, a copy.
    A span's first call is kept apart (``first_ns``): it pays what a
    process pays once (a card's context, the allocator's first blocks,
    a kernel's or the native BVH code's compile nested in it), which a mean
    over calls may leave out."""
    with _lock:
        return {"counters": dict(_counters),
                "spans": {k: SpanTotal(*v) for k, v in _spans.items()}}


def since(before: dict) -> dict:
    """``snapshot()`` less ``before`` (an earlier snapshot): what was
    counted and spent in between; names that did not move are left out.
    A span's ``first_ns`` is its first call's where that call came in
    between, else 0."""
    now = snapshot()
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in now["counters"].items()}
    spans = {}
    for k, v in now["spans"].items():
        b = before["spans"].get(k)
        spans[k] = v if b is None else SpanTotal(v.count - b.count,
                                                 v.ns - b.ns, 0)
    return {"counters": {k: v for k, v in counters.items() if v},
            "spans": {k: v for k, v in spans.items() if v.count}}


def reset() -> None:
    """Clear every counter and span total."""
    with _lock:
        _counters.clear()
        _spans.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (``<host>_<pid>.<time>.pt.trace.json``)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
