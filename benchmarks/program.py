"""What the program under test counted in this process: the port's
spans and counters (``hyper_ray_tracer_tpu_torch.utils.profiling``),
for the per-layer readers of ``source`` ``program_span`` and
``program_counter``.

They read the totals over the whole process, set-up, window and traced
part together, and take ratios of them, so that the window's edges do
not matter; a span's mean leaves out its first call, the process's
cold one.  A program without the registry (an older commit) gives
None, and its readers report nothing.
"""

from __future__ import annotations


def snapshot():
    """The port's ``profiling.snapshot()``: {"counters": {name: int},
    "spans": {name: (calls, ns, the first call's ns)}}, or None where
    the port has none."""
    try:
        from hyper_ray_tracer_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    return snapshot()


def counter(snap, name: str) -> int:
    return 0 if snap is None else snap["counters"].get(name, 0)


def warm_ms(snap, name: str):
    """The host ms of one call of the span ``name``, the mean over its
    calls after the process's first (``first_ns``: a card's context, the
    allocator's first blocks, a compile nested in it, which ``setup_s``
    pays); None before a second call."""
    total = None if snap is None else snap["spans"].get(name)
    if total is None or total[0] < 2:
        return None
    return (total[1] - total[2]) / (total[0] - 1) / 1e6
