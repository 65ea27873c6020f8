"""From a ``torch.profiler`` capture of the traced window to the summary
that the per-layer readers (``metrics/<name>.py``) read.

The arithmetic is that of the repository's ``chip_smoke.py``
``render_profile``, copied: device kernels are the profiler's CUDA
events that are neither a user range nor named as one; a range's device
time is the ``device_time_total`` of its CPU events; the hand kernels,
launched through ctypes, may be linked to no operation, and their
unlinked time goes to the range their wrapper runs in, found by kernel
name.  Busy time is the union of the kernels' intervals, and the span
runs from the first kernel's start to the last one's end.

A train step's backward pass runs on autograd's own threads, outside
every range, so its device time is counted by the thread that launched
each kernel: the profiler links a kernel to the operation that launched
it (by their correlation id), and a kernel whose operation ran on a
thread that opened no range is the backward pass's; so is an unlinked
hand kernel that only a backward pass launches (K2b, K3).
"""

from __future__ import annotations

# The hand kernels by a part of their name, with the range that launches
# them (forward-only kernels of a train step run inside ``forward``).
HAND = {
    "K1": ("sphere_sweep_kernel", "trace"),
    "K1b": ("typed_sweep_kernel", "trace"),
    "K2": ("noise_texture_kernel", "shade"),
    "K4": ("bvh_traverse_kernel", "trace"),
    "K5": ("cluster_sweep_kernel", "trace"),
}
RANGES = ("raygen", "trace", "shade", "compaction", "forward", "backward",
          "optimizer")
# A range inside which another one runs, and the outer one: an unlinked
# hand kernel of ``trace`` also belongs to ``forward`` in a train step.
OUTER = {"trace": "forward", "shade": "forward"}
# Hand kernels that only a backward pass launches: K2b, and K3's three.
BACKWARD_ONLY = ("noise_texture_grad_kernel", "sort_lanes",
                 "combine_levels", "reduce_rows")


def capture(loop, device):
    """Run ``loop`` (which returns its calls' records) under
    ``torch.profiler``, CPU activity and, on a card, CUDA: (its events,
    the records, the traced window's seconds from the first call's start
    to the last one's end, leaving out the profiler's start and stop)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        records = loop()
    return prof.events(), records, records[-1][1] - records[0][0]


def _device_total(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(events, work: dict) -> dict:
    """The summary of one process's traced window.  ``events``: the
    profiler's ``events()``; ``work``: what the window did (camera rays,
    steps, images) as the generator counted it."""
    from torch.autograd import DeviceType

    def is_kernel(e):
        return (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in RANGES)

    kern = [e for e in events if is_kernel(e)]
    iv = [(e.time_range.start, e.time_range.end) for e in kern]
    by_range = dict.fromkeys(RANGES, 0.0)
    seen = dict.fromkeys(RANGES, False)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in by_range:
            by_range[e.name] += _device_total(e)
            seen[e.name] = True
    by_kernel = {h: sum(e.time_range.elapsed_us() for e in kern
                        if sub in e.name) for h, (sub, _) in HAND.items()}
    linked = dict.fromkeys(HAND, 0.0)
    for e in events:
        for k in getattr(e, "kernels", ()):
            for h, (sub, _) in HAND.items():
                if sub in k.name:
                    linked[h] += k.duration
    for h, (_, rng) in HAND.items():
        extra = by_kernel[h] - linked[h]
        if extra > 0 and seen[rng]:
            by_range[rng] += extra
            outer = OUTER.get(rng)
            if outer is not None and seen[outer]:
                by_range[outer] += extra
    by_thread = _by_thread(events, kern)
    nccl = sum(e.time_range.elapsed_us() for e in kern
               if "nccl" in e.name.lower())
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {
        "work": dict(work),
        "n_kernels": len(kern),
        "busy_us": _union_us(iv),
        "span_us": (max(e for _, e in iv) - min(s for s, _ in iv)) if iv
        else 0.0,
        "range_us": {k: v for k, v in by_range.items() if seen[k]},
        "nccl_us": nccl,
        "kernel_us": sum(e.time_range.elapsed_us() for e in kern),
        **by_thread,
        "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "gaps": _idle_gaps(events, sorted(iv)),
    }


def _by_thread(events, kern) -> dict:
    """Device time of the kernels by where they were launched:
    ``linked_us``, those the profiler links to the operation that
    launched them (each to one operation's ``kernels``); ``off_range_us``,
    those whose operation ran on a thread that opened no range, plus the
    unlinked ``BACKWARD_ONLY`` hand kernels (a train step's backward
    pass)."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    range_threads = {e.thread for e in cpu if e.name in RANGES}
    linked = off = 0.0
    linked_bw = 0.0
    for e in cpu:
        for k in getattr(e, "kernels", ()):
            linked += k.duration
            if e.thread not in range_threads:
                off += k.duration
            if any(name in k.name for name in BACKWARD_ONLY):
                linked_bw += k.duration
    all_bw = sum(k.time_range.elapsed_us() for k in kern
                 if any(name in k.name for name in BACKWARD_ONLY))
    off += max(0.0, all_bw - linked_bw)
    return {"linked_us": linked, "off_range_us": off}


def _idle_gaps(events, iv, n: int = 10):
    """The ``n`` longest gaps between device kernels, each named by the
    host event (a range or an operation, the innermost) that was running
    at the gap's middle."""
    from torch.autograd import DeviceType

    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, reverse=True)[:n]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    out = []
    for length, g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner, outer = None, None
        for e in cpu:
            if e.time_range.start <= mid <= e.time_range.end:
                if inner is None or e.time_range.start > inner.time_range.start:
                    inner = e
                if e.name in RANGES and (
                        outer is None
                        or e.time_range.start > outer.time_range.start):
                    outer = e
        label = "host" if inner is None else inner.name
        if outer is not None and outer is not inner:
            label = f"{outer.name}/{label}"
        out.append((label, length))
    return out


def merge(summaries: list) -> dict:
    """Several ranks' summaries as one: sums of work and times, and each
    time's mean over the ranks under ``mean_*``."""
    n = len(summaries)
    first = summaries[0]
    out = dict(first)
    out["ranks"] = n
    for key in ("busy_us", "span_us", "nccl_us", "n_kernels", "kernel_us",
                "linked_us", "off_range_us"):
        out[key] = sum(s[key] for s in summaries)
        out["mean_" + key] = out[key] / n
    out["idle_shares"] = [1.0 - s["busy_us"] / s["span_us"]
                          for s in summaries if s["span_us"] > 0]
    return out
