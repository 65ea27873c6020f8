"""Lanes the trace kernels ran on per camera ray: the port's counters
``K1.lanes``, ``K1b.lanes``, ``K4.lanes`` and ``K5.lanes`` (each launch's
rays) over ``camera_rays``, over the run's process.  None where no
hand kernel launched (the CPU)."""

from benchmarks.program import counter, snapshot

TRACE_KERNELS = ("K1", "K1b", "K4", "K5")


def read(trace):
    snap = snapshot()
    rays = counter(snap, "camera_rays")
    lanes = sum(counter(snap, f"{k}.lanes") for k in TRACE_KERNELS)
    if not rays or not lanes:
        return None
    return lanes / rays
