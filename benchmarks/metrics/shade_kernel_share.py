"""The share of the lanes entering ``render.shade_hits`` that the fused
shading kernel K6 shaded: the port's counters ``K6.lanes`` over
``shade.lanes``, over the run's process.  None where the program counts
no shaded lanes (a program without the counter) or K6 never launched
(the CPU)."""

from benchmarks.program import counter, snapshot


def read(trace):
    snap = snapshot()
    lanes, fused = counter(snap, "shade.lanes"), counter(snap, "K6.lanes")
    if not lanes or not fused:
        return None
    return fused / lanes
