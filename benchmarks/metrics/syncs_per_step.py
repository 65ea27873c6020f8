"""Places where the host waited for the card (the port's counter
``syncs``) per train step (``steps``), over the run's process."""

from benchmarks.program import counter, snapshot


def read(trace):
    snap = snapshot()
    steps, syncs = counter(snap, "steps"), counter(snap, "syncs")
    if not steps or not syncs:
        return None
    return syncs / steps
