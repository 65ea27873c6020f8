"""Places where the host waited for the card (the port's counter
``syncs``) per million camera rays (``camera_rays``), over the run's
process."""

from benchmarks.program import counter, snapshot


def read(trace):
    snap = snapshot()
    rays, syncs = counter(snap, "camera_rays"), counter(snap, "syncs")
    if not rays or not syncs:
        return None
    return syncs / (rays / 1e6)
