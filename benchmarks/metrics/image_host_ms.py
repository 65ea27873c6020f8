"""Host ms an image spends outside its chunks: the port's spans
``prepare`` (the scene's host arrays, a BVH's build), ``upload`` (their
copy to the card) and ``finish`` (the readback), each opened once an
image, each's mean over its calls after the process's first."""

from benchmarks.program import snapshot, warm_ms


def read(trace):
    snap = snapshot()
    parts = [warm_ms(snap, n) for n in ("prepare", "upload", "finish")]
    if None in parts or not sum(parts):
        return None
    return sum(parts)
