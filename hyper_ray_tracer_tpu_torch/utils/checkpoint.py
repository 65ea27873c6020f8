"""Render checkpoint / resume (the JAX package's ``utils/checkpoint.py``).

Samples accumulate chunk by chunk in one float32 tensor on the device,
and ``render.render_image`` persists that running (radiance sum, samples
done) state at its snapshot cadence, so that a long render survives
preemption and resumes bit-identically to an uninterrupted render with
the same chunk boundaries.  The file is the JAX package's npz layout
(``acc``, ``samples_done``, ``meta`` as UTF-8 JSON bytes), written to a
temporary file beside the target and renamed over it, so a reader never
sees a half-written checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np


def save_state(path: str, acc: np.ndarray, samples_done: int,
               meta: dict) -> None:
    """Atomically persist the accumulator (write a temporary file, then
    rename it over ``path``)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(
                f, acc=acc, samples_done=np.int64(samples_done),
                meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> Optional[Tuple[np.ndarray, int, dict]]:
    """(acc, samples_done, meta) of the checkpoint at ``path``, or None
    when there is none."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        acc = z["acc"]
        samples_done = int(z["samples_done"])
        meta = json.loads(z["meta"].tobytes().decode())
    return acc, samples_done, meta


def meta_matches(meta: dict, expected: dict) -> bool:
    """True when ``meta`` holds every key of ``expected`` with its value."""
    return all(meta.get(k) == v for k, v in expected.items())
