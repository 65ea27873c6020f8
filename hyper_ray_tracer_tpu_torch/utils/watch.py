"""Watch-mode re-render loop (the JAX package's ``utils/watch.py``; the
headless analogue of the reference viewer's resize-triggered re-render,
application.rs:334-355).

The CLI's ``--watch PARAMS.json`` polls a small JSON file of overrides
and re-renders whenever it changes.  Accepted keys: width, height,
samples, depth, scene, seed, spp_chunk.  Unknown keys, and values of the
wrong type or range (a non-numeric width, an unknown scene), are warned
about and ignored, so an edit never ends a running session.
"""

from __future__ import annotations

import json
import os
import time

from ..models.builders import SCENES

ALLOWED_KEYS = {"width", "height", "samples", "depth", "scene", "seed",
                "spp_chunk"}


def _valid(key, value) -> bool:
    """True when ``value`` is one the CLI's flag ``key`` accepts."""
    if key == "scene":
        return value in SCENES
    if key == "spp_chunk" and value is None:
        return True
    if not isinstance(value, int) or isinstance(value, bool):
        return False
    return value >= 0 if key == "seed" else value >= 1


def load_overrides(path, log=None):
    """Parse the params file into a CLI-override dict.  Returns None on
    unreadable or invalid JSON (a half-written editor save: the caller
    keeps the previous params and retries on the next change)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        if log is not None:
            log.warning("watch: cannot read %s (%s); keeping previous "
                        "params", path, e)
        return None
    if not isinstance(data, dict):
        if log is not None:
            log.warning("watch: %s is not a JSON object; ignoring", path)
        return None
    unknown = sorted(set(data) - ALLOWED_KEYS)
    if unknown and log is not None:
        log.warning("watch: ignoring unknown keys %s (accepted: %s)",
                    unknown, sorted(ALLOWED_KEYS))
    out = {}
    for k, v in data.items():
        if k not in ALLOWED_KEYS:
            continue
        if _valid(k, v):
            out[k] = v
        elif log is not None:
            log.warning("watch: ignoring %s=%r (not a value --%s accepts)",
                        k, v, k.replace("_", "-"))
    return out


def watch_loop(path, on_change, poll_s: float = 0.5, log=None,
               max_iters=None):
    """Poll ``path``'s mtime; on a change, parse it and call
    ``on_change(overrides)``.  A missing file simply waits (create it to
    trigger the first re-render).  ``max_iters`` bounds the number of
    polls for tests; the CLI passes None and exits on Ctrl-C."""
    last = _mtime(path)
    iters = 0
    try:
        while max_iters is None or iters < max_iters:
            iters += 1
            time.sleep(poll_s)
            cur = _mtime(path)
            if cur == last:
                continue
            last = cur
            if cur is None:
                continue
            overrides = load_overrides(path, log=log)
            if overrides is None:
                continue
            on_change(overrides)
    except KeyboardInterrupt:
        if log is not None:
            log.info("watch: stopped")


def _mtime(path):
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return None
