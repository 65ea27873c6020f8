"""Faults planted under the timed path, to see ``correct`` come out false.

The benchmark's own runs plant none; ``--fault <name>`` (and the tests
under ``benchmarks/tests``) do.  Each is a context manager that patches
the port's functions for the calls made inside it:

* ``unchanged``: a render's accumulator gets no sample, a train step's
  update leaves the parameters as they were;
* ``half``: half of each chunk's lanes (a train step's pixels) left out,
  the mean taken over the rest;
* ``altered``: each lane's radiance altered where it is produced (1e-3
  added to its red channel);
* ``no_exchange``: a sharded render's gather between ranks left out (each
  rank keeps its own lanes, the others' stay zero).
"""

from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half", "altered", "no_exchange")


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half_lanes(rad):
    n = rad.shape[0]
    keep = n - n // 2
    return rad[:keep].repeat(2, *([1] * (rad.dim() - 1)))[:n]


def render_fault(name):
    """The fault ``name`` under ``render_image`` (None: no fault)."""
    if name is None:
        return contextlib.nullcontext()
    import torch

    from hyper_ray_tracer_tpu_torch import render as R

    if name == "unchanged":
        orig = R.accumulate_samples

        def unchanged(acc, *a, **k):
            yield from orig(torch.zeros_like(acc), *a, **k)
        return _patched(R, "accumulate_samples", unchanged)
    if name in ("half", "altered"):
        orig = R.trace_paths

        def broken(*a, **k):
            rad = orig(*a, **k)
            if name == "half":
                return _half_lanes(rad)
            return rad + rad.new_tensor([1e-3, 0.0, 0.0])
        return _patched(R, "trace_paths", broken)
    raise ValueError(f"no render fault {name!r}")


def fit_fault(name, state):
    """The fault ``name`` under one train step of ``state`` (None: no
    fault)."""
    if name is None:
        return contextlib.nullcontext()
    from hyper_ray_tracer_tpu_torch import train as T

    if name == "unchanged":
        return _patched(state.optimizer, "step", lambda *a, **k: None)
    if name in ("half", "altered"):
        orig = T.render_radiance

        def broken(*a, **k):
            rad = orig(*a, **k)
            if name == "half":
                return _half_lanes(rad)
            return rad + rad.new_tensor([1e-3, 0.0, 0.0])
        return _patched(T, "render_radiance", broken)
    raise ValueError(f"no fit fault {name!r}")


def sharded_fault(name):
    """The fault ``name`` under the sharded renderer's ``run`` (None: no
    fault), the same on every rank."""
    if name is None:
        return contextlib.nullcontext()
    import torch

    from hyper_ray_tracer_tpu_torch.parallel import render_sharded as S

    if name == "no_exchange":
        orig = S.all_gather

        def own_only(t, group=None):
            parts = orig(t, group)  # every rank still takes part
            me = torch.distributed.get_rank(group)
            return [p if i == me else torch.zeros_like(p)
                    for i, p in enumerate(parts)]
        return _patched(S, "all_gather", own_only)
    if name == "unchanged":
        orig_acc = S.accumulate_samples

        def unchanged(acc, *a, **k):
            yield from orig_acc(torch.zeros_like(acc), *a, **k)
        return _patched(S, "accumulate_samples", unchanged)
    return render_fault(name)
