"""Profiling helpers (the JAX package's ``utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` capture of everything inside
  the block, CPU and (with a card) CUDA activity, written into LOGDIR as
  a Chrome trace that TensorBoard's profiler plugin reads; the CLI's
  ``--profile LOGDIR``.  The hand kernels, launched through ctypes, appear
  in it under their kernel names (CUPTI records every launch on the
  card), though not under the ``record_function`` range that launched
  them.
* ``Timer``: a wall-clock phase timer that waits for the card before it
  reads the clock.
* ``RayStats``: camera-ray accounting, the render's debug log line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (``<host>_<pid>.<time>.pt.trace.json``)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class Timer:
    """Wall-clock phase timer.  ``elapsed(*pending)`` first waits for the
    card when a pending tensor lives there, so the time includes the
    device's work, not only its enqueueing."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def elapsed(self, *pending) -> float:
        for t in pending:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        return time.perf_counter() - self._t0


@dataclasses.dataclass
class RayStats:
    camera_rays: int = 0
    depth: int = 0
    seconds: float = 0.0
    n_devices: int = 1

    @property
    def camera_mrays_per_s(self) -> float:
        return self.camera_rays / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def camera_mrays_per_s_per_chip(self) -> float:
        return self.camera_mrays_per_s / max(self.n_devices, 1)

    def summary(self) -> str:
        return (
            f"{self.camera_rays} camera rays (depth<={self.depth}) in "
            f"{self.seconds:.2f}s = {self.camera_mrays_per_s:.2f} Mrays/s "
            f"({self.camera_mrays_per_s_per_chip:.2f} per chip, "
            f"{self.n_devices} devices)"
        )
