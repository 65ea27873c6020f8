"""Colored console logging, mirroring the reference's fern setup
(`src/logger.rs:15-56`): colored level + timestamp prefix,
verbosity 0..3 -> WARNING/INFO/DEBUG/TRACE-ish."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[35m",  # magenta (fern uses magenta for trace)
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        level = f"{color}{record.levelname.lower()}{_RESET}"
        ts = self.formatTime(record, "%Y-%m-%d %H:%M:%S")
        return f"{level} [{ts}] {record.getMessage()}"


def init(verbosity: int = 2) -> logging.Logger:
    """logger.rs:45-51 verbosity mapping (3 = most verbose)."""
    level = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG,
             3: logging.DEBUG}.get(verbosity, logging.DEBUG)
    logger = logging.getLogger("hyper_ray_tracer_tpu_torch")
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(_Formatter())
        logger.addHandler(h)
    return logger


def get() -> logging.Logger:
    return logging.getLogger("hyper_ray_tracer_tpu_torch")
