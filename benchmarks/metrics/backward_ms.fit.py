"""Device ms a train step spends in its backward pass, per step: the
kernels launched from autograd's threads (those that open no range),
and the hand kernels only a backward pass launches (``trace.py``)."""


def read(trace):
    steps = trace["work"].get("steps")
    if not steps or not trace["n_kernels"] or not trace["linked_us"]:
        return None
    us = trace["off_range_us"]
    return us / 1e3 / steps if us > 0 else None
