"""Device ms a train step spends in its ``forward`` range (the hand
kernels of the trace and the noise texture included), per step."""


def read(trace):
    steps = trace["work"].get("steps")
    ms = trace["range_us"].get("forward")
    if not steps or ms is None or not trace["n_kernels"]:
        return None
    return ms / 1e3 / steps
