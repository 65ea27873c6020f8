"""Device kernels the profiler saw per train step of the traced window."""


def read(trace):
    steps = trace["work"].get("steps")
    if not steps or not trace["n_kernels"]:
        return None
    return trace["n_kernels"] / steps
