"""The device's idle share over the traced window: 1 - busy / span of
its kernels, the mean over the ranks where there are several."""


def read(trace):
    shares = trace.get("idle_shares")
    if not shares:
        return None
    return sum(shares) / len(shares)
