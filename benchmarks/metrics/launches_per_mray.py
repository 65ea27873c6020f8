"""Device kernels the profiler saw per million camera rays of the traced
window (host launch overhead grows with it)."""


def read(trace):
    rays = trace["work"].get("camera_rays")
    if not rays or not trace["n_kernels"]:
        return None
    return trace["n_kernels"] / (rays / 1e6)
