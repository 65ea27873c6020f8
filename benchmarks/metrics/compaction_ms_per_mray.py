"""Device ms in the ``compaction`` range of a render (the hand kernels it
launches included) per million camera rays of the traced window."""


def read(trace):
    rays = trace["work"].get("camera_rays")
    ms = trace["range_us"].get("compaction")
    if not rays or ms is None or not trace["n_kernels"]:
        return None
    return ms / 1e3 / (rays / 1e6)
