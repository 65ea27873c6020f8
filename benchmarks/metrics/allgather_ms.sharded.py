"""Device ms of the NCCL kernels (the all-gather of the ranks' sums) per
image, the mean over the ranks."""


def read(trace):
    images = trace["work"].get("images")
    if not images or trace.get("ranks", 1) < 2 or not trace["nccl_us"]:
        return None
    return trace["mean_nccl_us"] / 1e3 / images
