"""Host ms a train step spends in ``bind_params`` (the parameters' copy
to the host and the records rebuilt from it, once every forward): the
port's span ``bind_params``, its mean over its calls after the
process's first."""

from benchmarks.program import snapshot, warm_ms


def read(trace):
    ms = warm_ms(snapshot(), "bind_params")
    return ms if ms else None
