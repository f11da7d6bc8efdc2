"""95th percentile of the window's step times (ms), each step's device time
between CUDA events recorded before and after its four modules."""

from ..trace import p95


def read(trace):
    return p95(trace.step_ms)
