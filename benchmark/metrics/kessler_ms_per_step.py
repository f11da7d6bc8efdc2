"""Device ms a step of the Kessler kernels (``csrc/kessler.cu``)."""

from ._layer import ms_per_step


def read(trace):
    return ms_per_step(trace, "kessler")
