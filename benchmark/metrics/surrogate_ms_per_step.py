"""Device ms a step of the surrogate's forward kernel
(``csrc/surrogate.cu``)."""

from ._layer import ms_per_step


def read(trace):
    return ms_per_step(trace, "surrogate")
