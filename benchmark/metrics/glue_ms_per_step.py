"""Device ms a step of every operation outside the port's own kernel
families: the plain PyTorch of the dycore, sponge, nudging and P3 glue."""

from ._layer import ms_per_step


def read(trace):
    return ms_per_step(trace, "glue")
