"""Device ms a step of the direction-flux kernel (``csrc/direction_fluxes*``)."""

from ._layer import ms_per_step


def read(trace):
    return ms_per_step(trace, "flux")
