"""Device ms a step of FCT (``fct_mult`` and ``fct_scale_div``)."""

from ._layer import ms_per_step


def read(trace):
    return ms_per_step(trace, "fct")
