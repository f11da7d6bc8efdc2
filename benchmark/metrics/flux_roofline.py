"""The flux kernel's share of its roofline (%): the summed least time of a
step's flux calls (bytes or ``opt``-algebra operations, ``work.flux_step``)
times the steps, over the flux launches' device time."""

from ._layer import flux_step, roofline_pct


def read(trace):
    return roofline_pct(trace, "flux", flux_step(trace)[0])
