"""FCT's share of its roofline (%): the bytes bound of a step's FCT calls
(``work.fct_step``) times the steps, over their device time."""

from .. import work
from ._layer import roofline_pct, shape


def read(trace):
    least = work.fct_step(trace.context["ntr"], shape(trace),
                          trace.context["dtype"])
    return roofline_pct(trace, "fct", least)
