"""The whole step's share of the card's f32 peak (%): the counted
operations of a step's flux calls (``opt`` algebra) and Kessler step
(``work.kessler_step_ops``, one sub-step) times the steps, over the window
and 67 TFLOP/s.  P3's operations depend on the data and are not counted."""

from .. import work
from ._layer import flux_step, shape


def read(trace):
    if not trace.family_ops("flux") or trace.window_s <= 0.0:
        return None
    ops = flux_step(trace)[1]
    if trace.family_ops("kessler"):
        ops += work.kessler_step_ops(shape(trace))
    peak = work.PEAK_FLOPS[trace.context["dtype"]]
    return 100.0 * ops * trace.steps / trace.window_s / peak
