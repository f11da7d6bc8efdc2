"""Helpers the per-layer metric modules share."""

from __future__ import annotations

from .. import work


def ms_per_step(trace, fam: str):
    """Device milliseconds a step of the family ``fam``; None when no
    operation of it ran in the window."""
    if not trace.family_ops(fam) or not trace.steps:
        return None
    return 1e3 * trace.family_seconds(fam) / trace.steps


def shape(trace):
    g = trace.context["grid"]
    return (g.nens, g.nz, g.ny, g.nx)


def roofline_pct(trace, fam: str, least_s_per_step: float):
    """100 x the steps' least time over the family's device time; None
    when no operation of the family ran."""
    busy = trace.family_seconds(fam)
    if not trace.family_ops(fam) or busy <= 0.0:
        return None
    return 100.0 * trace.steps * least_s_per_step / busy


def flux_step(trace):
    ctx = trace.context
    return work.flux_step(5 + ctx["ntr"], shape(trace),
                          ctx["cfg"]["dycore"].get("ord", 5), ctx["dtype"])
