"""Kessler sedimentation sub-cycles a step: the program's device counter
``kessler.subcycles`` (the count its kernel ran, ``utils/profiling.py``)
over the steps.  None where the program keeps no such counter."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    c = profiling.read()["counters"].get("kessler.subcycles")
    if c is None:
        return None
    return c["total"] / trace.steps
