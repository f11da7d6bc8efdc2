"""Launches a step of the surrogate kernel's general (tiled) form: the
program's traced counter ``surrogate_forward.general_launches``
(``utils/profiling.py``) over the steps.  0 where only the fixed form ran
(``surrogate_forward.fixed_launches``); any other reading means the model
fell to the slow form.  None where the program counts neither form."""

FORMS = ("surrogate_forward.fixed_launches",
         "surrogate_forward.general_launches")


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    counters = profiling.read()["counters"]
    if not any(name in counters for name in FORMS):
        return None
    general = counters.get(FORMS[1], {"total": 0})["total"]
    return general / trace.steps
