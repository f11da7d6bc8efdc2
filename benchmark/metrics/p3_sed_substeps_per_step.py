"""P3 sedimentation sub-steps a step: the program's device counter
``p3.sed_substeps`` (the count its kernels ran, ``utils/profiling.py``)
over the steps.  None where the program keeps no such counter."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    c = profiling.read()["counters"].get("p3.sed_substeps")
    if c is None:
        return None
    return c["total"] / trace.steps
