"""Device ms a step of the dycore's de-densitization, three a step at one
CFL cycle: the program's span ``dycore.prim`` (``utils/profiling.py``),
timed by its CUDA events.  None where the program keeps no such span."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    span = profiling.read()["spans"].get("dycore.prim")
    if span is None or span["device_ms"] is None:
        return None
    return span["device_ms"] / trace.steps
