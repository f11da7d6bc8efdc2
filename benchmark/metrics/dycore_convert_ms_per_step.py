"""Device ms a step of the dycore's conversions between the coupler's
fields and its state: the program's spans ``dycore.to_dynamics`` and
``dycore.to_coupler`` (``utils/profiling.py``), timed by their CUDA
events.  None where the program keeps no such spans."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    spans = profiling.read()["spans"]
    ms = [spans[n]["device_ms"] for n in ("dycore.to_dynamics",
                                          "dycore.to_coupler") if n in spans]
    if not ms or None in ms:
        return None
    return sum(ms) / trace.steps
