"""Device ms a step of the surrogate module outside its forward kernel:
the program's span ``surrogate.step`` (``utils/profiling.py``), timed by
its CUDA events, less the device time of the surrogate family.  None where
the program keeps no such span."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    span = profiling.read()["spans"].get("surrogate.step")
    if span is None or span["device_ms"] is None:
        return None
    kernels_ms = 1e3 * trace.family_seconds("surrogate")
    return (span["device_ms"] - kernels_ms) / trace.steps
