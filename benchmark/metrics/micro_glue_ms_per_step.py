"""Device ms a step of the microphysics outside its own kernels: the
program's span ``kessler.step`` or ``p3.step`` (``utils/profiling.py``),
timed by its CUDA events, less the device time of the Kessler or P3 kernel
family.  None where the program keeps no such span."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    spans = profiling.read()["spans"]
    for name, fam in (("kessler.step", "kessler"), ("p3.step", "p3")):
        span = spans.get(name)
        if span is not None and span["device_ms"] is not None:
            kernels_ms = 1e3 * trace.family_seconds(fam)
            return (span["device_ms"] - kernels_ms) / trace.steps
    return None
