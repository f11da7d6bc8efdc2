"""Host ms a step inside the program's four module spans (``dycore.step``,
``kessler.step`` or ``p3.step``, ``sponge.step``, ``nudge.step``;
``utils/profiling.py``): how long the host takes to issue a step's work,
an upper bound since it is taken under the profiler.  None where the
program keeps no such spans."""

MODULES = ("dycore.step", "kessler.step", "p3.step", "sponge.step",
           "nudge.step")


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    spans = profiling.read()["spans"]
    ms = [spans[n]["host_ms"] for n in MODULES if n in spans]
    if not ms:
        return None
    return sum(ms) / trace.steps
