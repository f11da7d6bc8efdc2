"""Device ms a step of the top sponge and the column nudging: the
program's spans ``sponge.step`` and ``nudge.step``
(``utils/profiling.py``), timed by their CUDA events.  None where the
program keeps no such spans."""


def read(trace):
    from miniweatherml_tpu_torch.utils import profiling
    if not hasattr(profiling, "read") or not trace.steps:
        return None
    spans = profiling.read()["spans"]
    ms = [spans[n]["device_ms"] for n in ("sponge.step", "nudge.step")
          if n in spans]
    if not ms or None in ms:
        return None
    return sum(ms) / trace.steps
