"""Tracing / profiling: section timers, named regions and profiler traces.

Port of ``miniweatherml_tpu/utils/profiling.py``, the replacement for the
reference's YAKL timer machinery (``yakl::timer_start/stop`` around main,
the simulation loop, MPI exchanges and output, enabled by -DYAKL_PROFILE;
e.g. experiments/community_benchmark/driver.cpp:66,82):

  * ``timer(name)``: accumulating wall-clock section timers with a global
    registry and a report, like the YAKL timer report at finalize.  PyTorch
    returns before the device finishes, so the timer synchronizes the
    device of its ``sync_result`` (or the current CUDA device) on exit.
  * ``annotate(name)``: names a region in the profiler's trace
    (``torch.profiler.record_function``), the analog of YAKL's named
    parallel_for labels.
  * ``trace(logdir)``: records everything inside the block with
    ``torch.profiler`` (CPU, and CUDA when there is a card) and writes a
    Chrome trace into ``logdir``.

No experiment entry point imports this module; the timers are for
measurement scripts.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

__all__ = ["timer", "timer_report", "timer_totals", "reset_timers",
           "annotate", "trace", "sync"]

_REGISTRY: dict[str, list] = {}  # name -> [total_seconds, calls]


def _cuda_devices(x) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, a state with
    ``fields``, or nested tuples, lists and dicts of them)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if hasattr(x, "fields"):
        x = x.fields
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return set().union(*(_cuda_devices(v) for v in x))
    return set()


def sync(x=None) -> None:
    """Wait for the device work behind ``x``: synchronize each CUDA device
    that holds one of its tensors; with no argument, the current CUDA
    device when there is one.  CPU tensors need no wait."""
    if x is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for device in _cuda_devices(x):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timer(name: str, sync_result=None) -> Iterator[None]:
    """Accumulating section timer (yakl::timer_start/stop analog).

    Pass the computation's output as ``sync_result`` (a tensor or a state),
    or rely on the default, so asynchronous launches don't fake the time.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(sync_result)
        entry = _REGISTRY.setdefault(name, [0.0, 0])
        entry[0] += time.perf_counter() - t0
        entry[1] += 1


def timer_report() -> str:
    """The YAKL-finalize-style timer table."""
    lines = [f"{'timer':<32s} {'total_s':>10s} {'calls':>8s} {'per_call':>10s}"]
    for name, (total, calls) in sorted(_REGISTRY.items()):
        lines.append(f"{name:<32s} {total:10.4f} {calls:8d} "
                     f"{total / max(calls, 1):10.6f}")
    return "\n".join(lines)


def timer_totals() -> dict[str, tuple[float, int]]:
    """(total seconds, calls) of every timer."""
    return {name: (total, calls) for name, (total, calls) in
            _REGISTRY.items()}


def reset_timers() -> None:
    _REGISTRY.clear()


def annotate(name: str):
    """Name a region in the profiler's trace, like YAKL kernel labels."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record everything inside the block and write a Chrome trace,
    ``<logdir>/trace_<pid>_<n>.json`` (viewable in Perfetto or
    chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        sync()
    n = sum(f.startswith(f"trace_{os.getpid()}_") for f in os.listdir(logdir))
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}_{n}.json"))
