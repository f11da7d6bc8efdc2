"""Tracing / profiling: the port's spans and counters, section timers and
profiler traces.

Port of ``miniweatherml_tpu/utils/profiling.py``, the replacement for the
reference's YAKL timer machinery (``yakl::timer_start/stop`` around main,
the simulation loop, MPI exchanges and output, enabled by -DYAKL_PROFILE;
e.g. experiments/community_benchmark/driver.cpp:66,82).

The one registry of the program's spans and counters:

  * ``span(name)``: a named region of the program.  It does work only while
    a ``torch.profiler`` session is active: then it opens a region of its
    name on the profiler's CPU timeline (nested in whatever region is open
    there; unlike ``record_function``, with no copy on the device's
    timeline), takes the host clock at entry and exit, records a pair of
    CUDA timing events on the current stream when CUDA is in use, and
    keeps its parent (the innermost span open in its thread).  Without a
    session it costs one flag check: no event, no allocation, no device
    operation.
  * ``count(name, n)``: a host counter (kernel launches, builds); always
    on, under a lock, since the shards of a mesh launch from threads.
  * ``count_traced(name, n)``: a host counter that counts only while a
    ``torch.profiler`` session is active (which kernel form ran); without
    one it costs one flag check.
  * ``count_device(name, t)``: keeps a 0-d device tensor the program has
    already made (a sub-step count) while a session is active; no launch
    and no host read.
  * ``read()``: waits for the recorded work, resolves the events and the
    kept tensors, and returns the totals per name; ``reset()`` clears them.

Measurement scripts also have:

  * ``timer(name)``: accumulating wall-clock section timers with a report,
    like the YAKL timer report at finalize.  PyTorch returns before the
    device finishes, so the timer synchronizes the device of its
    ``sync_result`` (or the current CUDA device) on exit; the program
    never uses it.
  * ``trace(logdir)``: records everything inside the block with
    ``torch.profiler`` (CPU, and CUDA when there is a card) and writes a
    Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "count", "count_traced", "counter", "count_device",
           "read", "reset", "timer", "timer_report", "timer_totals",
           "reset_timers", "trace", "sync"]

_TIMERS: dict[str, list] = {}  # name -> [total_seconds, calls]

_lock = threading.Lock()
_local = threading.local()      # .stack: the names of this thread's open spans
_NULL = contextlib.nullcontext()
# span name -> [calls, host ns, device ms (None without events), parent]
_spans: dict[str, list] = {}
_pending: list = []             # (span name, start event, end event)
_counters: dict[str, list] = {}  # counter name -> [total, calls]
_kept: dict[str, list] = {}     # device counter name -> [0-d tensors]


# A region of the profiler's CPU timeline that has no device-side copy.
# ``torch.profiler.record_function`` is a user annotation, which the
# profiler mirrors on the device's timeline as a span over the kernels it
# launched; a trace reduction that takes every event on the device for a
# device operation would count that copy as one.
_RecordFunction = torch._C._profiler._RecordFunctionFast


def _active() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "parent", "rf", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = _RecordFunction(self.name)
        self.rf.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            entry = _spans.setdefault(self.name, [0, 0, None, self.parent])
            entry[0] += 1
            entry[1] += host_ns
            if end is not None:
                _pending.append((self.name, self.start, end))
        return False


def span(name: str):
    """A named region of the program (see the module docstring); a no-op
    unless a ``torch.profiler`` session is active."""
    if not _active():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    with _lock:
        entry = _counters.setdefault(name, [0, 0])
        entry[0] += n
        entry[1] += 1


def count_traced(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` while a ``torch.profiler``
    session is active; a no-op otherwise."""
    if _active():
        count(name, n)


def counter(name: str):
    """The total of the host counter ``name`` so far (0 if never counted);
    no device read."""
    with _lock:
        entry = _counters.get(name)
        return entry[0] if entry is not None else 0


def count_device(name: str, t: torch.Tensor) -> None:
    """Keep the 0-d tensor ``t`` to add to the counter ``name`` at
    ``read()``; a no-op unless a ``torch.profiler`` session is active."""
    if not _active():
        return
    with _lock:
        _kept.setdefault(name, []).append(t)


def read() -> dict:
    """Wait for the recorded work and return ``{"spans": {name: {"calls",
    "host_ms", "device_ms", "parent"}}, "counters": {name: {"total",
    "calls"}}}``; ``device_ms`` is None for a span that recorded no CUDA
    events.  The totals keep growing until ``reset()``."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
        kept = {k: list(v) for k, v in _kept.items()}
        _kept.clear()
    device_ms: dict[str, float] = {}
    for name, start, end in pending:
        end.synchronize()
        device_ms[name] = device_ms.get(name, 0.0) + start.elapsed_time(end)
    sums = {k: [sum(t.item() for t in v), len(v)] for k, v in kept.items()}
    with _lock:
        for name, ms in device_ms.items():
            entry = _spans[name]
            entry[2] = ms if entry[2] is None else entry[2] + ms
        for name, (total, calls) in sums.items():
            entry = _counters.setdefault(name, [0, 0])
            entry[0] += total
            entry[1] += calls
        return {"spans": {k: {"calls": c, "host_ms": ns / 1e6,
                              "device_ms": dev, "parent": parent}
                          for k, (c, ns, dev, parent) in _spans.items()},
                "counters": {k: {"total": t, "calls": c}
                             for k, (t, c) in _counters.items()}}


def reset() -> None:
    """Clear every span and counter."""
    with _lock:
        _spans.clear()
        _pending.clear()
        _counters.clear()
        _kept.clear()


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
    """Accumulating section timer (yakl::timer_start/stop analog) for
    measurement scripts; it synchronizes, so the program never uses it.

    Pass the computation's output as ``sync_result`` (a tensor or a state),
    or rely on the default, so asynchronous launches don't fake the time.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(sync_result)
        entry = _TIMERS.setdefault(name, [0.0, 0])
        entry[0] += time.perf_counter() - t0
        entry[1] += 1


def timer_report() -> str:
    """The YAKL-finalize-style timer table."""
    lines = [f"{'timer':<32s} {'total_s':>10s} {'calls':>8s} {'per_call':>10s}"]
    for name, (total, calls) in sorted(_TIMERS.items()):
        lines.append(f"{name:<32s} {total:10.4f} {calls:8d} "
                     f"{total / max(calls, 1):10.6f}")
    return "\n".join(lines)


def timer_totals() -> dict[str, tuple[float, int]]:
    """(total seconds, calls) of every timer."""
    return {name: (total, calls) for name, (total, calls) in
            _TIMERS.items()}


def reset_timers() -> None:
    _TIMERS.clear()


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
