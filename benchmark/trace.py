"""The traced run's reduction: device operations, the window, idle time and
the breakdown, from ``torch.profiler`` events kept in memory (no trace
file is written).

The harness opens a ``record_function`` span named ``window`` around the
measured steps and one around each step module (the names of the
configuration's ``modules``); device operations (kernels, copies, sets)
come from the profiler's CUPTI activity.  Times are in the profiler's
clock, in nanoseconds.
"""

from __future__ import annotations

import statistics

import torch

from .families import family

WINDOW = "window"


# the profiler's activity types of operations that occupy the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e, span_names):
    """"device" for an operation that occupies the device, "span" for one
    of the harness's host spans, else None (the device-side copies of the
    spans, host operations).  Bindings without ``activity_type`` tell
    device events by their device type; the spans' device-side copies then
    go by the spans' names."""
    if hasattr(e, "activity_type"):
        k = e.activity_type()
        if k in DEVICE_ACTIVITIES:
            return "device"
        return "span" if k == "user_annotation" and e.name() in span_names \
            else None
    on_dev = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.name() in span_names:
        return None if on_dev else "span"
    return "device" if on_dev else None


def _raw_events(prof, span_names):
    """(name, is_device, start_ns, end_ns) of the device operations and the
    harness's host spans (``record_function``) of a profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, span_names)
        if kind is None:
            continue
        t0 = e.start_ns()
        out.append((e.name(), kind == "device", t0, t0 + e.duration_ns()))
    return out


class Trace:
    """What the per-layer metrics read from one traced window."""

    def __init__(self, events, module_names, steps, step_ms, context):
        self.steps = steps
        self.step_ms = list(step_ms)
        self.context = context          # cfg, grid, dtype, ...
        win = [e for e in events if not e[1] and e[0] == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"expected one '{WINDOW}' span, found "
                               f"{len(win)}")
        self.w0, self.w1 = win[0][2], win[0][3]
        self.spans = sorted((e for e in events
                             if not e[1] and e[0] in module_names),
                            key=lambda e: e[2])
        dev = []
        for name, is_dev, t0, t1 in events:
            if is_dev and t1 > self.w0 and t0 < self.w1:
                dev.append((name, max(t0, self.w0), min(t1, self.w1)))
        dev.sort(key=lambda e: e[1])
        self.device_ops = dev
        self.window_s = (self.w1 - self.w0) / 1e9
        self._busy = self._union()

    def _union(self):
        """Busy intervals: the union of the device operations."""
        out = []
        for _, t0, t1 in self.device_ops:
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out

    @property
    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self._busy) / 1e9

    def family_ops(self, fam: str):
        """The device operations of a kernel family."""
        return [e for e in self.device_ops if family(e[0]) == fam]

    def family_seconds(self, fam: str) -> float:
        return sum(t1 - t0 for _, t0, t1 in self.family_ops(fam)) / 1e9

    def top_ops(self, n: int = 10):
        """[name, seconds] of the ``n`` device operations (by name) that
        took most time."""
        acc: dict[str, int] = {}
        for name, t0, t1 in self.device_ops:
            acc[name] = acc.get(name, 0) + (t1 - t0)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10):
        """[name, seconds] of the ``n`` longest idle gaps in the window,
        each named by the module span open on the host when the device ran
        dry ("between modules" where none was)."""
        gaps = []
        prev = self.w0
        for t0, t1 in self._busy + [[self.w1, self.w1]]:
            if t0 > prev:
                gaps.append((prev, t0 - prev))
            prev = max(prev, t1)
        gaps.sort(key=lambda g: -g[1])
        out = []
        for start, ns in gaps[:n]:
            name = "between modules"
            for sname, _, s0, s1 in self.spans:
                if s0 > start:
                    break
                if s1 >= start:
                    name = sname
            out.append([name, ns / 1e9])
        return out


def p95(values) -> float | None:
    """The 95th percentile (``statistics.quantiles``, n = 20, inclusive:
    never above the largest value)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20, method="inclusive")[18]
