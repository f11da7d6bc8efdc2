"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``, data
for ``inputs.py``); the end-to-end metrics are ``end_to_end/<name>.py``
and the per-layer metrics ``metrics/<name>.py``; the limits of the
compared numbers are ``limits/<cell>.json``.  Everything is found by name,
so a new cell, configuration, mix or metric is new files and entries.

A run:

1. builds the port's chain (``program.py``) and puts the inputs made from
   ``--seed`` (``inputs.py``) into its state;
2. takes the CFL time step once and holds it;
3. steps the chain through ``steps_compared`` warm steps, the window's own
   call on the same object, and keeps the compared fields on the host;
   this ends set-up (``setup_s``, from process start);
4. steps the chain until ``--seconds`` have passed, ending in a device
   synchronize (with ``--trace 1`` under ``torch.profiler``, with a span
   around the window and each module, and CUDA events around each step);
5. reads the peak memory, frees the program's state and runs the
   reference from the same inputs, made again from the seed, for the same
   steps, then compares (``compare.py``).
"""

from __future__ import annotations

import gc
import json
import os
import time
from types import SimpleNamespace

import torch

from . import compare
from .inputs import apply_inputs, input_fields, input_sums, make_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str, root: str = ROOT):
    """(cell, config entry, config dict, traffic dict) of ``workload``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, entry, cfg, traffic


def metric_names(manifest: dict, workload: str, kind: str) -> list:
    """The end-to-end ("end_to_end") or per-layer ("per_layer") metrics a
    workload reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_metric(name: str, root: str = ROOT, kind: str = "metrics"):
    """The metric module ``<kind>/<name>.py`` of the checkout at ``root``
    (``metrics``: per-layer, ``end_to_end``), loaded from its file as a
    module of ``benchmark.<kind>``."""
    import importlib.util
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid(cfg, overrides):
    g = dict(nx=cfg["nx_glob"], ny=cfg["ny_glob"], nz=cfg["nz"],
             nens=cfg.get("nens", 1), xlen=float(cfg["xlen"]),
             ylen=float(cfg["ylen"]), zlen=float(cfg["zlen"]))
    g.update(overrides or {})
    g["dx"], g["dy"], g["dz"] = (g["xlen"] / g["nx"], g["ylen"] / g["ny"],
                                 g["zlen"] / g["nz"])
    return SimpleNamespace(**g)


class Cell:
    """A workload's configuration and traffic mix, at the configuration's
    grid or, for the tests on the CPU, at ``grid_overrides``."""

    def __init__(self, workload: str, root: str = ROOT, grid_overrides=None):
        self.workload, self.root = workload, root
        self.manifest = load_manifest(root)
        _, _, cfg, self.traffic = cell_files(self.manifest, workload, root)
        self.grid = g = _grid(cfg, grid_overrides)
        self.cfg = dict(cfg, nx_glob=g.nx, ny_glob=g.ny, nz=g.nz,
                        nens=g.nens, xlen=g.xlen, ylen=g.ylen, zlen=g.zlen)
        self.dtype = DTYPES[self.cfg["dtype"]]
        self.fields = self.cfg["compare"]
        self.nwarm = int(self.cfg["steps_compared"])

    def inputs(self, seed: int, device, dtype=None) -> dict:
        return make_inputs(self.traffic, self.grid, seed,
                           dtype or self.dtype, device)

    def gaps(self, snap, dt, ref0, ref, dt_ref) -> dict:
        return compare.gaps(snap, ref, ref0, self.fields, dt, dt_ref,
                            self.cfg.get("gap_floor"))


def warm_program(cell: Cell, seed: int, device, program_hook=None):
    """The port's chain with the seed's inputs after the compared warm
    steps: (program, dt, the compared fields on the host, the inputs'
    sums)."""
    from .program import Program
    prog = Program(cell.cfg, device)
    if program_hook is not None:
        program_hook(prog)
    inputs = cell.inputs(seed, device)
    sums = input_sums(inputs)
    prog.apply(apply_inputs(prog.fields(input_fields(inputs)), inputs))
    del inputs
    dt = prog.time_step()
    for _ in range(cell.nwarm):
        prog.step(dt)
    snap = {n: v.to("cpu", copy=True)
            for n, v in prog.fields(cell.fields).items()}
    return prog, dt, snap, sums


def reference_run(cell: Cell, seed: int, device, dtype=None, counts=None):
    """The reference from the seed's inputs (made again) through the
    compared steps, in ``dtype`` (default the configuration's): (initial
    fields, final fields, its dt, the inputs' sums).  ``counts``, a list,
    receives each step's gate counts where the microphysics keeps them."""
    from .reference.chain import ReferenceChain
    dtype = dtype or cell.dtype
    inputs = cell.inputs(seed, device, dtype)
    sums = input_sums(inputs)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        chain = ReferenceChain(cell.cfg, cell.grid, cell.root, dtype, device)
        if counts is not None and hasattr(chain.micro, "counts"):
            chain.micro.counts = counts
        ref0 = chain.initial(inputs)
        del inputs
        ref = ref0
        for _ in range(cell.nwarm):
            ref = chain.step(ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    keep = set(cell.fields)
    return ({k: v for k, v in ref0.items() if k in keep},
            {k: v for k, v in ref.items() if k in keep}, chain.dt, sums)


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", grid_overrides=None, root: str = ROOT,
        program_hook=None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``grid_overrides`` and a CPU ``device`` serve the tests: on the CPU no
    metric is reported.  ``program_hook(program)`` may replace the
    program's step modules (the tests plant faults with it)."""
    cell = Cell(workload, root, grid_overrides)
    device = torch.device(device)
    on_card = device.type == "cuda"
    prog, dt, snap, sums = warm_program(cell, seed, device, program_hook)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    steps, elapsed, tr = _window(prog, dt, seconds, trace, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    problems = prog.validate()
    ntr = len(prog.state.meta.tracer_names)
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref0, ref, dt_ref, ref_sums = reference_run(cell, seed, device)
    values = cell.gaps(snap, dt, ref0, ref, dt_ref)
    del ref0, ref
    taken = {"setup": setup_s, "window": elapsed,
             "reference": time.perf_counter() - t_ref}
    same_inputs = ref_sums == sums
    correct, checks = compare.judge(values,
                                    compare.load_limits(root, workload))
    correct = correct and not problems and same_inputs

    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if on_card and not trace:
        got = SimpleNamespace(grid=cell.grid, steps=steps, elapsed=elapsed,
                              setup_s=setup_s, peak=peak)
        for m in metric_names(cell.manifest, workload, "end_to_end"):
            v = load_metric(m["name"], root, "end_to_end").read(got)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if on_card and trace:
        tr.context.update(cfg=cell.cfg, grid=cell.grid,
                          dtype=cell.cfg["dtype"], ntr=ntr)
        for m in metric_names(cell.manifest, workload, "per_layer"):
            v = load_metric(m["name"], root).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": steps,
              "failed": steps if problems else 0, "metrics": metrics,
              "device": dev}
    if on_card and trace:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if problems:
        result["problems"] = {k: str(v) for k, v in problems.items()}
    if not same_inputs:
        result["reference_note"] = ("the inputs made again from the seed "
                                    "differ from the program's")
    result["seconds"] = taken
    result["checks"] = checks
    return result


def _window(prog, dt, seconds, trace, device):
    """The measured steps: (steps, seconds, Trace or None)."""
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    if not trace:
        t0 = time.perf_counter()
        steps = 0
        while True:
            prog.step(dt)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        return steps, time.perf_counter() - t0, None

    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import WINDOW, Trace, _raw_events
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    marks = []
    with profile(activities=acts) as p:
        with record_function("window"):
            t0 = time.perf_counter()
            steps = 0
            while True:
                if on_card:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                prog.step(dt, spans=True)
                if on_card:
                    e1.record()
                    marks.append((e0, e1))
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            elapsed = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in marks]
    spans = set(prog.names)
    tr = Trace(_raw_events(p, spans | {WINDOW}), spans, steps, step_ms, {})
    return steps, elapsed, tr
