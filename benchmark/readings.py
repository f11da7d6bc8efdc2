"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--gate-seeds 5]

For each of ``--seeds``: the program's compared numbers, as a run takes
them (the inputs from the seed, the warm steps through the chain's own
call, the reference from the same inputs), with no measured window; for
each of ``--control-seeds``: the control's, the reference computed in
bfloat16 put in the program's place (the nearest precision below the
configuration's float32) and compared with the float32 reference; for
each of ``--gate-seeds``: the reference's count, per compared step, of the
cells that pass each of the microphysics' gates (P3's presence and
process gates, and its sedimentation sub-steps).  One JSON line per
reading, then a summary line with each number's largest program reading
and smallest control reading.  The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_reading(workload, seed, device, root, grid_overrides=None):
    """The program's compared numbers for one seed, taken as a run takes
    them, without the window."""
    from .harness import Cell, reference_run, warm_program
    cell = Cell(workload, root, grid_overrides)
    prog, dt, snap, _ = warm_program(cell, seed, device)
    del prog
    _free()
    ref0, ref, dt_ref, _ = reference_run(cell, seed, device)
    return cell.gaps(snap, dt, ref0, ref, dt_ref)


def control_reading(workload, seed, device, root, grid_overrides=None):
    """The control's compared numbers for one seed: the reference in
    bfloat16, the precision below the configuration's float32, in the
    program's place, against the reference in float32."""
    import torch

    from .harness import Cell, reference_run
    cell = Cell(workload, root, grid_overrides)
    ref0, ref, dt_ref, _ = reference_run(cell, seed, device)
    ref0 = {k: v.cpu() for k, v in ref0.items()}
    ref = {k: v.cpu() for k, v in ref.items()}
    _free()
    _, low_out, dt_low, _ = reference_run(cell, seed, device,
                                          torch.bfloat16)
    low_out = {k: v.float().cpu() for k, v in low_out.items()}
    _free()
    on = {k: v.to(device) for k, v in ref.items()}
    on0 = {k: v.to(device) for k, v in ref0.items()}
    return cell.gaps(low_out, dt_low, on0, on, dt_ref)


def gate_reading(workload, seed, device, root, grid_overrides=None):
    """The reference's gate counts per compared step, and the cells."""
    from .harness import Cell, reference_run
    cell = Cell(workload, root, grid_overrides)
    counts: list = []
    reference_run(cell, seed, device, counts=counts)
    g = cell.grid
    return {"cells": g.nx * g.ny * g.nz * g.nens, "steps": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--gate-seeds", default="")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    prog, ctrl = {}, {}
    for s in [int(x) for x in args.gate_seeds.split(",") if x]:
        t0 = time.perf_counter()
        v = gate_reading(args.workload, s, dev, ROOT)
        _free()
        print(json.dumps({"kind": "gates", "seed": s, "seconds":
                          time.perf_counter() - t0, **v}), flush=True)
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            t0 = time.perf_counter()
            if kind == "program":
                v = program_reading(args.workload, s, dev, ROOT)
            else:
                v = control_reading(args.workload, s, dev, ROOT)
            _free()
            (prog if kind == "program" else ctrl)[s] = v
            print(json.dumps({"kind": kind, "seed": s, "seconds":
                              time.perf_counter() - t0, "gaps": v}),
                  flush=True)
    names = sorted(set().union(*[set(v) for v in
                                 list(prog.values()) + list(ctrl.values())]))
    summary = {n: {"program_max": max((v[n] for v in prog.values()),
                                      default=None),
                   "control_min": min((v[n] for v in ctrl.values()),
                                      default=None)} for n in names}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.readings import main as _main
    sys.exit(_main())
