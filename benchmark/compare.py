"""The comparison that decides ``correct``.

For each field the configuration lists, the program's field after the
compared steps ``p``, the reference's ``r`` and the reference's initial
field ``r0`` (after the benchmark's inputs) give one number:

    gap = ||p - r||_2 / max(||r - r0||_2, floor sqrt(n)),

the program's distance from the reference over the size of what the
reference's steps changed, over the n values of the field.  A step that
leaves a field as it was reads 1.  ``floor`` (the configuration's
``gap_floor``, in the field's units, a millionth of the field's scale in
the configuration) keeps a change that is numerical dust, such as a
surface rain rate of 1e-16 m/s where no rain falls, from standing as the
scale; a field with no floor and no change reads 0 where the program
leaves it too, else ``NO_CHANGE``.  The time step is
compared as the relative gap of the program's dt from the reference's.
Each number has a limit of its own (``limits/<workload>.json``).
"""

from __future__ import annotations

import json
import os

import torch

NO_CHANGE = 1.0e30   # a gap whose reference change is zero
DT = "dt"


def field_gap(p: torch.Tensor, r: torch.Tensor, r0: torch.Tensor,
              floor: float = 0.0) -> float:
    """||p - r|| / max(||r - r0||, floor sqrt(n)) in float64 on ``r``'s
    device."""
    p = p.to(device=r.device, dtype=torch.float64)
    num = torch.linalg.vector_norm(p - r.double()).item()
    den = torch.linalg.vector_norm(r.double() - r0.double()).item()
    den = max(den, floor * r.numel() ** 0.5)
    if den == 0.0:
        return 0.0 if num == 0.0 else NO_CHANGE
    return num / den


def gaps(program: dict, ref: dict, ref0: dict, fields, dt_p: float,
         dt_r: float, floors: dict | None = None) -> dict:
    """Every compared number, by name."""
    floors = floors or {}
    out = {DT: abs(dt_p - dt_r) / abs(dt_r)}
    for name in fields:
        out[name] = field_gap(program[name], ref[name], ref0[name],
                              floors.get(name, 0.0))
    return out


def load_limits(root: str, workload: str) -> dict:
    path = os.path.join(root, "benchmark", "limits", workload + ".json")
    with open(path) as f:
        return json.load(f)["limits"]


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    checks = {}
    ok = set(values) == set(limits)
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name), limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not v <= lim:
            ok = False
    return ok, checks
