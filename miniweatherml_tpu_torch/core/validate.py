"""In-step state validation: the DataManager::validate analog.

Port of ``miniweatherml_tpu/core/validate.py``.  ``validation_flags``
computes one flag word per field on the state's device (NaN / Inf / negative
for tracers registered positive, DataManager.h:385-483), so a step can
queue them without waiting for the device; ``check_flags`` reads all of
them in one host transfer.  ``CouplerState.validate()`` is the two
together.
"""

from __future__ import annotations

import torch

from .coupler import CouplerState

__all__ = ["validation_flags", "check_flags", "validated_step",
           "FLAG_NAN", "FLAG_INF", "FLAG_NEG"]

FLAG_NAN = 1
FLAG_INF = 2
FLAG_NEG = 4


def validation_flags(state: CouplerState) -> dict[str, torch.Tensor]:
    """Device-side flags per field: bitwise NaN/Inf/negative (positivity
    only for tracers registered positive, DataManager.h:131); returns
    {field: 0-d int32 tensor}."""
    positive = {t.name for t in state.meta.tracers if t.positive}
    flags = {}
    for name, arr in state.fields.items():
        f = torch.isnan(arr).any().to(torch.int32) * FLAG_NAN
        f = f | torch.isinf(arr).any().to(torch.int32) * FLAG_INF
        if name in positive:
            f = f | (arr < 0).any().to(torch.int32) * FLAG_NEG
        flags[name] = f
    return flags


def check_flags(flags: dict) -> dict[str, str]:
    """Host-side decode of ``validation_flags`` output -> {field:
    problems}, with one device-to-host transfer for all fields."""
    if not flags:
        return {}
    names = list(flags)
    values = torch.stack([torch.as_tensor(flags[n]) for n in names]).tolist()
    problems = {}
    for name, f in zip(names, values):
        if f:
            parts = []
            if f & FLAG_NAN:
                parts.append("nan")
            if f & FLAG_INF:
                parts.append("inf")
            if f & FLAG_NEG:
                parts.append("negative")
            problems[name] = "+".join(parts)
    return problems


def validated_step(step_fn):
    """Wrap a ``state -> state`` step so it also returns the validation
    flags of its output (device tensors; decode with ``check_flags``)."""

    def wrapped(state, *args, **kwargs):
        out = step_fn(state, *args, **kwargs)
        return out, validation_flags(out)

    return wrapped
