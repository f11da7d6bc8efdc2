"""Checkpoint / restore of the full coupler state.

Port of ``miniweatherml_tpu/io/checkpoint.py`` with the same ``.npz``
layout: a JSON ``__header__`` (etime, dtype, grid, tracers, options) and one
``field::<name>`` array per field.  A checkpoint written by either package
therefore loads in the other, which is how a run's state crosses between
them (beside ``state_from_numpy`` / ``state_to_numpy``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..core.coupler import (CouplerMeta, CouplerState, Grid, Options,
                            TracerMeta)

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, state: CouplerState, etime: float = 0.0) -> None:
    """Write every field of ``state`` (copied to the host) and its metadata;
    numpy appends ``.npz`` to a ``path`` without it."""
    meta = state.meta
    header = {
        "etime": etime,
        "dtype": meta.dtype,
        "grid": dataclasses.asdict(meta.grid),
        "tracers": [dataclasses.asdict(t) for t in meta.tracers],
        "options": dict(meta.options),
    }
    arrays = {f"field::{k}": v.detach().cpu().numpy()
              for k, v in state.fields.items()}
    np.savez(path, __header__=json.dumps(header), **arrays)


def load_checkpoint(path: str, device: str | torch.device
                    ) -> tuple[CouplerState, float]:
    """The state saved at ``path``, its fields on ``device``, and its
    elapsed time."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        fields = {
            k[len("field::"):]: torch.as_tensor(z[k], device=device)
            for k in z.files if k.startswith("field::")
        }
    meta = CouplerMeta(
        grid=Grid(**header["grid"]),
        tracers=tuple(TracerMeta(**t) for t in header["tracers"]),
        options=Options(header["options"]),
        dtype=header["dtype"],
        device=str(torch.device(device)),
    )
    return CouplerState(fields=fields, meta=meta), float(header["etime"])
