"""The coupler: named model state shared by the dycore and the physics modules.

Port of ``miniweatherml_tpu/core/coupler.py``.  The whole model state is a
``CouplerState``: a plain dataclass holding a ``dict[str, Tensor]`` of named
global fields plus hashable metadata (grid, tracer registry, options, dtype,
device).  Updates return a new state that shares the unchanged tensors, so a
state a caller keeps is never modified behind its back.

Coupler state convention (reference experiments/supercell_example/driver.cpp:39-40):
  * density_dry  -- dry air density (kg/m^3)
  * uvel/vvel/wvel -- velocities (m/s), NOT momenta
  * temp         -- temperature (K), NOT potential temperature
  * tracers      -- tracer MASSES (rho*q), not mixing ratios

Array layout is ``(nens, nz, ny, nx)``, x fastest, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "TracerMeta",
    "Grid",
    "Options",
    "CouplerMeta",
    "CouplerState",
    "make_coupler_state",
    "state_from_numpy",
    "state_to_numpy",
    "torch_dtype",
]

OptionValue = Any  # str | int | float | bool

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name ("float32" / "float64")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class TracerMeta:
    """Tracer registry entry (reference coupler.h:323-347)."""

    name: str
    desc: str = ""
    positive: bool = True   # must remain non-negative (FCT enforced)
    adds_mass: bool = True  # contributes to full density


@dataclasses.dataclass(frozen=True)
class Grid:
    """Global uniform structured grid geometry (reference coupler.h:316-321)."""

    nx: int
    ny: int
    nz: int
    nens: int = 1
    xlen: float = 1.0
    ylen: float = 1.0
    zlen: float = 1.0

    @property
    def dx(self) -> float:
        return self.xlen / self.nx

    @property
    def dy(self) -> float:
        return self.ylen / self.ny

    @property
    def dz(self) -> float:
        return self.zlen / self.nz

    @property
    def sim2d(self) -> bool:
        # 2-D (x-z) simulation when the global y extent is one cell
        # (reference coupler.h:127-131).
        return self.ny == 1

    @property
    def field_shape(self) -> tuple[int, int, int, int]:
        return (self.nens, self.nz, self.ny, self.nx)


class Options(Mapping[str, OptionValue]):
    """Immutable, hashable string-keyed option store (reference
    ``core::Options``, Options.h:66-127)."""

    __slots__ = ("_d", "_hash")

    def __init__(self, d: Mapping[str, OptionValue] | None = None):
        object.__setattr__(self, "_d", dict(d) if d else {})
        object.__setattr__(self, "_hash", None)

    def __getitem__(self, k: str) -> OptionValue:
        return self._d[k]

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __hash__(self):
        if self._hash is None:
            object.__setattr__(
                self, "_hash", hash(tuple(sorted(self._d.items()))))
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Options) and self._d == other._d

    def __repr__(self):
        return f"Options({self._d!r})"

    def get(self, k: str, default: OptionValue = None) -> OptionValue:
        return self._d.get(k, default)

    def set(self, **kv: OptionValue) -> "Options":
        d = dict(self._d)
        d.update(kv)
        return Options(d)

    def setdefaults(self, **kv: OptionValue) -> "Options":
        d = dict(kv)
        d.update(self._d)
        return Options(d)

    def delete(self, key: str) -> "Options":
        """(reference Options::delete_option, Options.h:127)"""
        d = dict(self._d)
        d.pop(key, None)
        return Options(d)


@dataclasses.dataclass(frozen=True)
class CouplerMeta:
    """Coupler metadata: grid, tracer registry, options, dtype, device."""

    grid: Grid
    tracers: tuple[TracerMeta, ...] = ()
    options: Options = dataclasses.field(default_factory=Options)
    dtype: str = "float32"
    device: str = "cpu"

    @property
    def num_tracers(self) -> int:
        return len(self.tracers)

    @property
    def tracer_names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tracers)

    @property
    def idWV(self) -> int:
        """Index of water vapor in the tracer registry (reference dynamics...h:1292)."""
        for i, t in enumerate(self.tracers):
            if t.name == "water_vapor":
                return i
        return -1

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass
class CouplerState:
    """The model's entire state: named global tensors + metadata
    (reference DataManager's named-array registry, DataManager.h:126-195)."""

    fields: dict[str, torch.Tensor]
    meta: CouplerMeta

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    @property
    def grid(self) -> Grid:
        return self.meta.grid

    @property
    def options(self) -> Options:
        return self.meta.options

    @property
    def device(self) -> torch.device:
        return torch.device(self.meta.device)

    def replace_fields(self, **updates: torch.Tensor) -> "CouplerState":
        f = dict(self.fields)
        f.update(updates)
        out = CouplerState(fields=f, meta=self.meta)
        # dirty-entry tracking (reference DataManager.h:206-237): the names
        # written since the last clear_dirty(); every other way of making a
        # state starts with none, as the JAX package's does
        out._dirty = self.dirty_fields | frozenset(updates)
        return out

    @property
    def dirty_fields(self) -> frozenset:
        """Names written through replace_fields since the last
        clear_dirty() (best-effort introspection, as in the reference)."""
        return getattr(self, "_dirty", frozenset())

    def clear_dirty(self) -> "CouplerState":
        return CouplerState(fields=dict(self.fields), meta=self.meta)

    def get_lev_col(self, name: str) -> torch.Tensor:
        """Field collapsed to (nz, ncol) for column physics (reference
        DataManager::get_lev_col, DataManager.h:294-338; ncol = nens ny nx,
        the vertical leading)."""
        g = self.grid
        return self.fields[name].movedim(1, 0).reshape(
            g.nz, g.nens * g.ny * g.nx)

    def get_collapsed(self, name: str) -> torch.Tensor:
        """Field flattened to 1-D (reference DataManager::get_collapsed,
        DataManager.h:346-379)."""
        return self.fields[name].reshape(-1)

    def with_meta(self, meta: CouplerMeta) -> "CouplerState":
        return CouplerState(fields=dict(self.fields), meta=meta)

    def set_options(self, **kv: OptionValue) -> "CouplerState":
        return self.with_meta(
            dataclasses.replace(self.meta, options=self.meta.options.set(**kv)))

    def setdefault_options(self, **kv: OptionValue) -> "CouplerState":
        return self.with_meta(dataclasses.replace(
            self.meta, options=self.meta.options.setdefaults(**kv)))

    def get_option(self, key: str, default: OptionValue = None) -> OptionValue:
        return self.meta.options.get(key, default)

    def register_field(self, name: str, shape: tuple[int, ...] | None = None,
                       value=None) -> "CouplerState":
        """Register a named tensor, zero-initialized unless ``value`` given
        (reference DataManager.h:126-195)."""
        if name in self.fields:
            raise ValueError(f"field {name!r} already registered")
        if value is None:
            if shape is None:
                shape = self.grid.field_shape
            value = torch.zeros(shape, dtype=self.meta.tdtype,
                                device=self.device)
        else:
            value = torch.as_tensor(value, dtype=self.meta.tdtype,
                                    device=self.device)
        return self.replace_fields(**{name: value})

    def add_tracer(self, name: str, desc: str = "", positive: bool = True,
                   adds_mass: bool = True) -> "CouplerState":
        """Register a tracer: registry metadata and a zeroed mass field
        (reference coupler.h:323-330)."""
        if any(t.name == name for t in self.meta.tracers):
            raise ValueError(f"tracer {name!r} already registered")
        meta = dataclasses.replace(
            self.meta,
            tracers=self.meta.tracers + (TracerMeta(name, desc, positive,
                                                    adds_mass),))
        out = self.with_meta(meta)
        if name not in out.fields:
            out = out.register_field(name)
        return out

    def tracer_stack(self) -> torch.Tensor:
        """Tracer fields stacked -> (num_tracers, nens, nz, ny, nx)
        (reference MultiField, MultipleFields.h:48-96)."""
        return torch.stack([self.fields[n] for n in self.meta.tracer_names])

    def with_tracer_stack(self, tr: torch.Tensor) -> "CouplerState":
        return self.replace_fields(
            **{n: tr[i] for i, n in enumerate(self.meta.tracer_names)})

    def validate(self, positive_only_registered: bool = True
                 ) -> dict[str, str]:
        """NaN/Inf/positivity validation (reference DataManager.h:385-483);
        returns {field: problems}, e.g. "nan" or "inf+negative", read from
        the device in one transfer (``core/validate.py``).  Positivity is
        checked for the tracers registered positive only, whatever
        ``positive_only_registered`` says: the JAX package's signature,
        which reads it no more."""
        from .validate import check_flags, validation_flags
        return check_flags(validation_flags(self))

    def clone(self) -> "CouplerState":
        """Copy whose tensors are independent of this state's."""
        return CouplerState(
            fields={k: v.clone() for k, v in self.fields.items()},
            meta=self.meta)


def make_coupler_state(grid: Grid, dtype: str = "float32",
                       options: Mapping[str, OptionValue] | None = None, *,
                       device: str | torch.device) -> CouplerState:
    """Create an empty coupler state for a grid on ``device`` (required: the
    port has no default device)
    (``distribute_mpi_and_allocate_coupled_state``, coupler.h:110-214,
    without the MPI decomposition)."""
    torch_dtype(dtype)
    meta = CouplerMeta(grid=grid, options=Options(options), dtype=dtype,
                       device=str(torch.device(device)))
    return CouplerState(fields={}, meta=meta)


def state_to_numpy(state: CouplerState) -> dict[str, np.ndarray]:
    """Every field of ``state`` as a host numpy array."""
    return {k: v.detach().cpu().numpy() for k, v in state.fields.items()}


def state_from_numpy(fields: Mapping[str, np.ndarray], grid, options,
                     tracers, dtype: str = "float64", *,
                     device: str | torch.device) -> CouplerState:
    """Build a port state from host arrays plus the metadata that goes with
    them.  ``grid`` and each entry of ``tracers`` may come from either
    package (they are read by attribute), so a JAX ``CouplerState`` carries
    across as ``{name: np.asarray(field)}`` with its grid, options and tracer
    registry."""
    g = Grid(nx=int(grid.nx), ny=int(grid.ny), nz=int(grid.nz),
             nens=int(grid.nens), xlen=float(grid.xlen),
             ylen=float(grid.ylen), zlen=float(grid.zlen))
    trs = tuple(TracerMeta(str(t.name), str(t.desc), bool(t.positive),
                           bool(t.adds_mass)) for t in tracers)
    state = make_coupler_state(g, dtype=dtype, options=dict(options),
                               device=device)
    state = state.with_meta(dataclasses.replace(state.meta, tracers=trs))
    tdt = torch_dtype(dtype)
    return state.replace_fields(**{
        k: torch.as_tensor(np.asarray(v), dtype=tdt, device=state.device)
        for k, v in fields.items()})
