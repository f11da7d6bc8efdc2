"""Device mesh and the shards of a coupler state.

Port of ``miniweatherml_tpu/parallel/mesh.py``: the replacement for the
reference's 2-D MPI domain decomposition (coupler.h:110-214).  A mesh with
axes ("ens", "y", "x") splits the ensemble dimension and the horizontal grid
(the reference's nproc_y x nproc_x blocks; z is never split, coupler.h:147).

The JAX package keeps global arrays placed with a ``NamedSharding``; here a
``ShardedState`` holds the mesh and one local ``CouplerState`` per shard,
each on its shard's device.  A mesh is a list of ``torch.device``s, repeats
allowed: ``["cuda:0"] * 4`` puts a 2x2 mesh on one card, ``["cpu"] * 8`` is
the tests' eight-device mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.coupler import CouplerMeta, CouplerState, Grid

__all__ = ["Mesh", "ShardedState", "make_mesh", "near_square_factors",
           "field_split", "local_grid", "shard_state", "gather_state"]

AXES = ("ens", "y", "x")


def near_square_factors(n: int) -> tuple[int, int]:
    """Near-square factorization nproc_y x nproc_x = n, nproc_x >= nproc_y
    (reference coupler.h:132-140)."""
    if n < 1:
        raise ValueError(f"cannot factor a non-positive device count: {n}")
    py = math.isqrt(n)
    while n % py != 0:
        py -= 1
    return py, n // py


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ("ens", "y", "x") mesh: ``devices`` in row-major (ens, y, x) order,
    one per shard; the shard of rank r has coordinates ``coords(r)``."""

    devices: tuple[torch.device, ...]
    ens: int
    y: int
    x: int

    @property
    def shape(self) -> dict[str, int]:
        return {"ens": self.ens, "y": self.y, "x": self.x}

    @property
    def size(self) -> int:
        return self.ens * self.y * self.x

    def coords(self, rank: int) -> dict[str, int]:
        e, rem = divmod(rank, self.y * self.x)
        j, i = divmod(rem, self.x)
        return {"ens": e, "y": j, "x": i}

    def rank(self, ens: int, y: int, x: int) -> int:
        return (ens * self.y + y) * self.x + x


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, ens: int = 1, y: int | None = None,
              x: int | None = None) -> Mesh:
    """Build an ("ens", "y", "x") mesh over ``devices`` (default: every
    visible CUDA device).  With only a device count given, factor
    near-square over (y, x) like the reference decomposition.

    Raises a ValueError when the devices cannot fill the requested mesh
    (e.g. one device asked for ens=2)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if ens < 1:
        raise ValueError(f"ens must be >= 1, got {ens}")
    if len(devices) < ens:
        raise ValueError(
            f"mesh needs at least ens={ens} devices but only "
            f"{len(devices)} are available ({[str(d) for d in devices]})")
    n = len(devices) // ens
    if y is None or x is None:
        y, x = near_square_factors(n)
    if ens * y * x > len(devices):
        raise ValueError(
            f"mesh shape (ens={ens}, y={y}, x={x}) needs {ens * y * x} "
            f"devices but only {len(devices)} are available")
    return Mesh(tuple(devices[:ens * y * x]), ens, y, x)


# Fields whose layout is ambiguous by shape alone (e.g. nz == ny): name ->
# mesh axis of each tensor dimension (JAX mesh.py:64-73).
_NAMED_SPLITS = {
    "hy_dens_cells": ("ens",),
    "hy_dens_theta_cells": ("ens",),
    "hy_dens_edges": ("ens",),
    "hy_dens_theta_edges": ("ens",),
    "nudging_column": (None, "ens"),
    "horiz_sponge_column": (None, "ens"),
    "surrogate_diffs": (),
    "time_avg_etime": (),
}


def field_split(name: str, shape: tuple[int, ...], grid: Grid) -> tuple:
    """The mesh axis that splits each leading dimension of a coupler field
    (None: not split; trailing dimensions not listed are not split), the
    counterpart of the JAX package's ``field_pspec``: known names first,
    then the shape convention."""
    if name in _NAMED_SPLITS:
        return _NAMED_SPLITS[name]
    g = grid
    if shape == (g.nens, g.nz, g.ny, g.nx):
        return ("ens", None, "y", "x")
    if shape == (g.nens, g.ny, g.nx):
        return ("ens", "y", "x")
    if (len(shape) >= 1 and shape[0] == g.nens and g.ny not in shape[1:]
            and g.nx not in shape[1:]):
        return ("ens",)
    if len(shape) == 3 and shape[1] == g.nens and shape[2] == g.nz:
        # stacked per-field columns shaped (nfields, nens, nz)
        return (None, "ens")
    return ()  # replicated (unknown auxiliary data)


def local_grid(grid: Grid, mesh: Mesh) -> Grid:
    """One shard's grid: the cell counts and lengths divided by the mesh
    (so dx and dy, and with them the CFL step and the flux divergences, are
    the global ones).  Raises when the grid does not divide, or when a
    local ny of 1 would flip the dycore into its 2-D path."""
    E, Y, X = mesh.ens, mesh.y, mesh.x
    if grid.nens % E or grid.ny % Y or grid.nx % X:
        raise ValueError(
            f"grid ({grid.nens},{grid.ny},{grid.nx}) not divisible by mesh "
            f"({E},{Y},{X})")
    if grid.ny > 1 and grid.ny // Y == 1:
        raise ValueError("ny/Y must stay > 1 for a 3-D run (sim2d trigger)")
    return dataclasses.replace(
        grid, nens=grid.nens // E, ny=grid.ny // Y, nx=grid.nx // X,
        ylen=grid.ylen / Y, xlen=grid.xlen / X)


@dataclasses.dataclass
class ShardedState:
    """A coupler state split over a mesh: ``shards[r]`` is the local state
    of the shard of rank r (``mesh.coords(r)``), on ``mesh.devices[r]``;
    ``meta`` is the global state's metadata and ``shapes`` the global
    shape of each field."""

    mesh: Mesh
    shards: list[CouplerState]
    meta: CouplerMeta
    shapes: dict[str, tuple[int, ...]]

    def replace_shards(self, shards: list[CouplerState]) -> "ShardedState":
        return dataclasses.replace(self, shards=list(shards))

    @property
    def grid(self) -> Grid:
        return self.meta.grid

    def validate(self) -> dict[str, str]:
        """NaN/Inf/positivity of every field over all shards (as
        ``CouplerState.validate``), read in one host transfer."""
        from ..core.validate import check_flags, validation_flags
        dev = self.mesh.devices[0]
        merged: dict[str, torch.Tensor] = {}
        for shard in self.shards:
            for name, f in validation_flags(shard).items():
                f = f.to(dev)
                merged[name] = f if name not in merged else merged[name] | f
        return check_flags(merged)


def _split_index(split: tuple, coords: dict, local: tuple) -> list:
    """(dim, start, length) of a shard's block of a field."""
    return [(d, coords[ax] * local[d], local[d])
            for d, ax in enumerate(split) if ax is not None]


def shard_state(state: CouplerState, mesh: Mesh) -> ShardedState:
    """Split every field of ``state`` over ``mesh`` and copy each block to
    its shard's device (``field_split`` says how)."""
    g = state.grid
    lg = local_grid(g, mesh)
    shards = []
    for rank, dev in enumerate(mesh.devices):
        coords = mesh.coords(rank)
        fields = {}
        for name, arr in state.fields.items():
            split = field_split(name, tuple(arr.shape), g)
            local = tuple(n // mesh.shape[split[d]]
                          if d < len(split) and split[d] else n
                          for d, n in enumerate(arr.shape))
            block = arr
            for d, start, length in _split_index(split, coords, local):
                block = block.narrow(d, start, length)
            fields[name] = block.to(device=dev, copy=True,
                                    memory_format=torch.contiguous_format)
        meta = dataclasses.replace(state.meta, grid=lg, device=str(dev))
        shards.append(CouplerState(fields=fields, meta=meta))
    return ShardedState(mesh=mesh, shards=shards, meta=state.meta,
                        shapes={k: tuple(v.shape)
                                for k, v in state.fields.items()})


def gather_state(sharded: ShardedState, device) -> CouplerState:
    """The global state of ``sharded`` on ``device``: each field assembled
    from its blocks (a field not split over a mesh axis is taken from the
    shards at coordinate 0 of that axis)."""
    mesh, g = sharded.mesh, sharded.grid
    device = torch.device(device)
    fields = {}
    for name, gshape in sharded.shapes.items():
        split = field_split(name, gshape, g)
        out = torch.empty(gshape, dtype=sharded.shards[0][name].dtype,
                          device=device)
        for rank, shard in enumerate(sharded.shards):
            coords = mesh.coords(rank)
            if any(coords[ax] != 0 for ax in AXES if ax not in split):
                continue
            block = out
            for d, start, length in _split_index(split, coords,
                                                 shard[name].shape):
                block = block.narrow(d, start, length)
            block.copy_(shard[name])
        fields[name] = out
    meta = dataclasses.replace(sharded.meta, device=str(device))
    return CouplerState(fields=fields, meta=meta)
