"""Collectives between the shards of a mesh run by one controller.

The JAX package runs a mesh as one program under ``shard_map``, whose
collectives (``lax.ppermute``, ``pmean``, ``pmin``, ``pmax``,
``axis_index``) name a mesh axis.  Here each shard's local program runs in a
worker thread of one process (``parallel/spmd.py``), and a ``ShardComm``
gives that thread the same collectives:

  * every collective is one meeting of all shards at a ``threading.Barrier``
    (with a timeout; ``abort()`` breaks it for the others when a shard
    raises, so a failing shard never hangs the rest): each shard posts its
    value, waits, and reads what the others posted.  The posting slots are
    double-buffered, so consecutive collectives need one meeting each;
  * the shards take turns: a shard runs only while it holds the group's
    turn lock, which it gives up at each meeting.  The interpreter lock
    serializes the shards' host work anyway, and PyTorch releases it around
    every operation, so shards that ran at once would hand it to each other
    (a thread switch) at every operation: on the card a 2x2 mesh's step
    then took ~100 ms of host time against ~4 ms undecomposed (PERF.md);
  * values move between shards with ``.to(device)``: nothing on one card,
    a peer copy across cards (PyTorch orders it against both devices'
    current streams).  Every shard of one card queues its work on the
    device's current stream, so the barrier's order is the stream's order;
    a posted tensor is a fresh copy that nobody writes again;
  * reductions add the group's values in shard order on the shard's own
    device, so the result does not depend on thread scheduling, and read
    nothing to the host.  A reduction over several mesh axes is one
    meeting, as ``lax.pmean`` over a tuple of axis names is one collective.

The worker thread's communicator is also its *current* one
(``current()``), which the module-level collectives and the halo exchanges
(``parallel/halo.py``) use, as JAX's collectives use the enclosing
``shard_map``.
"""

from __future__ import annotations

import threading

import torch

from ..ops.exact_div import exact_div

__all__ = ["ShardGroup", "ShardComm", "current", "shard_comm", "axis_index",
           "pmean", "pmin", "pmax", "host_ints"]

_local = threading.local()


class ShardGroup:
    """What the shards of one run share: the mesh, the barrier and the
    posting slots."""

    def __init__(self, mesh, timeout: float):
        self.mesh = mesh
        self.timeout = timeout
        self.barrier = threading.Barrier(mesh.size, timeout=timeout)
        self.turn = threading.Lock()  # held by the shard that runs
        self.slots = [[None] * mesh.size, [None] * mesh.size]

    def comm(self, rank: int) -> "ShardComm":
        return ShardComm(self, rank)


class ShardComm:
    """One shard's view of its group: its rank, mesh coordinates and
    device, and the collectives."""

    def __init__(self, group: ShardGroup, rank: int):
        self.group = group
        self.rank = rank
        self.mesh = group.mesh
        self.coords = group.mesh.coords(rank)
        self.device = group.mesh.devices[rank]
        self._gen = 0
        self.holds_turn = False

    def take_turn(self) -> None:
        """Wait for the group's turn lock (raises after the timeout)."""
        if not self.group.turn.acquire(timeout=self.group.timeout):
            raise threading.BrokenBarrierError(
                "a shard held its turn past the timeout")
        self.holds_turn = True

    def give_turn(self) -> None:
        """Release the turn lock if this shard holds it (a lock has no
        owner: releasing one that another shard holds would let two run)."""
        if self.holds_turn:
            self.holds_turn = False
            self.group.turn.release()

    def all_gather(self, value) -> list:
        """Every shard's ``value``, in rank order (one barrier meeting; the
        shard gives up its turn while it waits)."""
        slots = self.group.slots[self._gen & 1]
        self._gen += 1
        slots[self.rank] = value
        self.give_turn()
        try:
            self.group.barrier.wait()
        finally:
            self.take_turn()
        return list(slots)

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def peer(self, name: str, index: int) -> int:
        """Rank of the shard at ``index`` along ``name`` and this shard's
        other coordinates."""
        c = dict(self.coords)
        c[name] = index
        return self.mesh.rank(c["ens"], c["y"], c["x"])

    def _group(self, names: tuple[str, ...]) -> list[int]:
        """Ranks of the shards that differ from this one only along the
        axes ``names``, in rank order."""
        fixed = [k for k in self.coords if k not in names]
        return [r for r in range(self.mesh.size)
                if all(self.mesh.coords(r)[k] == self.coords[k]
                       for k in fixed)]

    def _reduce(self, x: torch.Tensor, names, op):
        posted = self.all_gather(x)
        vals = [posted[r].to(self.device) for r in self._group(_axes(names))]
        acc = vals[0]
        for v in vals[1:]:
            acc = op(acc, v)
        return acc, len(vals)

    # ``names``: one mesh axis name or a tuple of them (one meeting)
    def pmean(self, x: torch.Tensor, names) -> torch.Tensor:
        acc, n = self._reduce(x, names, torch.add)
        return exact_div(acc, float(n))

    def pmin(self, x: torch.Tensor, names) -> torch.Tensor:
        return self._reduce(x, names, torch.minimum)[0]

    def pmax(self, x: torch.Tensor, names) -> torch.Tensor:
        return self._reduce(x, names, torch.maximum)[0]

    def host_ints(self, x: torch.Tensor) -> int:
        """``int(x)`` of this shard's 0-d tensor, with one host read for
        all shards: the shard of rank 0 stacks every shard's value on its
        device and reads them at once (two barrier meetings)."""
        posted = self.all_gather(x)
        values = None
        if self.rank == 0:
            values = [int(v) for v in torch.stack(
                [p.reshape(()).to(self.device) for p in posted]).tolist()]
        values = self.all_gather(values)[0]
        return values[self.rank]


def _axes(names) -> tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


def current() -> ShardComm | None:
    """The communicator of the shard this thread runs, or None."""
    return getattr(_local, "comm", None)


def set_current(comm: ShardComm | None) -> None:
    _local.comm = comm


def shard_comm() -> ShardComm:
    """The communicator of the shard this thread runs; raises outside a
    mesh run."""
    comm = current()
    if comm is None:
        raise RuntimeError("a collective was called outside a shard of a "
                           "mesh run (parallel/spmd.py)")
    return comm


def axis_index(name: str) -> int:
    return shard_comm().axis_index(name)


# The module-level reductions return ``x`` itself for an empty tuple of
# axes (an unsplit run), so that callers need no branch.
def pmean(x: torch.Tensor, names) -> torch.Tensor:
    return shard_comm().pmean(x, names) if _axes(names) else x


def pmin(x: torch.Tensor, names) -> torch.Tensor:
    return shard_comm().pmin(x, names) if _axes(names) else x


def pmax(x: torch.Tensor, names) -> torch.Tensor:
    return shard_comm().pmax(x, names) if _axes(names) else x


def host_ints(x: torch.Tensor) -> int:
    """``int(x)``; inside a shard of a mesh run, one host read serves every
    shard (``ShardComm.host_ints``)."""
    comm = current()
    return int(x) if comm is None else comm.host_ints(x)
