"""The physics step run decomposed over a mesh of shards.

Port of ``miniweatherml_tpu/parallel/spmd.py``, the counterpart of the
reference's MPI decomposition (coupler.h:110-214 plus the halo and edge
exchanges, dynamics...h:574-1082).  The JAX package runs the whole chain
inside one ``shard_map``; here one controller runs one local program per
shard, each in a worker thread of a pool made once per step function
(``parallel/collectives.py`` says how the shards meet):

  * the dycore pulls its halo strips from the ring neighbours once per
    direction per tendency evaluation (``parallel/halo.py``) and hands them
    to the flux kernel's halo-strip form;
  * horizontal means (sponge, nudging) and the microphysics' sub-cycle
    counts are reduced over the mesh's horizontal axes (``pmean`` /
    ``pmin`` / ``pmax``, the MPI_Allreduce analog).

Every shard of a one-card mesh runs on that card: that measures what the
decomposition costs, not how it scales.  A mesh over several cards needs
no change here.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..dycore.euler import SpmdCtx
from ..physics.sponge import sponge_layer
from .collectives import ShardGroup, set_current
from .mesh import Mesh, ShardedState, local_grid

__all__ = ["make_spmd_step", "ShardRunner"]

# Seconds a shard waits at a collective for the others before the run
# fails (a host read of a long step on the card stays well inside it).
TIMEOUT_S = 600.0


class ShardRunner:
    """Runs ``fn(comm, item)`` for every shard of ``mesh`` at once, shard r
    in a worker thread with its device current (CUDA) and ``comm`` (its
    ``ShardComm``) as the thread's current communicator.  When a shard
    raises, the barrier is broken for the others, and ``run`` raises the
    first exception that is not such a broken barrier.  The shards take
    turns between their meetings (``ShardGroup.turn``)."""

    def __init__(self, mesh: Mesh, timeout: float = TIMEOUT_S):
        self.mesh = mesh
        self.timeout = timeout
        self._pool = ThreadPoolExecutor(mesh.size,
                                        thread_name_prefix="shard")

    def _one(self, group, rank, fn, item):
        comm = group.comm(rank)
        set_current(comm)
        try:
            comm.take_turn()
            if comm.device.type == "cuda":
                torch.cuda.set_device(comm.device)
            return fn(comm, item)
        except BaseException:
            group.barrier.abort()
            raise
        finally:
            comm.give_turn()
            set_current(None)

    def run(self, fn, items) -> list:
        if len(items) != self.mesh.size:
            raise ValueError(f"{len(items)} items for {self.mesh.size} "
                             "shards")
        group = ShardGroup(self.mesh, self.timeout)
        futures = [self._pool.submit(self._one, group, r, fn, item)
                   for r, item in enumerate(items)]
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # every shard's outcome is read
                errors.append(e)
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return results

    def close(self) -> None:
        self._pool.shutdown()


def make_spmd_step(state, mesh: Mesh, dycore, micro=None,
                   sponge_time_scale: float | None = 60.0, nudger=None):
    """The full physics step of ``state``'s configuration on ``mesh``.

    Returns ``step(sharded, dt) -> sharded`` on a ``ShardedState`` of that
    mesh (place a state with ``shard_state(state, mesh)``).  The module
    chain is the supercell driver's (driver.cpp:72-77): dycore -> micro
    (Kessler, P3 or the surrogate) -> sponge -> nudger, each mesh-aware.
    ``step.close()`` ends the worker threads.
    """
    local_grid(state.grid, mesh)  # raises when the grid does not divide
    axes = {}
    if mesh.x > 1:
        axes[-1] = ("x", mesh.x)
    if mesh.y > 1:
        axes[-2] = ("y", mesh.y)
    horiz = tuple(name for name, _ in axes.values())
    ctx = SpmdCtx(axes=axes)

    def local_chain(s, dt):
        s = dycore.time_step(s, dt, spmd=ctx)
        if micro is not None:
            s = micro.time_step(s, dt, spmd_axes=horiz)
        if sponge_time_scale is not None:
            s = sponge_layer(s, dt, time_scale=sponge_time_scale,
                             spmd_axes=horiz)
        if nudger is not None:
            s = nudger.nudge_to_column(s, dt, spmd_axes=horiz)
        return s

    runner = ShardRunner(mesh)

    def step(sharded: ShardedState, dt: float) -> ShardedState:
        if sharded.mesh != mesh:
            raise ValueError("the state is sharded over another mesh")
        return sharded.replace_shards(
            runner.run(lambda comm, s: local_chain(s, dt),
                       sharded.shards))

    step.close = runner.close
    return step
