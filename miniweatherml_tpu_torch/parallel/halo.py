"""Halo exchange between the shards of a mesh.

Port of ``miniweatherml_tpu/parallel/halo.py``, the counterpart of the
reference's MPI halo exchange (dynamics_euler_stratified_wenofv.h:574-827):
one exchange per direction per tendency evaluation, moving ``halo`` cells to
each ring neighbour in both directions (one barrier meeting of
``ShardComm.all_gather`` for both strips).  At the global boundary the outermost shards fill
their strips locally: periodic takes the ring, open replicates the edge
cell, wall replicates it with ``zero_var`` zeroed (the wall-normal
velocity); the FCT face multipliers take ``fill`` there.  A mesh axis of one
shard falls back to local padding.

Each function runs in a shard of a mesh run and meets the others through
the thread's current communicator (``collectives.shard_comm()``), where the
JAX functions use the enclosing ``shard_map``.
"""

from __future__ import annotations

import torch

from ..ops.stencil import BC_PERIODIC, halo_strips, pad_bc
from .collectives import shard_comm

__all__ = ["exchange_halos", "exchange_halo_strips", "exchange_face_scalar"]


def _strip(arr, axis, start, length):
    """A contiguous copy of ``length`` cells of ``arr`` along ``axis``: what
    a shard posts, never written again."""
    return arr.narrow(axis, start, length).clone(
        memory_format=torch.contiguous_format)


def _check_extent(arr, axis, halo):
    if arr.shape[axis] < halo:
        raise ValueError(
            f"shard-local extent {arr.shape[axis]} along axis {axis} is "
            f"smaller than the halo width {halo} (ord too high for this "
            f"grid/mesh split); use fewer shards or a larger grid")


def _ring_strips(arr, axis, halo, axis_name, nshards, bc, zero_var):
    """(lo, hi) strips from the ring neighbours, with the global boundary's
    fill on the outermost shards."""
    comm = shard_comm()
    ax = axis % arr.ndim
    n = arr.shape[ax]
    my_left = _strip(arr, ax, 0, halo)
    my_right = _strip(arr, ax, n - halo, halo)
    # one meeting moves both strips: the left halo of shard i+1 is the
    # right strip of shard i, the right halo of shard i-1 its left strip
    posted = comm.all_gather((my_left, my_right))
    idx = comm.axis_index(axis_name)
    left_src = comm.peer(axis_name, (idx - 1) % nshards)
    right_src = comm.peer(axis_name, (idx + 1) % nshards)
    lo = posted[left_src][1].to(comm.device)
    hi = posted[right_src][0].to(comm.device)
    if bc != BC_PERIODIC and (idx == 0 or idx == nshards - 1):
        b_lo, b_hi = halo_strips(arr, ax, halo, bc, zero_var=zero_var)
        if idx == 0:
            lo = b_lo
        if idx == nshards - 1:
            hi = b_hi
    return lo, hi


def exchange_halo_strips(arr, axis: int, halo: int, axis_name: str,
                         nshards: int, bc: int = BC_PERIODIC,
                         zero_var: int | None = None):
    """The two ``halo``-wide strips (lo, hi) that pad the shard-local block
    ``arr`` along ``axis``, from the ring neighbours along mesh axis
    ``axis_name`` of ``nshards`` shards; contiguous tensors on the shard's
    device.  ``bc`` applies at the global domain boundary only; ``zero_var``
    zeroes that variable (leading axis) of a boundary shard's wall strip."""
    _check_extent(arr, axis, halo)
    if nshards == 1:
        return halo_strips(arr, axis, halo, bc, zero_var=zero_var)
    return _ring_strips(arr, axis, halo, axis_name, nshards, bc, zero_var)


def exchange_halos(arr, axis: int, halo: int, axis_name: str, nshards: int,
                   bc: int = BC_PERIODIC, zero_var: int | None = None):
    """``arr`` extended by ``halo`` cells on both sides of ``axis``, with
    the strips of ``exchange_halo_strips``."""
    _check_extent(arr, axis, halo)
    if nshards == 1:
        return pad_bc(arr, axis, halo, bc, zero_var=zero_var)
    lo, hi = _ring_strips(arr, axis, halo, axis_name, nshards, bc, zero_var)
    return torch.cat([lo, arr, hi], dim=axis % arr.ndim)


def exchange_face_scalar(arr, axis: int, axis_name: str, nshards: int,
                         fill: float = 1.0):
    """The one-cell planes (left, right) beyond each end of ``axis``: the
    neighbours' boundary cells of ``arr`` (the FCT multiplier), ``fill`` at
    the global boundary (the global-array form pads the face multipliers
    with 1 at faces 0 and n for every BC, so on a periodic axis the two
    seam copies are scaled independently, as in the reference)."""
    ax = axis % arr.ndim
    n = arr.shape[ax]
    if nshards == 1:
        left = torch.full_like(arr.narrow(ax, 0, 1), fill,
                               memory_format=torch.contiguous_format)
        return left, left
    comm = shard_comm()
    posted = comm.all_gather((_strip(arr, ax, 0, 1), _strip(arr, ax, n - 1, 1)))
    idx = comm.axis_index(axis_name)
    if idx == 0:
        left = torch.full_like(posted[comm.rank][0], fill)
    else:
        left = posted[comm.peer(axis_name, idx - 1)][1].to(comm.device)
    if idx == nshards - 1:
        right = torch.full_like(posted[comm.rank][1], fill)
    else:
        right = posted[comm.peer(axis_name, idx + 1)][0].to(comm.device)
    return left, right
