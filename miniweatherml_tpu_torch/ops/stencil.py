"""Boundary-condition padding on global tensors.

Port of ``miniweatherml_tpu/ops/stencil.py::pad_bc`` and ``halo_strips``.
Halos are produced by padding along the stencil axis:

  * BC_PERIODIC -> wrap padding,
  * BC_OPEN     -> edge replication (dynamics...h:772-779),
  * BC_WALL     -> edge replication, with the wall-normal velocity halo
                   zeroed (dynamics...h:768-770).
"""

from __future__ import annotations

import torch

__all__ = ["BC_PERIODIC", "BC_OPEN", "BC_WALL", "pad_bc", "halo_strips"]

# Reference enum values (dynamics_euler_stratified_wenofv.h:46-48).
BC_PERIODIC = 0
BC_OPEN = 1
BC_WALL = 2


def pad_bc(arr: torch.Tensor, axis: int, halo: int, bc: int,
           zero_var: int | None = None) -> torch.Tensor:
    """Pad ``arr`` with ``halo`` cells on both sides of ``axis`` per BC.

    ``zero_var`` (non-periodic only) zeroes variable index ``zero_var`` of
    the leading axis inside the pad region: the wall-normal velocity halo of
    a stacked-variable array.
    """
    ax = axis % arr.ndim
    n = arr.shape[ax]
    if bc == BC_PERIODIC:
        # index modulo n, so a halo wider than the axis wraps repeatedly
        idx = torch.arange(-halo, n + halo, device=arr.device) % n
        return arr.index_select(ax, idx)
    lo = arr.narrow(ax, 0, 1).expand(
        *[halo if d == ax else -1 for d in range(arr.ndim)])
    hi = arr.narrow(ax, n - 1, 1).expand(
        *[halo if d == ax else -1 for d in range(arr.ndim)])
    if zero_var is not None:
        mask = (torch.arange(arr.shape[0], device=arr.device) == zero_var)
        mask = mask.reshape((-1,) + (1,) * (arr.ndim - 1))
        lo = torch.where(mask, 0.0, lo)
        hi = torch.where(mask, 0.0, hi)
    return torch.cat([lo, arr, hi], dim=ax)


def halo_strips(arr: torch.Tensor, axis: int, halo: int, bc: int,
                zero_var: int | None = None):
    """The two ``halo``-wide strips (lo, hi) that ``pad_bc`` would place on
    each side of ``axis``, as contiguous tensors, without building the
    padded array; ``zero_var`` as in ``pad_bc``."""
    ax = axis % arr.ndim
    n = arr.shape[ax]
    if bc == BC_PERIODIC:
        return (arr.narrow(ax, n - halo, halo).contiguous(),
                arr.narrow(ax, 0, halo).contiguous())
    shape = [halo if d == ax else -1 for d in range(arr.ndim)]
    lo = arr.narrow(ax, 0, 1).expand(*shape)
    hi = arr.narrow(ax, n - 1, 1).expand(*shape)
    if zero_var is not None:
        mask = (torch.arange(arr.shape[0], device=arr.device) == zero_var)
        mask = mask.reshape((-1,) + (1,) * (arr.ndim - 1))
        lo = torch.where(mask, 0.0, lo)
        hi = torch.where(mask, 0.0, hi)
    return lo.contiguous(), hi.contiguous()
