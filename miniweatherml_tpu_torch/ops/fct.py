"""Flux-corrected transport of the tracers: the per-cell multiplier and the
scaled tracer divergence of one direction.

The dycore computes the multiplier once per right-hand side with
``fct_mult`` and then calls ``fct_scale_div`` for x (first), z (accumulating)
and y (accumulating, with the SSPRK3 tracer stage update); in 2-D, z is last
and carries the update.  On a CUDA tensor both launch the kernels of
``csrc/fct.cu``: ``fct_scale_div`` is the port of the Pallas kernels
``fct_scale_div_pallas`` and ``fct_scale_div_pallas_sub`` of
``miniweatherml_tpu/ops/pallas_recon.py``, ``fct_mult`` of the XLA fusion that
forms the multiplier (``miniweatherml_tpu/dycore/euler.py``,
``Dycore._fct_div_pallas``).  On a CPU tensor they run ``fct_scale_div_plain``
and ``fct_mult_plain``, the plain PyTorch versions, which compute the same
IEEE operations in the same order (dynamics...h:498-516).
"""

from __future__ import annotations

import torch

from ..cuda_build import (DOUBLE, INT, LONG, PTR, U64, KernelLibrary,
                          check_operand, data_ptr, on_cuda)
from ..utils.profiling import count
from .exact_div import exact_div

__all__ = ["fct_mult", "fct_mult_plain", "fct_mult_groups", "fct_scale_div",
           "fct_scale_div_plain", "fct_scale_div_groups", "per_tracer",
           "MAX_TRACERS"]

# Field axis of each direction on (ntr, nens, nz, ny, nx).
_AX_X, _AX_Y, _AX_Z = -1, -2, -3


def per_tracer(x, flags, fn):
    """``fn`` applied to the tracers of ``x`` (leading axis) whose flag is
    set, the others kept.  The flags are registry metadata on the host, so
    no mask tensor (and no host-to-device copy, which would wait for the
    device) is needed."""
    if all(flags):
        return fn(x)
    if not any(flags):
        return x
    return torch.stack([fn(x[i]) if f else x[i] for i, f in enumerate(flags)])


def _outflow(F, axis, n, d):
    """Outgoing flux density of each cell along one direction:
    (max(F[f+1], 0) - min(F[f], 0)) / d."""
    return exact_div(torch.clamp(F.narrow(axis, 1, n), min=0.0)
                     - torch.clamp(F.narrow(axis, 0, n), max=0.0), d)


def fct_mult_plain(tr, positive, Fx, Fy, Fz, dt, dx, dy, dz):
    """Plain PyTorch version of ``fct_mult`` (same arguments)."""
    nz, ny, nx = tr.shape[-3:]
    vol = dx * dy * dz
    mass_avail = torch.clamp(tr, min=0.0) * vol
    fo_x = _outflow(Fx, _AX_X, nx, dx)
    fo_z = _outflow(Fz, _AX_Z, nz, dz)
    fo_y = 0.0 if Fy is None else _outflow(Fy, _AX_Y, ny, dy)
    mass_out = (fo_x + fo_y + fo_z) * dt * vol
    need = mass_out > mass_avail
    tiny = 1e-300 if tr.dtype == torch.float64 else 1e-30
    mult = torch.where(need, mass_avail / torch.clamp(mass_out, min=tiny),
                       1.0)
    return per_tracer(mult, [not p for p in positive], torch.ones_like)


def fct_scale_div_plain(F, mult, t_prev, axis, n, dxi, rk=None, edges=None):
    """Plain PyTorch version of ``fct_scale_div`` (same arguments; writes
    into ``t_prev`` likewise)."""
    Flo = F.narrow(axis, 0, n)
    Fhi = F.narrow(axis, 1, n)
    if edges is None:
        one_shape = list(mult.shape)
        one_shape[axis] = 1
        one = torch.ones(one_shape, dtype=mult.dtype, device=mult.device)
        edges = (one, one)
    m_prev = torch.cat([edges[0], mult.narrow(axis, 0, n - 1)], dim=axis)
    m_next = torch.cat([mult.narrow(axis, 1, n - 1), edges[1]], dim=axis)
    fs_lo = Flo * torch.where(Flo > 0, m_prev, torch.where(Flo < 0, mult, 1.0))
    fs_hi = Fhi * torch.where(Fhi > 0, mult, torch.where(Fhi < 0, m_next, 1.0))
    acc = (fs_lo - fs_hi) * dxi
    if t_prev is not None:
        acc = t_prev + acc
    if rk is not None:
        c0, c1, cdt, tr0, tr1, positive = rk
        v = c0 * tr0
        if tr1 is not None:
            v = v + c1 * tr1
        v = v + cdt * acc
        acc = per_tracer(v, positive, lambda t: torch.clamp(t, min=0.0))
    if t_prev is None:
        return acc
    return t_prev.copy_(acc)


LIBRARY = KernelLibrary("fct", {
    "fct_scale_div": [PTR] * 8 + [LONG, INT, LONG, LONG, U64] + [DOUBLE] * 4,
    "fct_mult": [PTR] * 5 + [INT] * 5 + [U64] + [DOUBLE] * 5})


# Tracers one launch takes: the positive flags travel as a 64-bit mask.
# More go through ``fct_mult_groups`` / ``fct_scale_div_groups``.
MAX_TRACERS = 64


def _mask(positive, ntr: int) -> int:
    """The positive flags as a 64-bit mask, bit t for tracer t."""
    if len(positive) != ntr:
        raise ValueError(f"{len(positive)} positive flags for {ntr} tracers")
    if ntr > MAX_TRACERS:
        raise ValueError(f"one FCT launch takes at most {MAX_TRACERS} "
                         f"tracers, got {ntr}")
    return sum(1 << i for i, p in enumerate(positive) if p)


def _groups(ntr: int):
    """Slices of at most ``MAX_TRACERS`` tracers covering ``ntr``, in
    order."""
    return [slice(t0, min(t0 + MAX_TRACERS, ntr))
            for t0 in range(0, ntr, MAX_TRACERS)]


def _part(x, g):
    return None if x is None else x[g]


def _cells(x):
    """The (ntr, nens, nz, ny, nx) shape of a CUDA call's tracer field."""
    if x.dim() != 5:
        raise ValueError(f"expected (ntr, nens, nz, ny, nx), got "
                         f"{tuple(x.shape)}")
    return x.shape


def fct_mult_groups(launch, tr, positive, Fx, Fy, Fz, dt, dx, dy, dz):
    """``fct_mult`` of any number of tracers from a ``launch`` that takes at
    most ``MAX_TRACERS``: one call per group of tracers, each with its own
    positive flags; the multipliers concatenated equal one call's (every
    tracer's multiplier depends on that tracer alone)."""
    return torch.cat([launch(tr[g], positive[g], Fx[g], _part(Fy, g), Fz[g],
                             dt, dx, dy, dz)
                      for g in _groups(tr.shape[0])])


def fct_scale_div_groups(launch, F, mult, t_prev, axis, n, dxi, rk=None,
                         edges=None):
    """``fct_scale_div`` of any number of tracers from a ``launch`` that
    takes at most ``MAX_TRACERS``, one call per group of tracers; with ``t_prev``
    each group writes into its own rows of it."""
    out = []
    for g in _groups(mult.shape[0]):
        grk = None if rk is None else (
            *rk[:3], rk[3][g], _part(rk[4], g), rk[5][g])
        gedges = None if edges is None else (edges[0][g], edges[1][g])
        out.append(launch(F[g], mult[g], _part(t_prev, g), axis, n, dxi, grk,
                          gedges))
    return t_prev if t_prev is not None else torch.cat(out)


def fct_mult(tr, positive, Fx, Fy, Fz, dt, dx, dy, dz):
    """Per-cell FCT multiplier (the ``mult`` of dynamics...h:498-509): 1
    where a cell's outgoing tracer mass over ``dt`` fits its available
    mass, mass_avail / mass_out where it would overdraw; 1 for the tracers
    whose ``positive`` flag is unset.

    Args:
      tr: (ntr, nens, nz, ny, nx) tracer masses, contiguous.
      positive: ntr host booleans (the registry's flags).
      Fx, Fy, Fz: unscaled tracer faces, (n + 1) along their direction;
        ``Fy`` is None in 2-D.
      dt: the stage's time step; dx, dy, dz: cell widths.

    Returns the multiplier, shaped like ``tr``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if not on_cuda(tr):
        return fct_mult_plain(tr, positive, Fx, Fy, Fz, dt, dx, dy, dz)
    ntr, nens, nz, ny, nx = _cells(tr)
    check_operand("tr", tr, tr, tr.shape)
    check_operand("Fx", Fx, tr, (ntr, nens, nz, ny, nx + 1))
    check_operand("Fz", Fz, tr, (ntr, nens, nz + 1, ny, nx))
    if Fy is not None:
        check_operand("Fy", Fy, tr, (ntr, nens, nz, ny + 1, nx))
    if ntr > MAX_TRACERS:
        return fct_mult_groups(fct_mult, tr, positive, Fx, Fy, Fz, dt, dx,
                               dy, dz)
    mask = _mask(positive, ntr)
    mult = torch.empty_like(tr)
    LIBRARY.launch("fct_mult", tr, tr.data_ptr(), Fx.data_ptr(), data_ptr(Fy),
                   Fz.data_ptr(), mult.data_ptr(), ntr, nens, nz, ny, nx, mask,
                   float(dt), float(dx), float(dy), float(dz),
                   float(dx * dy * dz), counter="fct_mult.launches")
    return mult


def fct_scale_div(F, mult, t_prev, axis, n, dxi, rk=None, edges=None):
    """FCT face scaling and tracer-flux divergence of one direction
    (dynamics...h:509-516), accumulated onto the previous directions'.

    Each face is scaled by its upwind cell's multiplier -- cell f-1 where
    F > 0, cell f where F < 0, 1 beyond either end of the axis (or the
    neighbours' multipliers in ``edges``) -- and
    ``acc = (fs_lo - fs_hi) * dxi``, plus ``t_prev`` when given.

    Args:
      F: (ntr, nens, nz, ny, nx) faces with ``n + 1`` entries along ``axis``.
      mult: (ntr, nens, nz, ny, nx) multiplier from ``fct_mult``.
      t_prev: the running tracer tendency (cell-shaped) or None.  When given
        the result is written into it IN PLACE and it is returned, as the
        JAX kernel donates that buffer to its output.
      axis: -1 (x), -2 (y) or -3 (z); ``n``: cells along it; ``dxi``: 1 / d.
      rk: None, or (c0, c1, cdt, tr0, tr1 | None, positive) for the SSPRK3
        tracer stage update of the last direction: v = c0*tr0 [+ c1*tr1] +
        cdt*acc, clamped at 0 for the tracers flagged positive.  The
        coefficients are host numbers; ``positive`` host booleans.
      edges: None, or (m_lo, m_hi) on a split axis: contiguous planes one
        cell thick along ``axis`` (else shaped like ``mult``) holding the
        multipliers of the cells beyond each end, the neighbour shards'
        boundary cells (``parallel/halo.exchange_face_scalar``).

    Returns the tendency (or the updated tracers with ``rk``).  CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    """
    if not on_cuda(F):
        return fct_scale_div_plain(F, mult, t_prev, axis, n, dxi, rk, edges)
    ntr, nens, nz, ny, nx = _cells(mult)
    if axis not in (_AX_X, _AX_Y, _AX_Z) or mult.shape[axis] != n or n < 1:
        raise ValueError(f"axis {axis} / n {n} do not match "
                         f"{tuple(mult.shape)}")
    if ntr > MAX_TRACERS:
        return fct_scale_div_groups(fct_scale_div, F, mult, t_prev, axis, n,
                                    dxi, rk, edges)
    check_operand("mult", mult, mult, mult.shape)
    fshape = list(mult.shape)
    fshape[axis] += 1
    check_operand("F", F, mult, fshape)
    if t_prev is not None:
        check_operand("t_prev", t_prev, mult, mult.shape)
        out = t_prev
    else:
        out = torch.empty_like(mult)
    c0 = c1 = cdt = 0.0
    tr0 = tr1 = None
    mask = 0
    if rk is not None:
        c0, c1, cdt, tr0, tr1, positive = rk
        check_operand("tr0", tr0, mult, mult.shape)
        if tr1 is not None:
            check_operand("tr1", tr1, mult, mult.shape)
        mask = _mask(positive, ntr)
    m_lo = m_hi = None
    if edges is not None:
        m_lo, m_hi = edges
        eshape = list(mult.shape)
        eshape[axis] = 1
        check_operand("m_lo", m_lo, mult, eshape)
        check_operand("m_hi", m_hi, mult, eshape)
    # (outer, n, inner) view of one direction, and outer indices per tracer
    if axis == _AX_X:
        outer, inner = ntr * nens * nz * ny, 1
    elif axis == _AX_Y:
        outer, inner = ntr * nens * nz, nx
    else:
        outer, inner = ntr * nens, ny * nx
    LIBRARY.launch("fct_scale_div", mult, F.data_ptr(), mult.data_ptr(),
                   data_ptr(t_prev), data_ptr(tr0), data_ptr(tr1),
                   data_ptr(m_lo), data_ptr(m_hi), out.data_ptr(), outer, n,
                   inner, outer // ntr, mask, float(c0), float(c1),
                   float(cdt), float(dxi), counter="fct_scale_div.launches")
    if edges is not None:
        count("fct_scale_div.edge_launches")
    return out
