"""The dycore's per-cell state transforms: the de-densitization of the
conserved state that the direction-flux kernels read, and the conversions
between the coupler's fields and the dycore's state, both ways.

``dedensitize`` forms prim = [rho', u, v, w, (rho theta)', tracer
concentrations] from the conserved state and the tracer masses, once per
right-hand side (dynamics...h:248-255).  ``coupler_to_dynamics`` turns the
coupler's dry density, velocities, temperature and tracer masses into the
conserved state and the tracer stack; ``dynamics_to_coupler`` turns them
back into the coupler's five fields (dynamics...h:1891-2015); the coupler's
tracers are the stack's rows.  On a CUDA tensor each launches one kernel of
``csrc/dycore_state.cu`` that reads every input field once and writes every
output once; on a CPU tensor it runs its plain version.  The plain versions
are the expressions the dycore ran as eager PyTorch, with two changes that
let a kernel match them bit for bit: a division by a number goes through a
0-d tensor (``exact_div``; on the GPU ``tensor / number`` multiplies by a
rounded reciprocal), and the tracers that add mass are summed left to right
in registry order (``_mass``), where a reduction over the whole stack with
the others zeroed summed in PyTorch's order.

Thermodynamic keywords of the conversions: ``idWV`` (the vapor tracer's
index), ``adds_mass`` (the registry's flags, one per tracer), ``R_d``,
``R_v``, ``gamma`` and ``C0`` (host numbers, the state's options).
"""

from __future__ import annotations

import torch

from ..cuda_build import (DOUBLE, INT, LONG, PTR, PTRS, U64, KernelLibrary,
                          check_operand, check_operands, on_cuda,
                          pointers)
from .direction_fluxes import IDR, IDT, IDU, IDV, IDW, NUM_STATE
from .exact_div import exact_div
from .fct import MAX_TRACERS

__all__ = ["dedensitize", "dedensitize_plain", "coupler_to_dynamics",
           "coupler_to_dynamics_plain", "dynamics_to_coupler",
           "dynamics_to_coupler_plain"]

# Exponents that PyTorch's ``tensor ** number`` on the GPU computes without
# pow (a fill, a copy, sqrt, rsqrt, a reciprocal or products), which the
# kernels' pow would not match.
_POW_SPECIAL = (0.0, 1.0, 2.0, 3.0, -2.0, 0.5, -0.5, -1.0)


def _mass(tracers, adds_mass):
    """The tracers that add mass, summed left to right in registry order;
    None when none does."""
    m = None
    for t, adds in zip(tracers, adds_mass):
        if adds:
            m = t if m is None else m + t
    return m


def dedensitize_plain(s, tr, hyc):
    """Plain PyTorch version of ``dedensitize`` (same arguments)."""
    full_r = s[IDR] + hyc[:, :, None, None]
    return torch.cat([s[IDR:IDU], s[IDU:IDT] / full_r, s[IDT:IDT + 1],
                      tr / full_r])


def coupler_to_dynamics_plain(rho_d, u, v, w, temp, tracers, hyc, hyt, *,
                              idWV, adds_mass, R_d, R_v, gamma, C0):
    """Plain PyTorch version of ``coupler_to_dynamics`` (same arguments)."""
    hyc = hyc[:, :, None, None]
    hyt = hyt[:, :, None, None]
    rho_v = tracers[idWV]
    press = rho_d * R_d * temp + rho_v * R_v * temp
    m = _mass(tracers, adds_mass)
    rho = rho_d if m is None else rho_d + m
    theta = exact_div(press, C0) ** (1.0 / gamma) / rho
    s = torch.stack([rho - hyc, rho * u, rho * v, rho * w,
                     rho * theta - hyt])
    return s, torch.stack(list(tracers))


def dynamics_to_coupler_plain(s, tr, hyc, hyt, *, idWV, adds_mass, R_d, R_v,
                              gamma, C0):
    """Plain PyTorch version of ``dynamics_to_coupler`` (same arguments)."""
    rho = s[IDR] + hyc[:, :, None, None]
    u, v, w = s[IDU] / rho, s[IDV] / rho, s[IDW] / rho
    theta = (s[IDT] + hyt[:, :, None, None]) / rho
    press = C0 * (rho * theta) ** gamma
    m = _mass(tr, adds_mass)
    rho_d = rho if m is None else rho - m
    temp = press / (rho_d * R_d + tr[idWV] * R_v)
    return rho_d, u, v, w, temp


LIBRARY = KernelLibrary("dycore_state", {
    "dyn_prim": [PTR, PTR, PTR, PTR, INT, LONG, INT],
    "dyn_from_coupler": [PTRS, PTRS, PTR, PTR, PTR, PTR, INT, U64, INT]
    + [DOUBLE] * 4 + [LONG, INT],
    "dyn_to_coupler": [PTR, PTR, PTR, PTR, PTRS, INT, U64, INT]
    + [DOUBLE] * 4 + [LONG, INT]})
_COUNTER = "dycore_state.launches"


def _field_shape(x, ndim, what):
    """The trailing (nens, nz, ny, nx) of ``x``, which must have ``ndim``
    dimensions."""
    if x.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dimensions, got shape "
                         f"{tuple(x.shape)}")
    return tuple(x.shape[-4:])


def _stack(name, x, like, shape):
    """The length of ``x``, which must be a contiguous (k, *shape) stack of
    ``like``'s dtype and device."""
    k = x.shape[0] if x.dim() == len(shape) + 1 else -1
    check_operand(name, x, like, (k,) + shape)
    return k


def _hydrostatic(hyc, hyt, like, shape):
    for name, h in (("hyc", hyc), ("hyt", hyt)):
        if h is not None:
            check_operand(name, h, like, shape[:2])


def _registry(ntr, idWV, adds_mass, *exponents, dtype):
    """The mass flags as a 64-bit mask; raises on what the conversion
    kernels do not take."""
    if not 1 <= ntr <= MAX_TRACERS:
        raise ValueError(f"a conversion takes 1 to {MAX_TRACERS} tracers, "
                         f"got {ntr}")
    if not 0 <= idWV < ntr:
        raise ValueError(f"vapor index {idWV} outside {ntr} tracers")
    if len(adds_mass) != ntr:
        raise ValueError(f"{len(adds_mass)} adds_mass flags for {ntr} "
                         "tracers")
    for e in exponents:
        if (float(e) in _POW_SPECIAL
                or torch.tensor(e, dtype=dtype).item() in _POW_SPECIAL):
            raise ValueError(f"exponent {e} takes a special case of "
                             "PyTorch's pow, which the kernels do not")
    return sum(1 << i for i, adds in enumerate(adds_mass) if adds)


def dedensitize(s, tr, hyc):
    """The de-densitized variables the direction fluxes read.

    Args:
      s: (5, nens, nz, ny, nx) conserved state: rho', rho u, rho v, rho w,
        (rho theta)'.
      tr: (ntr, nens, nz, ny, nx) tracer masses (ntr may be 0).
      hyc: (nens, nz) hydrostatic density of the cells.

    Returns prim, (5 + ntr, nens, nz, ny, nx), contiguous: [rho', u, v, w,
    (rho theta)', tr / rho] with rho = rho' + hyc, each quotient an IEEE
    division.  CPU tensors take the plain version; CUDA tensors launch
    ``dyn_prim_kernel``, and every argument must then be contiguous, of
    ``s``'s dtype and device.
    """
    if not on_cuda(s):
        return dedensitize_plain(s, tr, hyc)
    shape = _field_shape(s, 5, "s")
    check_operand("s", s, s, (NUM_STATE,) + shape)
    ntr = _stack("tr", tr, s, shape)
    _hydrostatic(hyc, None, s, shape)
    prim = torch.empty((NUM_STATE + ntr,) + shape, dtype=s.dtype,
                       device=s.device)
    plane = shape[2] * shape[3]
    LIBRARY.launch("dyn_prim", s, s.data_ptr(), tr.data_ptr() if ntr else None,
                   hyc.data_ptr(), prim.data_ptr(), ntr, plane,
                   shape[0] * shape[1], counter=_COUNTER)
    return prim


def coupler_to_dynamics(rho_d, u, v, w, temp, tracers, hyc, hyt, *, idWV,
                        adds_mass, R_d, R_v, gamma, C0):
    """The dycore's conserved state and tracer stack from the coupler's
    fields.

    Args:
      rho_d, u, v, w, temp: (nens, nz, ny, nx) dry density, velocities and
        temperature.
      tracers: the ntr tracer masses, each (nens, nz, ny, nx), in registry
        order (separate tensors).
      hyc, hyt: (nens, nz) hydrostatic density and density-theta.
      idWV, adds_mass, R_d, R_v, gamma, C0: see the module docstring.

    Returns (s, tr): the (5, nens, nz, ny, nx) state and the (ntr, nens,
    nz, ny, nx) stack of the tracers.  CPU tensors take the plain version;
    CUDA tensors launch ``dyn_from_coupler_kernel`` (1 to ``MAX_TRACERS``
    tracers; every field contiguous, of ``rho_d``'s dtype and device).
    """
    if not on_cuda(rho_d):
        return coupler_to_dynamics_plain(
            rho_d, u, v, w, temp, tracers, hyc, hyt, idWV=idWV,
            adds_mass=adds_mass, R_d=R_d, R_v=R_v, gamma=gamma, C0=C0)
    shape = _field_shape(rho_d, 4, "rho_d")
    fields = (rho_d, u, v, w, temp)
    for name, f in zip(("rho_d", "u", "v", "w", "temp"), fields):
        check_operand(name, f, rho_d, shape)
    check_operands("tracer", tracers, rho_d, shape)
    _hydrostatic(hyc, hyt, rho_d, shape)
    ntr = len(tracers)
    mass = _registry(ntr, idWV, adds_mass, 1.0 / gamma, dtype=rho_d.dtype)
    s = torch.empty((NUM_STATE,) + shape, dtype=rho_d.dtype,
                    device=rho_d.device)
    tr = torch.empty((ntr,) + shape, dtype=rho_d.dtype, device=rho_d.device)
    LIBRARY.launch("dyn_from_coupler", rho_d, pointers(fields),
                   pointers(tracers), hyc.data_ptr(), hyt.data_ptr(),
                   s.data_ptr(), tr.data_ptr(), ntr, mass, idWV, float(R_d),
                   float(R_v), float(1.0 / gamma), float(C0),
                   shape[2] * shape[3], shape[0] * shape[1],
                   counter=_COUNTER)
    return s, tr


def dynamics_to_coupler(s, tr, hyc, hyt, *, idWV, adds_mass, R_d, R_v,
                        gamma, C0):
    """The coupler's dry density, velocities and temperature from the
    dycore's state and tracer stack.

    Args:
      s: (5, nens, nz, ny, nx) conserved state; tr: (ntr, nens, nz, ny, nx)
        tracer masses (the coupler's tracers are its rows).
      hyc, hyt: (nens, nz) hydrostatic density and density-theta.
      idWV, adds_mass, R_d, R_v, gamma, C0: see the module docstring.

    Returns (rho_d, u, v, w, temp), each (nens, nz, ny, nx).  CPU tensors
    take the plain version; CUDA tensors launch ``dyn_to_coupler_kernel``
    (1 to ``MAX_TRACERS`` tracers; every argument contiguous, of ``s``'s
    dtype and device), which reads only the tracers that add mass and
    vapor.
    """
    if not on_cuda(s):
        return dynamics_to_coupler_plain(
            s, tr, hyc, hyt, idWV=idWV, adds_mass=adds_mass, R_d=R_d,
            R_v=R_v, gamma=gamma, C0=C0)
    shape = _field_shape(s, 5, "s")
    check_operand("s", s, s, (NUM_STATE,) + shape)
    ntr = _stack("tr", tr, s, shape)
    _hydrostatic(hyc, hyt, s, shape)
    mass = _registry(ntr, idWV, adds_mass, gamma, dtype=s.dtype)
    outs = [torch.empty(shape, dtype=s.dtype, device=s.device)
            for _ in range(NUM_STATE)]
    LIBRARY.launch("dyn_to_coupler", s, s.data_ptr(), tr.data_ptr(),
                   hyc.data_ptr(), hyt.data_ptr(), pointers(outs), ntr, mass,
                   idWV, float(R_d), float(R_v), float(gamma), float(C0),
                   shape[2] * shape[3], shape[0] * shape[1],
                   counter=_COUNTER)
    return tuple(outs)
