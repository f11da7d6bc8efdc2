"""One direction of the dycore's flux computation: WENO reconstruction, face
boundary conditions, upwind Riemann fluxes and the state divergence.

``direction_fluxes`` is the entry point the dycore calls for x, y and z.  On
a CUDA tensor it launches the hand-written kernel ``csrc/direction_fluxes.cuh``
(the port of the Pallas megakernels ``direction_fluxes_pallas`` and
``direction_fluxes_pallas_sub`` of ``miniweatherml_tpu/ops/pallas_recon.py``);
on a CPU tensor it runs ``direction_fluxes_plain``, the plain PyTorch chain
that mirrors the JAX XLA path (``Dycore._recon_direction`` ->
``_apply_edge_bcs`` -> ``_riemann`` -> ``div``).  Both return

  * the state divergence ``-(F[f+1] - F[f]) * div_scale`` for the 5 state
    variables, shaped like the cells ``(5, nens, nz, ny, nx)``;
  * the unscaled tracer faces ``(ntr, ...)`` with ``n + 1`` entries along
    the direction (on a periodic axis face n is a second copy of face 0, so
    FCT can scale the two copies from their own sides).

The WENO limiter runs in one of the Pallas kernels' two algebras
(``_weno_edges``): the reference algebra (exact weights in the term order
of the JAX XLA path, ``weno_fused.reconstruct_edges_shifted``; the
default, and always when ``cutoff > 0``), or with ``opt`` the
reduced-operation algebra of the Pallas kernels' default form
(``weno_fused.reconstruct_edges_opt``).  With ``fast_weights`` in f32 on
the card either takes its reciprocals as the hardware's approximate
reciprocal: the opt algebra in ``csrc/direction_fluxes_opt.cu``, the
reference one in ``csrc/direction_fluxes_ref_fast.cu``, whose plain version
is ``weno_fused.reconstruct_edges_recip`` (the Pallas ``_weno_edges_block``:
each weight idl times a reciprocal); the plain versions are exact.
``limiter_algebra`` says which.

Two more forms carry the state side of an SSPRK3 stage, as the Pallas
kernel's ``acc`` and ``rk`` do: with ``acc`` (the running state tendency
of the earlier directions) the divergence is added into it in place; with
``rk`` (a ``StageUpdate``, the last direction) the sum then takes gravity,
Coriolis, the 2-D ``v = 0`` and the immersed blend, and becomes the stage's
state ``c0*b0 [+ c1*b1] + cdt*tendency`` in the ``acc`` buffer -- the
operations of the dycore's former eager composition, in its order.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..cuda_build import (DOUBLE, INT, PTR, KernelLibrary, check_operand,
                          data_ptr, on_cuda)
from ..utils.profiling import count
from .exact_div import exact_div
from .stencil import BC_PERIODIC, BC_WALL, pad_bc
from .weno import WenoMatrices
from .weno_fused import (opt_coef_table, reconstruct_edges_opt,
                         reconstruct_edges_recip, reconstruct_edges_shifted,
                         weno_coef_table)

__all__ = ["direction_fluxes", "direction_fluxes_plain", "in_tracer_groups",
           "limiter_algebra", "StageUpdate", "stage_update",
           "recon_direction", "apply_edge_bcs", "riemann", "div", "IDR",
           "IDU", "IDV", "IDW", "IDT", "NUM_STATE"]

IDR, IDU, IDV, IDW, IDT = 0, 1, 2, 3, 4
NUM_STATE = 5

# Frozen acoustic speed of the Riemann solver (reference dynamics...h:402).
_CS = 350.0

# Field axis of each direction on (nvar, nens, nz, ny, nx).
_AX_X, _AX_Y, _AX_Z = -1, -2, -3


def limiter_algebra(opt: bool, fast_weights: bool, cutoff: float,
                    dtype: torch.dtype) -> str:
    """The WENO algebra a call runs, picked as the Pallas kernels'
    ``_weno_edges`` picks it: the reference algebra (``opt`` off, or a
    cutoff), "ref_fast" with approximate reciprocals, else "ref"; the
    reduced-operation algebra, "fast" with approximate reciprocals, else
    "opt".  The approximate reciprocals are ``fast_weights`` in f32; f64
    runs exact, as the Pallas kernels do."""
    fast = fast_weights and dtype == torch.float32
    if not (opt and cutoff == 0.0):
        return "ref_fast" if fast else "ref"
    return "fast" if fast else "opt"


def recon_direction(prim, axis, n, bc, normal_id, mats: WenoMatrices,
                    cutoff: float = 0.0, strips=None, opt: bool = False,
                    fast_weights: bool = False):
    """WENO-reconstruct all vars along ``axis`` and map to faces: (L, R),
    the left/right limits at the n + 1 faces (dynamics...h:271-388 with the
    halo semantics of dynamics...h:574-827).  Wall halos zero the normal
    velocity.  ``strips`` = (lo, hi): the halo cells beyond each end of the
    axis (a shard's strips from its neighbours), in place of ``pad_bc``.
    ``opt`` / ``fast_weights``: the limiter algebra (``limiter_algebra``;
    exact reciprocals here)."""
    hp = (mats.ord - 1) // 2 + 1
    if strips is None:
        zv = normal_id if bc == BC_WALL else None
        padded = pad_bc(prim, axis, hp, bc, zero_var=zv)
    else:
        padded = torch.cat([strips[0], prim, strips[1]], dim=axis % prim.dim())
    algebra = limiter_algebra(opt, fast_weights, cutoff, prim.dtype)
    if algebra == "ref":
        gll_l, gll_r = reconstruct_edges_shifted(padded, axis, n + 2, mats,
                                                 cutoff)
    elif algebra == "ref_fast":
        gll_l, gll_r = reconstruct_edges_recip(padded, axis, n + 2, mats,
                                               cutoff)
    else:
        gll_l, gll_r = reconstruct_edges_opt(padded, axis, n + 2, mats.ord)
    L = gll_r.narrow(axis, 0, n + 1)   # face f <- right edge of cell f-1
    R = gll_l.narrow(axis, 1, n + 1)   # face f <- left edge of cell f
    return L, R


def apply_edge_bcs(SL, SR, TRL, TRR, axis, n, bc, normal_id, ends=None):
    """Physical-boundary overwrite of the face limits, in place
    (dynamics...h:1005-1081): the exterior limit copies the interior one at
    faces 0 and n; a wall also zeroes the normal momentum on both sides.
    ``ends`` = (bc_lo, bc_hi) gives each end its own mode, 0 for none (the
    shard ends inside the domain); default ``bc`` at both."""
    bc_lo, bc_hi = (bc, bc) if ends is None else ends
    for f, mode in ((0, bc_lo), (n, bc_hi)):
        if mode == BC_PERIODIC:
            continue
        if f == 0:
            SL.select(axis, 0).copy_(SR.select(axis, 0))
            TRL.select(axis, 0).copy_(TRR.select(axis, 0))
        else:
            SR.select(axis, n).copy_(SL.select(axis, n))
            TRR.select(axis, n).copy_(TRL.select(axis, n))
        if mode == BC_WALL:
            # axis is negative, so it names the same axis of F[normal_id]
            for F in (SL, SR):
                F[normal_id].select(axis, f).zero_()
    return SL, SR, TRL, TRR


def riemann(SL, SR, TRL, TRR, normal_id, C0, gamma):
    """Acoustic characteristic upwinding for pressure/normal momentum,
    advective upwinding for everything else (dynamics...h:395-474)."""
    ruL, ruR = SL[normal_id], SR[normal_id]
    pL = C0 * SL[IDT] ** gamma
    pR = C0 * SR[IDT] ** gamma
    w1 = 0.5 * (pR - _CS * ruR)
    w2 = 0.5 * (pL + _CS * ruL)
    p_upw = w1 + w2
    ru_upw = exact_div(w2 - w1, _CS)
    useL = (ruL + ruR) > 0.0
    q = torch.where(useL, SL, SR)
    r_upw = q[IDR]
    flux = ru_upw * q / r_upw
    flux[IDR] = ru_upw
    flux[normal_id] = flux[normal_id] + p_upw
    tr_flux = ru_upw * torch.where(useL, TRL, TRR) / r_upw
    return flux, tr_flux


def div(F, axis, n, div_scale):
    """Per-cell flux divergence -(F[f+1] - F[f]) * div_scale."""
    return -(F.narrow(axis, 1, n) - F.narrow(axis, 0, n)) * div_scale


class StageUpdate(NamedTuple):
    """The SSPRK3 stage update the last direction's call makes of the
    summed tendency (dynamics...h:110-175, 524-550).  The coefficients and
    ``grav``, ``fcor``, ``dt`` are host numbers."""

    c0: float
    c1: float
    cdt: float
    b0: torch.Tensor              # (5, nens, nz, ny, nx) the step's base
    b1: torch.Tensor | None       # the previous stage's state (stages 2-3)
    hy_r: torch.Tensor            # (nens, nz) hydrostatic cell density
    grav: float | None            # None: gravity off
    fcor: float                   # Coriolis parameter (0: none)
    immersed: torch.Tensor | None  # (nens, nz, ny, nx) proportion, or None
    dt: float                     # the stage's time step (immersed blend)
    sim2d: bool                   # 2-D: the v tendency is zero


def stage_update(st, rk: StageUpdate):
    """The stage's state from the summed tendency ``st`` (modified in
    place), with ``s`` the state the tendency was taken of (``b1`` when
    given, else ``b0``): w - grav (s_rho' + hy), u + fcor s_v and
    v - fcor s_u, v = 0 in 2-D, the immersed blend prop (fac s) + (1 - prop)
    st, then (c0 b0 + c1 b1) + cdt st."""
    s = rk.b0 if rk.b1 is None else rk.b1
    if rk.grav is not None:
        st[IDW] = st[IDW] - rk.grav * (s[IDR] + rk.hy_r[:, :, None, None])
    if rk.fcor != 0.0:
        st[IDU] = st[IDU] + rk.fcor * s[IDV]
        st[IDV] = st[IDV] - rk.fcor * s[IDU]
    if rk.sim2d:
        st[IDV] = 0.0
    if rk.immersed is not None:
        prop = rk.immersed[None]
        st = prop * (_immersed_fac(rk.dt) * s) + (1.0 - prop) * st
    out = rk.c0 * rk.b0
    if rk.b1 is not None:
        out = out + rk.c1 * rk.b1
    return out + rk.cdt * st


def _immersed_fac(dt: float) -> float:
    """Relaxation rate of the immersed blend, -min(1, dt / tau) / dt with
    tau = 1000 dt (dynamics...h:534-550)."""
    tau = 1.0e3 * dt
    return -min(1.0, dt / tau) / dt


def _epilogue(d, acc, rk):
    """The divergence ``d`` added into ``acc`` in place, and with ``rk``
    the stage's state written there instead."""
    if acc is None:
        return d
    if rk is None:
        return acc.add_(d)
    return acc.copy_(stage_update(acc + d, rk))


def direction_fluxes_plain(prim, axis, n, bc, normal_id, C0, gamma, hy_r,
                           hy_t, mats: WenoMatrices, cutoff, div_scale,
                           strips=None, acc=None, rk=None, opt=False,
                           fast_weights=False):
    """Plain PyTorch version of ``direction_fluxes`` (same arguments): with
    ``strips`` it concatenates lo | prim | hi in place of ``pad_bc`` and
    applies each end's face overwrite only where its mode is set, as the
    JAX XLA path does under ``shard_map`` (``euler.py:486-492, 511-546``).
    Its reciprocals are exact whatever ``fast_weights`` says."""
    if rk is not None and acc is None:
        raise ValueError("the stage update needs the accumulator acc")
    ends = None
    if strips is not None:
        lo, hi, bc_lo, bc_hi = strips
        strips, ends = (lo, hi), (bc_lo, bc_hi)
    L, R = recon_direction(prim, axis, n, bc, normal_id, mats, cutoff, strips,
                           opt, fast_weights)
    # Background state at faces (dynamics...h:286-295 for x, :368-377 z).
    hr = hy_r[:, :, None, None]
    ht = hy_t[:, :, None, None]
    rL = L[IDR] + hr
    rR = R[IDR] + hr
    SL = torch.stack([rL, L[IDU] * rL, L[IDV] * rL, L[IDW] * rL, L[IDT] + ht])
    SR = torch.stack([rR, R[IDU] * rR, R[IDV] * rR, R[IDW] * rR, R[IDT] + ht])
    TRL = L[NUM_STATE:] * rL
    TRR = R[NUM_STATE:] * rR
    SL, SR, TRL, TRR = apply_edge_bcs(SL, SR, TRL, TRR, axis, n, bc,
                                      normal_id, ends)
    SF, TF = riemann(SL, SR, TRL, TRR, normal_id, C0, gamma)
    return _epilogue(div(SF, axis, n, div_scale), acc, rk), TF


# Tracers one launch takes (the kernel's unrolled tracer loop is bounded by
# 9, the P3 path's count); more go through ``in_tracer_groups``.
MAX_TRACERS = 9


def in_tracer_groups(launch, prim, *args, strips=None, acc=None, rk=None,
                     **form):
    """``direction_fluxes`` of any number of tracers from a ``launch`` that
    takes at most ``MAX_TRACERS``: one call per group of tracers, each on
    the 5 state rows followed by the group's tracers (and strips built the
    same way).  A tracer's faces depend only on the state and on that tracer, so
    the state divergence of the first group and the groups' faces in order
    equal one call's bit for bit.  ``args`` are ``direction_fluxes``'s after
    ``prim``.  ``acc`` and ``rk`` go to the first group only: a later
    group adding into the same buffer would count the divergence twice;
    ``form`` (the limiter's ``opt`` / ``fast_weights``) goes to each."""
    ntr = prim.shape[0] - NUM_STATE
    epi = {k: v for k, v in (("acc", acc), ("rk", rk)) if v is not None}
    sdiv, faces = None, []
    for t0 in range(0, ntr, MAX_TRACERS):
        rows = slice(NUM_STATE + t0, NUM_STATE + min(t0 + MAX_TRACERS, ntr))

        def group(x):
            return torch.cat([x[:NUM_STATE], x[rows]])
        gstrips = None if strips is None else (
            group(strips[0]), group(strips[1]), *strips[2:])
        d, tf = launch(group(prim), *args, strips=gstrips,
                       **(epi if t0 == 0 else {}), **form)
        sdiv = d if sdiv is None else sdiv
        faces.append(tf)
    return sdiv, torch.cat(faces)


def _flux_library(name, stems, f32_only=()):
    """The kernel library ``csrc/<name>.cu``: the flux kernel's entry
    points, of the 35 parameters of csrc/direction_fluxes.cuh's
    ``DIRECTION_FLUXES_ENTRY``, and ``<name>_set_coef``, which copies one
    order's limiter table into the current device's constant memory."""
    params = ([PTR] * 7 + [INT] * 11 + [DOUBLE] * 4 + [INT] + [PTR] * 4
              + [INT] + [DOUBLE] * 6)
    return KernelLibrary(name, dict.fromkeys(stems, params),
                         {f"{name}_set_coef": ([INT, PTR, INT], INT)},
                         f32_only)


# The libraries of the limiter algebras.  The reduced-operation library
# holds both of its forms; the reference algebra with approximate
# reciprocals has a library of its own, so that it builds beside the other
# two.
LIBRARIES = {lib.name: lib for lib in (
    _flux_library("direction_fluxes", ["direction_fluxes"]),
    _flux_library("direction_fluxes_opt",
                  ["direction_fluxes_opt", "direction_fluxes_fast"],
                  f32_only=["direction_fluxes_fast"]),
    _flux_library("direction_fluxes_ref_fast", ["direction_fluxes_ref_fast"],
                  f32_only=["direction_fluxes_ref_fast"]))}
# algebra -> (its library, its limiter table, its kernel stem)
_ALGEBRAS = {
    "ref": (LIBRARIES["direction_fluxes"], weno_coef_table,
            "direction_fluxes"),
    "opt": (LIBRARIES["direction_fluxes_opt"], opt_coef_table,
            "direction_fluxes_opt"),
    "fast": (LIBRARIES["direction_fluxes_opt"], opt_coef_table,
             "direction_fluxes_fast"),
    "ref_fast": (LIBRARIES["direction_fluxes_ref_fast"], weno_coef_table,
                 "direction_fluxes_ref_fast"),
}
# (build, device index) pairs whose constant memory holds the tables
_coef_devices: set[tuple[str, int]] = set()
_coef_lock = threading.Lock()  # the shards of a mesh run launch from threads


def _algebra_library(device: torch.device, algebra: str):
    """(library, kernel stem) of the algebra, with the limiter tables of
    every order copied into the device's constant memory on the first
    launch of each build there.  A library that does not build raises: no
    algebra stands in for another."""
    lib, table_of, stem = _ALGEBRAS[algebra]
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (lib.path, index)
    with _coef_lock:
        if key not in _coef_devices:
            with torch.cuda.device(index):
                for ord_ in (3, 5, 7, 9):
                    table = np.ascontiguousarray(table_of(ord_),
                                                 dtype=np.float64)
                    lib.call(f"{lib.name}_set_coef", ord_, table.ctypes.data,
                             table.size)
            _coef_devices.add(key)
    return lib, stem


# flags of the stage epilogue (csrc/direction_fluxes.cuh, EPI_STAGE)
_GRAV, _FCOR, _SIM2D = 1, 2, 4


def _stage_args(rk, prim, cells):
    """The stage epilogue's pointers (b0, b1, hy_r, immersed), flags and
    coefficients (c0, c1, cdt, grav, fcor, immersed rate) for the launch;
    null pointers and zeros without ``rk``."""
    if rk is None:
        return (None,) * 4 + (0,) + (0.0,) * 6
    nens, nz = cells[1], cells[2]
    check_operand("b0", rk.b0, prim, cells)
    if rk.b1 is not None:
        check_operand("b1", rk.b1, prim, cells)
    check_operand("hy_r", rk.hy_r, prim, (nens, nz))
    if rk.immersed is not None:
        check_operand("immersed", rk.immersed, prim, cells[1:])
    flags = ((_GRAV if rk.grav is not None else 0)
             | (_FCOR if rk.fcor != 0.0 else 0) | (_SIM2D if rk.sim2d else 0))
    return (rk.b0.data_ptr(), data_ptr(rk.b1), rk.hy_r.data_ptr(),
            data_ptr(rk.immersed), flags, float(rk.c0), float(rk.c1),
            float(rk.cdt), float(rk.grav or 0.0), float(rk.fcor),
            _immersed_fac(rk.dt) if rk.immersed is not None else 0.0)


def direction_fluxes(prim, axis, n, bc, normal_id, C0, gamma, hy_r, hy_t,
                     mats: WenoMatrices, cutoff, div_scale, strips=None,
                     acc=None, rk=None, opt=False, fast_weights=False):
    """State divergence and tracer faces of one direction.

    Args:
      prim: (5 + ntr, nens, nz, ny, nx) de-densitized variables (rho', u, v,
        w, (rho theta)', tracer concentrations), contiguous.
      axis: -1 (x), -2 (y) or -3 (z); ``n`` is the length of that axis.
      bc: BC_PERIODIC / BC_OPEN / BC_WALL; normal_id: normal momentum index.
      C0, gamma: pressure law p = C0 (rho theta)^gamma.
      hy_r, hy_t: hydrostatic density and density*theta, (nens, nz) cell
        profiles for x and y, (nens, nz + 1) face profiles for z.
      mats: WENO tables of the order; cutoff: low-order weight cutoff.
      div_scale: 1 / cell width along the direction.
      strips: None (the whole axis: the halo cells come from the block's own
        edges by ``bc``), or (lo, hi, bc_lo, bc_hi) on a split x or y axis
        (the halo-strip form): lo / hi hold the hp = (ord - 1) // 2 + 1
        cells beyond each end (shaped like ``prim`` with hp along ``axis``,
        contiguous), and bc_lo / bc_hi (host ints) each end's face mode,
        0 inside the domain or periodic, else ``bc``.
      acc: None, or the running state tendency (5, nens, nz, ny, nx),
        contiguous: the divergence is added into it IN PLACE and it is
        returned in the divergence's place (the Pallas kernel's ``acc``,
        whose buffer is aliased to its output).  On the card y and z only:
        x is the first direction.
      rk: None, or a ``StageUpdate`` (needs ``acc``): ``acc`` then receives
        the stage's state (see ``stage_update``; the Pallas kernel's
        ``rk``).  Its tensors are contiguous, of ``prim``'s type.
      opt, fast_weights: the limiter algebra, the Pallas kernels' keywords
        (``limiter_algebra``): with ``opt`` (and cutoff 0) the
        reduced-operation algebra, else the reference one; with
        ``fast_weights`` in f32 on the card either takes the hardware's
        approximate reciprocals.

    Returns (state divergence (5, nens, nz, ny, nx) -- or ``acc`` --, tracer
    faces).  CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    if not on_cuda(prim):
        return direction_fluxes_plain(prim, axis, n, bc, normal_id, C0, gamma,
                                      hy_r, hy_t, mats, cutoff, div_scale,
                                      strips, acc, rk, opt, fast_weights)
    if prim.dim() != 5 or prim.shape[0] < NUM_STATE:
        raise ValueError(f"prim must be (5+ntr, nens, nz, ny, nx), got "
                         f"{tuple(prim.shape)}")
    check_operand("prim", prim, prim)
    nvar, nens, nz, ny, nx = prim.shape
    if axis not in (_AX_X, _AX_Y, _AX_Z) or prim.shape[axis] != n:
        raise ValueError(f"axis {axis} / n {n} do not match {tuple(prim.shape)}")
    if bc not in (0, 1, 2) or normal_id not in (IDU, IDV, IDW):
        raise ValueError(f"bad bc {bc} or normal_id {normal_id}")
    nlev = nz + 1 if axis == _AX_Z else nz
    for name, t in (("hy_r", hy_r), ("hy_t", hy_t)):
        check_operand(name, t, prim, (nens, nlev))
    ntr = nvar - NUM_STATE
    if mats.ord not in (3, 5, 7, 9):
        raise ValueError(f"WENO order {mats.ord} is not 3, 5, 7 or 9")
    algebra = limiter_algebra(opt, fast_weights, cutoff, prim.dtype)
    if ntr > MAX_TRACERS:
        return in_tracer_groups(direction_fluxes, prim, axis, n, bc,
                                normal_id, C0, gamma, hy_r, hy_t, mats,
                                cutoff, div_scale, strips=strips, acc=acc,
                                rk=rk, opt=opt, fast_weights=fast_weights)
    lo = hi = None
    bc_lo = bc_hi = bc  # whole axis: both ends are the global boundary
    if strips is not None:
        lo, hi, bc_lo, bc_hi = strips
        if axis == _AX_Z:
            raise ValueError("z is never split: the kernel takes no strips "
                             "along it")
        if bc_lo not in (0, bc) or bc_hi not in (0, bc):
            raise ValueError(f"end modes ({bc_lo}, {bc_hi}) must be 0 or the "
                             f"axis bc {bc}")
        sshape = list(prim.shape)
        sshape[axis] = (mats.ord - 1) // 2 + 1
        for name, t in (("lo", lo), ("hi", hi)):
            check_operand(name, t, prim, sshape)
    cells = (NUM_STATE, nens, nz, ny, nx)
    if rk is not None and acc is None:
        raise ValueError("the stage update needs the accumulator acc")
    if acc is not None:
        if axis == _AX_X:
            raise ValueError("the x kernel takes no accumulator: x is the "
                             "first direction")
        check_operand("acc", acc, prim, cells)
        sdiv = acc
    else:
        sdiv = torch.empty(cells, dtype=prim.dtype, device=prim.device)
    stage = _stage_args(rk, prim, cells)
    if rk is not None and any(b is not None and b.data_ptr() == acc.data_ptr()
                              for b in (rk.b0, rk.b1)):
        raise ValueError("acc must not be b0 or b1: the kernel reads the "
                         "bases of a cell after writing its first variables")
    tshape = [ntr, nens, nz, ny, nx]
    tshape[axis] += 1
    tf = torch.empty(tshape, dtype=prim.dtype, device=prim.device)
    lib, stem = _algebra_library(prim.device, algebra)
    lib.launch(stem, prim, prim.data_ptr(), hy_r.data_ptr(), hy_t.data_ptr(),
               sdiv.data_ptr(), tf.data_ptr(), data_ptr(lo), data_ptr(hi),
               -1 - axis, nvar, nens, nz, ny, nx, bc, bc_lo, bc_hi,
               normal_id, mats.ord, float(C0), float(gamma), float(cutoff),
               float(div_scale), int(acc is not None), *stage,
               counter="direction_fluxes.launches")
    if axis != _AX_X:  # y and z run the tiled kernel (fluxes_tiled)
        count("direction_fluxes.tiled_launches")
    if strips is not None:
        count("direction_fluxes.strip_launches")
    if algebra != "ref":
        count(f"direction_fluxes.{algebra}_launches")
    return sdiv, tf
