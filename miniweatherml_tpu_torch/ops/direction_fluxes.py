"""One direction of the dycore's flux computation: WENO reconstruction, face
boundary conditions, upwind Riemann fluxes and the state divergence.

``direction_fluxes`` is the entry point the dycore calls for x, y and z.  On
a CUDA tensor it launches the hand-written kernel ``csrc/direction_fluxes.cu``
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
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..cuda_build import count_launch
from .stencil import BC_PERIODIC, BC_WALL, pad_bc
from .weno import WenoMatrices
from .weno_fused import reconstruct_edges_shifted, weno_coef_table

__all__ = ["direction_fluxes", "direction_fluxes_plain", "in_tracer_groups",
           "recon_direction", "apply_edge_bcs", "riemann", "div",
           "IDR", "IDU", "IDV", "IDW", "IDT", "NUM_STATE"]

IDR, IDU, IDV, IDW, IDT = 0, 1, 2, 3, 4
NUM_STATE = 5

# Frozen acoustic speed of the Riemann solver (reference dynamics...h:402).
_CS = 350.0

# Field axis of each direction on (nvar, nens, nz, ny, nx).
_AX_X, _AX_Y, _AX_Z = -1, -2, -3


def recon_direction(prim, axis, n, bc, normal_id, mats: WenoMatrices,
                    cutoff: float = 0.0, strips=None):
    """WENO-reconstruct all vars along ``axis`` and map to faces: (L, R),
    the left/right limits at the n + 1 faces (dynamics...h:271-388 with the
    halo semantics of dynamics...h:574-827).  Wall halos zero the normal
    velocity.  ``strips`` = (lo, hi): the halo cells beyond each end of the
    axis (a shard's strips from its neighbours), in place of ``pad_bc``."""
    hp = (mats.ord - 1) // 2 + 1
    if strips is None:
        zv = normal_id if bc == BC_WALL else None
        padded = pad_bc(prim, axis, hp, bc, zero_var=zv)
    else:
        padded = torch.cat([strips[0], prim, strips[1]], dim=axis % prim.dim())
    gll_l, gll_r = reconstruct_edges_shifted(padded, axis, n + 2, mats, cutoff)
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
    # a 0-d device denominator keeps the division exact on the GPU too
    ru_upw = torch.div(w2 - w1, w1.new_full((), _CS))
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


def direction_fluxes_plain(prim, axis, n, bc, normal_id, C0, gamma, hy_r,
                           hy_t, mats: WenoMatrices, cutoff, div_scale,
                           strips=None):
    """Plain PyTorch version of ``direction_fluxes`` (same arguments): with
    ``strips`` it concatenates lo | prim | hi in place of ``pad_bc`` and
    applies each end's face overwrite only where its mode is set, as the
    JAX XLA path does under ``shard_map`` (``euler.py:486-492, 511-546``)."""
    ends = None
    if strips is not None:
        lo, hi, bc_lo, bc_hi = strips
        strips, ends = (lo, hi), (bc_lo, bc_hi)
    L, R = recon_direction(prim, axis, n, bc, normal_id, mats, cutoff, strips)
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
    return div(SF, axis, n, div_scale), TF


# Tracers one launch takes (the kernel's unrolled tracer loop is bounded by
# 9, the P3 path's count); more go through ``in_tracer_groups``.
MAX_TRACERS = 9


def in_tracer_groups(launch, prim, *args, strips=None):
    """``direction_fluxes`` of any number of tracers from a ``launch`` that
    takes at most ``MAX_TRACERS``: one call per group of tracers, each on
    the 5 state rows followed by the group's tracers (and strips built the
    same way).  A tracer's faces depend only on the state and on that tracer, so
    the state divergence of the first group and the groups' faces in order
    equal one call's bit for bit.  ``args`` are ``direction_fluxes``'s after
    ``prim``."""
    ntr = prim.shape[0] - NUM_STATE
    sdiv, faces = None, []
    for t0 in range(0, ntr, MAX_TRACERS):
        rows = slice(NUM_STATE + t0, NUM_STATE + min(t0 + MAX_TRACERS, ntr))

        def group(x):
            return torch.cat([x[:NUM_STATE], x[rows]])
        gstrips = None if strips is None else (
            group(strips[0]), group(strips[1]), *strips[2:])
        d, tf = launch(group(prim), *args, strips=gstrips)
        sdiv = d if sdiv is None else sdiv
        faces.append(tf)
    return sdiv, torch.cat(faces)


def _bind(lib):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("direction_fluxes_f32", "direction_fluxes_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 7 + [I] * 11 + [D] * 4 + [P]
        fn.restype = I
    lib.direction_fluxes_set_coef.argtypes = [I, P, I]
    lib.direction_fluxes_set_coef.restype = I
    lib.direction_fluxes_error_string.argtypes = [I]
    lib.direction_fluxes_error_string.restype = ctypes.c_char_p
    return lib


_lib = None
_coef_devices: set[int] = set()
_coef_lock = threading.Lock()  # the shards of a mesh run launch from threads


def _library(device: torch.device):
    """The kernel's library, with the limiter tables of every order copied
    into the device's constant memory on first use."""
    global _lib
    if _lib is None:
        from ..cuda_build import load_library
        _lib = _bind(load_library("direction_fluxes"))
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _coef_lock:
        if index not in _coef_devices:
            with torch.cuda.device(index):
                for ord_ in (3, 5, 7, 9):
                    table = np.ascontiguousarray(weno_coef_table(ord_),
                                                 dtype=np.float64)
                    rc = _lib.direction_fluxes_set_coef(
                        ord_, table.ctypes.data, table.size)
                    if rc != 0:
                        raise RuntimeError(
                            "direction_fluxes coefficient copy failed: "
                            + _lib.direction_fluxes_error_string(rc).decode())
            _coef_devices.add(index)
    return _lib


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def direction_fluxes(prim, axis, n, bc, normal_id, C0, gamma, hy_r, hy_t,
                     mats: WenoMatrices, cutoff, div_scale, strips=None):
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

    Returns (state divergence (5, nens, nz, ny, nx), tracer faces).  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if prim.device.type == "cpu":
        return direction_fluxes_plain(prim, axis, n, bc, normal_id, C0, gamma,
                                      hy_r, hy_t, mats, cutoff, div_scale,
                                      strips)
    if prim.device.type != "cuda":
        raise ValueError(f"unsupported device {prim.device}")
    if prim.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"prim dtype {prim.dtype} is not float32/float64")
    if prim.dim() != 5 or prim.shape[0] < NUM_STATE:
        raise ValueError(f"prim must be (5+ntr, nens, nz, ny, nx), got "
                         f"{tuple(prim.shape)}")
    if not prim.is_contiguous():
        raise ValueError("prim must be contiguous")
    nvar, nens, nz, ny, nx = prim.shape
    if axis not in (_AX_X, _AX_Y, _AX_Z) or prim.shape[axis] != n:
        raise ValueError(f"axis {axis} / n {n} do not match {tuple(prim.shape)}")
    if bc not in (0, 1, 2) or normal_id not in (IDU, IDV, IDW):
        raise ValueError(f"bad bc {bc} or normal_id {normal_id}")
    nlev = nz + 1 if axis == _AX_Z else nz
    for name, t in (("hy_r", hy_r), ("hy_t", hy_t)):
        _check_cuda(name, t, prim.dtype, (nens, nlev), prim.device)
    ntr = nvar - NUM_STATE
    if mats.ord not in (3, 5, 7, 9):
        raise ValueError(f"WENO order {mats.ord} is not 3, 5, 7 or 9")
    if ntr > MAX_TRACERS:
        return in_tracer_groups(direction_fluxes, prim, axis, n, bc,
                                normal_id, C0, gamma, hy_r, hy_t, mats,
                                cutoff, div_scale, strips=strips)
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
            _check_cuda(name, t, prim.dtype, sshape, prim.device)
    sdiv = torch.empty((NUM_STATE, nens, nz, ny, nx), dtype=prim.dtype,
                       device=prim.device)
    tshape = [ntr, nens, nz, ny, nx]
    tshape[axis] += 1
    tf = torch.empty(tshape, dtype=prim.dtype, device=prim.device)
    lib = _library(prim.device)
    fn = (lib.direction_fluxes_f32 if prim.dtype == torch.float32
          else lib.direction_fluxes_f64)
    stream = torch.cuda.current_stream(prim.device).cuda_stream
    rc = fn(prim.data_ptr(), hy_r.data_ptr(), hy_t.data_ptr(),
            sdiv.data_ptr(), tf.data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), -1 - axis, nvar, nens, nz,
            ny, nx, bc, bc_lo, bc_hi, normal_id, mats.ord, float(C0),
            float(gamma), float(cutoff), float(div_scale), stream)
    if rc != 0:
        raise RuntimeError("direction_fluxes kernel launch failed: "
                           + lib.direction_fluxes_error_string(rc).decode())
    count_launch(direction_fluxes)
    if strips is not None:
        count_launch(direction_fluxes, "strip_launches")
    return sdiv, tf


# launches of the kernel, and of its halo-strip form among them
direction_fluxes.launches = 0
direction_fluxes.strip_launches = 0
