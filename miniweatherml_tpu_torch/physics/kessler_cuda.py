"""One Kessler time step on the coupler's fields, and its sub-cycle count's
largest stable step: CUDA kernels and plain versions.

``kessler_step`` forms the mixing ratios, exner and theta from the coupler's
densities and temperature, runs ``rainsplit`` passes of the KW1978 column
physics, and returns the new densities, temperature and precipitation rate.
On a CUDA tensor it launches ``csrc/kessler.cu`` (the port of the Pallas
kernel ``miniweatherml_tpu/physics/kessler_pallas.py::kessler_subcycle_pallas``
with the prep and post that call fused into its reads) with ``rainsplit``
read on the device; on a CPU tensor it runs ``kessler_step_plain``: the same
prep, ``kessler_subcycle_plain`` (the loop of ``kessler_column`` with a
uniform dz) and the same post.  ``kessler_pass`` is the one pass both plain
loops share.  Every division by a number goes through ``exact_div``, so the
plain version and the kernel divide alike on the card.

``min_step`` is the field work of the sub-cycle count: min(dt, the minimum
over cells below the top of 0.8 dz_lev / v), a 0-d tensor.  On a CUDA tensor
it launches ``kessler_min_step`` in the same file (one reduction with an
atomic min, the port of the field work of the JAX package's
``kessler_rainsplit``, which XLA fuses); on a CPU tensor
``min_step_plain``.  ``step_plain`` is the arithmetic both plain forms share.
"""

from __future__ import annotations

import torch

from ..cuda_build import (DOUBLE, INT, LONG, PTR, KernelLibrary,
                          check_operand, on_cuda)
from ..ops.exact_div import exact_div

__all__ = ["kessler_step", "kessler_step_plain", "kessler_subcycle_plain",
           "kessler_pass", "kessler_staging", "terminal_velocity",
           "min_step", "min_step_plain", "step_plain"]

_RHOQR = 1000.0  # liquid water density
_LV = 2.5e6      # latent heat of vaporization


def _ax(a, z_axis, start, length):
    return a.narrow(z_axis, start, length)


def terminal_velocity(qr, r, rhalf):
    """Rain fall speed, KW eq. 2.15 (reference microphysics_kessler.h:260,331)."""
    return 36.34 * (qr * r) ** 0.1364 * rhalf


def step_plain(qr, rho, z, dt, z_axis):
    """min(dt, the minimum over cells below the top of 0.8 dz_lev / velqr
    where velqr > 1e-10), a 0-d tensor (reference
    microphysics_kessler.h:262-280): the largest stable sub-step."""
    nz = qr.shape[z_axis]
    r = 0.001 * rho
    rhalf = torch.sqrt(rho.narrow(z_axis, 0, 1) / rho)
    velqr = terminal_velocity(qr, r, rhalf)
    dz_lev = z.narrow(z_axis, 1, nz - 1) - z.narrow(z_axis, 0, nz - 1)
    vel_lo = velqr.narrow(z_axis, 0, nz - 1)
    dt2d = torch.where(vel_lo > 1e-10, 0.8 * dz_lev / vel_lo, dt)
    return torch.clamp(torch.amin(dt2d), max=dt)


def min_step_plain(rho_r, rho_d, dt, dz):
    """Plain version of ``min_step``: the level midpoints (k + 0.5) dz in
    the fields' dtype and ``step_plain`` of rho_r / rho_d."""
    zmid = ((torch.arange(rho_d.shape[1], dtype=rho_d.dtype,
                          device=rho_d.device) + 0.5) * dz)[None, :, None, None]
    return step_plain(rho_r / rho_d, rho_d, zmid, dt, 1)


def kessler_pass(theta, qv, qc, qr, precl, rho, r, rhalf, pk, pc, dz_lev,
                 dz_top, dt0, cp, z_axis):
    """One sub-cycle of the scheme (reference microphysics_kessler.h:288-331).

    ``dz_lev``: spacing between consecutive levels (a tensor over the nz - 1
    lower levels, or a number for a uniform grid); ``dz_top``: the spacing
    below the top level.  Returns updated (theta, qv, qc, qr, precl)."""
    nz = theta.shape[z_axis]
    velqr = terminal_velocity(qr, r, rhalf)

    # Sedimentation, upstream differencing (reference :288-299).
    precl = precl + exact_div(_ax(rho, z_axis, 0, 1) * _ax(qr, z_axis, 0, 1)
                              * _ax(velqr, z_axis, 0, 1), _RHOQR)
    flux = r * qr * velqr
    sed_int = dt0 * (_ax(flux, z_axis, 1, nz - 1)
                     - _ax(flux, z_axis, 0, nz - 1)) / (
        _ax(r, z_axis, 0, nz - 1) * dz_lev)
    sed_top = exact_div(-dt0 * _ax(qr, z_axis, nz - 1, 1)
                        * _ax(velqr, z_axis, nz - 1, 1), 0.5 * dz_top)
    sed = torch.cat([sed_int, sed_top], dim=z_axis)

    # Autoconversion + accretion, KW eq. 2.13 (reference :303-307).
    qrprod = qc - (qc - dt0 * torch.clamp(0.001 * (qc - 0.001), min=0.0)) / (
        1.0 + dt0 * 2.2 * qr ** 0.875)
    qc = torch.clamp(qc - qrprod, min=0.0)
    qr = torch.clamp(qr + qrprod + sed, min=0.0)

    # Saturation vapor mixing ratio, KW eq. 2.11 (reference :310-312).
    tmp = pk * theta - 36.0
    qvs = pc * torch.exp(17.27 * (pk * theta - 273.0) / tmp)
    prod = (qv - qvs) / (1.0 + qvs * (4093.0 * _LV / cp) / (tmp * tmp))

    # Rain evaporation, KW eq. 2.14 (reference :315-321).
    tmp1 = dt0 * (((1.6 + 124.9 * (r * qr) ** 0.2046) * (r * qr) ** 0.525)
                  / (2550000.0 * pc / (3.8 * qvs) + 540000.0)) * (
        torch.clamp(qvs - qv, min=0.0) / (r * qvs))
    ern = torch.minimum(tmp1, torch.minimum(
        torch.clamp(-prod - qc, min=0.0), qr))

    # Saturation adjustment, KW eq. 3.10 (reference :324-328).
    cond = torch.maximum(prod, -qc)
    theta = theta + exact_div(_LV, cp * pk) * (cond - ern)
    qv = torch.clamp(qv - cond + ern, min=0.0)
    qc = qc + cond
    qr = qr - ern
    return theta, qv, qc, qr, precl


def column_constants(rho, pk, Rd, cp, p0, z_axis):
    """(r, rhalf, pc): the pass-invariant column quantities."""
    r = 0.001 * rho
    rhalf = torch.sqrt(_ax(rho, z_axis, 0, 1) / rho)
    pc = exact_div(3.8, pk ** (cp / Rd) * (p0 / 100.0))
    return r, rhalf, pc


def kessler_subcycle_plain(theta, qv, qc, qr, rho, pk, rainsplit, dt, dz, Rd,
                           cp, p0):
    """``rainsplit`` passes of the KW1978 column physics on (nens, nz, ny,
    nx) fields with a uniform dz: the kernel's loop in plain PyTorch.
    Returns (theta, qv, qc, qr, precl) with precl shaped (nens, ny, nx).
    Reads ``rainsplit`` on the host."""
    nsub = int(rainsplit)
    dt0 = exact_div(dt, rainsplit.to(theta.dtype))
    r, rhalf, pc = column_constants(rho, pk, Rd, cp, p0, 1)
    precl = torch.zeros_like(theta[:, 0:1])
    for _ in range(nsub):
        theta, qv, qc, qr, precl = kessler_pass(
            theta, qv, qc, qr, precl, rho, r, rhalf, pk, pc, dz, dz, dt0, cp,
            1)
    return theta, qv, qc, qr, (precl / rainsplit.to(theta.dtype))[:, 0]


def _prep(rho_d, temp, rho_v, rho_c, rho_r, Rd, Rv, cp, p0):
    """(theta, qv, qc, qr, exner) of the coupler's fields (reference
    microphysics_kessler.h:99-152)."""
    qv = rho_v / rho_d
    qc = rho_c / rho_d
    qr = rho_r / rho_d
    pressure = Rd * rho_d * temp + Rv * rho_v * temp
    exner = exact_div(pressure, p0) ** (Rd / cp)
    return temp / exner, qv, qc, qr, exner


def kessler_step_plain(rho_d, temp, rho_v, rho_c, rho_r, rainsplit, dt, dz,
                       Rd, Rv, cp, p0):
    """Plain PyTorch version of ``kessler_step`` (same arguments): the prep,
    ``kessler_subcycle_plain``, and the post.  Reads ``rainsplit`` on the
    host."""
    theta, qv, qc, qr, exner = _prep(rho_d, temp, rho_v, rho_c, rho_r, Rd,
                                     Rv, cp, p0)
    theta, qv, qc, qr, precl = kessler_subcycle_plain(
        theta, qv, qc, qr, rho_d, exner, rainsplit, dt, dz, Rd, cp, p0)
    # theta is defined against the pre-micro exner (reference
    # microphysics_kessler.h:158-160)
    return qv * rho_d, qc * rho_d, qr * rho_d, theta * exner, precl


LIBRARY = KernelLibrary("kessler", {
    "kessler_step": [PTR] * 11 + [INT, INT, LONG] + [DOUBLE] * 6,
    "kessler_min_step": [PTR, PTR, PTR, LONG, INT, LONG, DOUBLE, DOUBLE],
}, {"kessler_staged_levels": ([INT, INT], INT),
    "kessler_smem_bytes": ([INT, INT], LONG)})


def kessler_staging(nz: int, dtype) -> tuple[int, int]:
    """(levels staged at once, shared memory per block in bytes) of the
    kernel for columns of ``nz`` levels of ``dtype``: nz itself when a
    column is staged whole.  Builds the kernel's library."""
    item = torch.empty((), dtype=dtype).element_size()
    return (LIBRARY.query("kessler_staged_levels", nz, item),
            LIBRARY.query("kessler_smem_bytes", nz, item))


def _check(rho_d, **others):
    """Raise unless ``rho_d`` is an f32 / f64 (nens, nz >= 2, ny, nx)
    tensor and it and every other field contiguous, of its dtype, shape and
    device."""
    if rho_d.dim() != 4 or rho_d.shape[1] < 2:
        raise ValueError(f"fields must be (nens, nz>=2, ny, nx), got "
                         f"{tuple(rho_d.shape)}")
    for name, t in {"rho_d": rho_d, **others}.items():
        check_operand(name, t, rho_d, rho_d.shape)


def kessler_step(rho_d, temp, rho_v, rho_c, rho_r, rainsplit, dt, dz, Rd,
                 Rv, cp, p0):
    """One Kessler time step on the coupler's fields.

    Args:
      rho_d, temp, rho_v, rho_c, rho_r: (nens, nz, ny, nx) dry density,
        temperature and the densities of vapor, cloud and rain; bottom-up
        columns.
      rainsplit: 0-d int32 tensor on the same device (the global sub-cycle
        count from ``kessler_rainsplit``).
      dt: physics step; dz: the uniform layer thickness; Rd, Rv, cp, p0: the
        gas constants of dry air and vapor, the heat capacity of dry air and
        the reference pressure.

    Returns the new (rho_v, rho_c, rho_r, temp) and precl, shaped
    (nens, ny, nx).  CPU tensors take ``kessler_step_plain``; CUDA tensors
    launch ``csrc/kessler.cu``.
    """
    if not on_cuda(rho_d):
        return kessler_step_plain(rho_d, temp, rho_v, rho_c, rho_r,
                                  rainsplit, dt, dz, Rd, Rv, cp, p0)
    _check(rho_d=rho_d, temp=temp, rho_v=rho_v, rho_c=rho_c, rho_r=rho_r)
    if (rainsplit.device != rho_d.device or rainsplit.dtype != torch.int32
            or rainsplit.numel() != 1):
        raise ValueError("rainsplit must be one int32 on the fields' device")
    nens, nz, ny, nx = rho_d.shape
    outs = [torch.empty_like(rho_d) for _ in range(4)]
    precl = torch.empty((nens, ny, nx), dtype=rho_d.dtype,
                        device=rho_d.device)
    LIBRARY.launch("kessler_step", rho_d, rho_d.data_ptr(), temp.data_ptr(),
                   rho_v.data_ptr(), rho_c.data_ptr(), rho_r.data_ptr(),
                   rainsplit.data_ptr(), *(o.data_ptr() for o in outs),
                   precl.data_ptr(), nens, nz, ny * nx, float(dt), float(dz),
                   float(Rd), float(Rv), float(cp), float(p0),
                   counter="kessler_step.launches")
    return (*outs, precl)


def min_step(rho_r, rho_d, dt, dz):
    """The largest stable sedimentation sub-step of the coupler's rain and
    dry densities, a 0-d tensor on their device (the sub-cycle count is
    ceil(dt / it)).

    Args:
      rho_r, rho_d: (nens, nz, ny, nx) rain and dry densities, bottom-up.
      dt: physics step; dz: the uniform layer thickness.

    CPU tensors take ``min_step_plain``; CUDA tensors launch
    ``kessler_min_step`` in ``csrc/kessler.cu``, with no host read.
    """
    if not on_cuda(rho_d):
        return min_step_plain(rho_r, rho_d, dt, dz)
    _check(rho_d=rho_d, rho_r=rho_r)
    nens, nz, ny, nx = rho_d.shape
    step = torch.empty((), dtype=rho_d.dtype, device=rho_d.device)
    LIBRARY.launch("kessler_min_step", rho_d, rho_r.data_ptr(),
                   rho_d.data_ptr(), step.data_ptr(), rho_d.numel(), nz,
                   ny * nx, float(dt), float(dz), counter="min_step.launches")
    return step
