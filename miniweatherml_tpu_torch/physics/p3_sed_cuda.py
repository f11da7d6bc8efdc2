"""P3 sedimentation: one pass that takes the fastest fall speed and makes
one sub-step, and the CFL-sub-cycled fall, as CUDA kernels, and their plain
versions.

``sed_step`` (every cell's fall speeds once, the state's fastest
mass-weighted fall speed as a 0-d tensor, and one upstream sub-step of
cloud, rain and ice with their write-backs and the surface rates) and
``sed_columns`` (``nsub_t`` such sub-steps) run the plain functions of
``p3.py`` (``_p3_sed_step``, ``_p3_sed_columns``; re-exported here as
``step_plain`` and ``columns_plain``, with ``_p3_sed_vmax``, the oracle of
the maximum, as ``vmax_plain``) on CPU tensors.  On CUDA tensors each
launches its kernel in ``csrc/p3_sed.cu``, the port of the JAX scheme's
sedimentation (``miniweatherml_tpu/physics/p3.py:1268-1388``, a
``lax.while_loop``, no Pallas kernel): ``sed_columns`` reads the sub-step
count on the device, so a step makes no host read, and handed
``sed_step``'s outputs as ``rerun`` it keeps them where the count is 1 and
overwrites them otherwise.  The fields are contiguous (nens, nz, ny, nx)
tensors, the vertical on axis 1; ``dtab`` is the ``DeviceTables`` of the
table tier, or None for the [approx] tier.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import (DOUBLE, INT, LONG, PTR, PTRS, KernelLibrary,
                          check_operands, on_cuda, pointers)
from .p3 import _p3_sed_columns as columns_plain
from .p3 import _p3_sed_step as step_plain
from .p3 import _p3_sed_vmax as vmax_plain
from .p3_lookup_cuda import ice_strides

__all__ = ["sed_step", "sed_columns", "step_plain", "vmax_plain",
           "columns_plain",
           "launch_config", "ice_table", "ICE_COLS", "RAIN_ROWS"]

ICE_COLS = (2, 1, 7, 8)    # V_qit, V_nit and the ni limiters
RAIN_ROWS = ("vm", "vn")   # V_qr, V_nr

LIBRARY = KernelLibrary("p3_sed", {
    "p3_sed_step": [INT, INT, PTRS, PTRS, PTR, PTR, INT, DOUBLE, LONG, INT,
                    LONG, PTR],
    "p3_sed_columns": [INT, INT, PTRS, PTRS, PTR, PTR, INT, PTR, DOUBLE, INT,
                       LONG, INT, LONG],
}, {"p3_sed_launch": ([INT, INT, INT, INT, LONG, INT, PTR, PTR, PTR], INT)})


def launch_config(kernel: str, tables: bool, predict_nc: bool,
                  dtype: torch.dtype, n: int, nz: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared memory per block in bytes) of the
    "step" or "columns" kernel's launch over n cells of nz levels on the
    current card."""
    blocks, threads, smem = (ctypes.c_uint(), ctypes.c_int(),
                             ctypes.c_longlong())
    LIBRARY.call("p3_sed_launch", int(kernel == "columns"), int(tables),
                 int(predict_nc), int(dtype == torch.float64), n, nz,
                 ctypes.byref(blocks), ctypes.byref(threads),
                 ctypes.byref(smem))
    return blocks.value, threads.value, smem.value


def _check(fields, z_axis):
    """Validate a CUDA call's fields; returns (n, nz, plane)."""
    f0 = fields[0]
    if f0.dim() != 4 or z_axis not in (1, -3):
        raise ValueError("the sedimentation kernels take (nens, nz, ny, nx) "
                         f"fields with z on axis 1, got shape "
                         f"{tuple(f0.shape)} and z_axis {z_axis}")
    check_operands("p3 sedimentation field", fields, f0, f0.shape)
    nens, nz, ny, nx = f0.shape
    return f0.numel(), nz, ny * nx


def ice_table(dtab, like, cols=ICE_COLS):
    """The table tier's packed ice columns ``cols`` (default (2, 1, 7, 8)),
    checked against the fields ``like``: the table the sedimentation
    kernels stage and part3's lookup reads."""
    if dtab.device != like.device or dtab.dtype != like.dtype:
        raise ValueError(f"tables on {dtab.device} in {dtab.dtype}, fields "
                         f"on {like.device} in {like.dtype}")
    ice = dtab.ice_cols(cols)
    if (ice.stride() != ice_strides(len(cols), like.dtype)
            or ice.data_ptr() % 16):
        raise ValueError("the kernels take the packed, 16-byte aligned ice "
                         "table")
    return ice


def _tables(dtab, like):
    """(packed ice table, rain rows) pointers of the table tier, checked."""
    if dtab is None:
        return None, None, 0
    ice = ice_table(dtab, like)
    rain = dtab.rain_rows(RAIN_ROWS)
    if not rain.is_contiguous() or rain.data_ptr() % 16:
        raise ValueError("the sedimentation kernels take contiguous, 16-byte "
                         "aligned rain rows")
    return ice.data_ptr(), rain.data_ptr(), rain.shape[1]


def _outputs(qc):
    """The 8 fields and the two surface rates a launch writes."""
    outs = [torch.empty_like(qc) for _ in range(8)]
    srf = torch.empty((2, qc.shape[0], *qc.shape[2:]), dtype=qc.dtype,
                      device=qc.device)
    return outs + list(srf.unbind(0))


def sed_step(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz, dt, dtab, *,
             do_predict_nc: bool, z_axis: int = 1):
    """Every cell's fall speeds once: the fastest mass-weighted one (rain
    V_qr, ice V_qit, cloud V_qc) of the state, a 0-d tensor on the fields'
    device, and one upstream sub-step of the fall at dts = ``dt`` (a
    number).  Returns (vmax, (qc, nc, qr, nr, qi, ni, qm, bm, precip_liq,
    precip_ice)), the surface rates in m/s without the z axis: what
    ``sed_columns`` returns at one sub-step."""
    if not on_cuda(qc):
        return step_plain(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz, dt,
                          dtab, do_predict_nc, z_axis)
    fields = (qc, nc, qr, nr, qi, ni, qm, bm, rho, dz, temp)
    n, nz, plane = _check(fields, z_axis)
    ice, rain, rsize = _tables(dtab, qc)
    outs = _outputs(qc)
    vmax = torch.zeros((), dtype=qc.dtype, device=qc.device)
    LIBRARY.launch("p3_sed_step", qc, int(dtab is not None),
                   int(bool(do_predict_nc)), pointers(fields), pointers(outs),
                   ice, rain, rsize, float(dt), n, nz, plane, vmax.data_ptr(),
                   counter="sed_step.launches")
    return vmax, tuple(outs)


def sed_columns(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz, dt, nsub_t,
                dtab, *, do_predict_nc: bool, z_axis: int = 1, rerun=None):
    """``nsub_t`` (a 0-d tensor on the fields' device) upstream sub-steps of
    cloud, rain and ice sedimentation.  Returns (qc, nc, qr, nr, qi, ni, qm,
    bm, precip_liq, precip_ice), the surface rates in m/s without the z
    axis; ``dt`` is a number.  ``rerun``: what ``sed_step`` returned for
    these inputs, which is returned, as it is where the count is 1 and
    overwritten with the whole sub-cycle elsewhere (on the card in place:
    the count is never read to the host)."""
    if not on_cuda(qc):
        return columns_plain(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz,
                             dt, nsub_t, dtab, do_predict_nc, z_axis, rerun)
    fields = (qc, nc, qr, nr, qi, ni, qm, bm, rho, dz, temp)
    n, nz, plane = _check(fields, z_axis)
    if (nsub_t.device != qc.device or nsub_t.dtype != qc.dtype
            or nsub_t.numel() != 1):
        raise ValueError("nsub_t must be one value of the fields' dtype on "
                         "their device")
    ice, rain, rsize = _tables(dtab, qc)
    if rerun is None:
        outs = _outputs(qc)
    else:
        outs = list(rerun)
        srf = (qc.shape[0], *qc.shape[2:])
        if len(outs) != 10 or any(
                o.device != qc.device or o.dtype != qc.dtype
                or not o.is_contiguous()
                or tuple(o.shape) != (tuple(qc.shape) if i < 8 else srf)
                for i, o in enumerate(outs)):
            raise ValueError("rerun must be sed_step's 10 outputs for these "
                             "fields")
    LIBRARY.launch("p3_sed_columns", qc, int(dtab is not None),
                   int(bool(do_predict_nc)), pointers(fields), pointers(outs),
                   ice, rain, rsize, nsub_t.data_ptr(), float(dt),
                   int(rerun is not None), n, nz, plane,
                   counter="sed_columns.launches")
    return tuple(outs)
