"""The P3 scheme's per-cell phases: one fused CUDA kernel each, and their
plain versions.

``p3_part1`` (13 fields in, 21 out), ``p3_update`` (dt + 45 fields in, 10
out), ``p3_wrapper`` (13 fields in, 14 out), ``p3_rates_pre`` (10 fields in;
7 fields, 5 int32 index fields and 3 presence flags out), ``p3_rates_post``
(dt + 30 fields in, 25 out), ``p3_part3`` (14 fields and the ice table in,
10 out; with ``diagnostics=True`` also the six diagnostic fields) and ``p3_wrapper_out`` (12 fields in, 11 out) run the plain
functions of ``p3.py`` (``_p3_part1_cellwise``, ``_p3_update_cellwise``,
``_p3_wrapper_inputs_cellwise``, ``_p3_rates_pre_cellwise``,
``_p3_rates_post_cellwise``, ``_p3_part3_cellwise``,
``_p3_wrapper_out_cellwise``, re-exported here as ``*_plain``) on CPU
tensors.  On CUDA tensors each launches the matching phase of
``csrc/p3_cellwise.cu``: one thread per cell reads the cell's inputs once
and writes its outputs once (``p3_rates_pre``: a thread takes
neighbouring cells as 16-byte words, and a block reduces the presence
flags, one store per block and flag at most; ``p3_wrapper`` and
``p3_rates_post``: an input is read where first used and an output stored
once final, and a warp skips the saturation Newton or the gated rates
where none of its cells keeps their result).  The first three are the
port of the Pallas kernel
``miniweatherml_tpu/ops/elementwise.py::fused_cellwise``; the two rates
phases, with the table lookups between them, are the port of the XLA
fusion of the JAX scheme's process rates
(``miniweatherml_tpu/physics/p3.py:853-1225``), which is no Pallas kernel;
``p3_part3`` and ``p3_wrapper_out`` port the XLA fusions of its homogeneous
freezing and part3 (:1392-1485) and of ``MicrophysicsP3.time_step``'s
output pass (:1726-1741).
"""

from __future__ import annotations

import torch

from ..cuda_build import (DOUBLE, INT, LONG, PTR, PTRS, KernelLibrary,
                          check_operands, data_ptr, on_cuda, pointers)
from ..utils.profiling import count
from .p3 import (_p3_part1_cellwise as part1_plain,
                 _p3_part3_cellwise as part3_plain,
                 _p3_rates_post_cellwise as rates_post_plain,
                 _p3_rates_pre_cellwise as rates_pre_plain,
                 _p3_update_cellwise as update_plain,
                 _p3_wrapper_inputs_cellwise as wrapper_plain,
                 _p3_wrapper_out_cellwise as wrapper_out_plain)
from .p3_sed_cuda import ICE_COLS, ice_table

# part3's diagnostic fields in the kernel's output order
DIAG_NAMES = ("eff_radius_qc", "eff_radius_qi", "diam_qi", "rho_qi", "vm_qi",
              "equiv_reflectivity")

__all__ = ["p3_part1", "p3_update", "p3_wrapper", "p3_rates_pre",
           "p3_rates_post", "p3_part3", "p3_wrapper_out", "plain_phase",
           "part1_plain", "update_plain", "wrapper_plain", "rates_pre_plain",
           "rates_post_plain", "part3_plain", "wrapper_out_plain",
           "DIAG_NAMES", "PART3_DIAG_COLS"]

# phase ids of csrc/p3_cellwise.cu: (phase, flag) -> id; the flag is
# do_predict_nc, for part3 the table tier
_PHASE_ID = {("part1", False): 0, ("part1", True): 1, ("update", False): 2,
             ("update", True): 3, ("wrapper", False): 4,
             ("rates_pre", False): 5, ("rates_post", False): 6,
             ("part3", False): 7, ("part3", True): 8,
             ("wrapper_out", False): 9, ("part3_diag", False): 10,
             ("part3_diag", True): 11}
# (outputs in the fields' dtype, int32 outputs, presence flags) per phase
_N_OUT = {"part1": (21, 0, 0), "update": (10, 0, 0), "wrapper": (14, 0, 0),
          "rates_pre": (7, 5, 3), "rates_post": (25, 0, 0),
          "part3": (10, 0, 0), "wrapper_out": (11, 0, 0),
          "part3_diag": (16, 0, 0)}
# the packed ice columns part3 reads: the limiter's 7 and 8 in the
# sedimentation kernels' table, with the diagnostics also 2, 6, 9, 11, 12
PART3_DIAG_COLS = (2, 1, 7, 8, 6, 9, 11, 12)
# where rates_pre's outputs go in its plain version's order: ("f", i) the
# i-th field output, ("i", i) the i-th int32 output
_RATES_PRE_ORDER = (("f", 0), ("f", 1), ("i", 0), ("f", 2), ("i", 1),
                    ("f", 3), ("i", 2), ("f", 4), ("i", 3), ("f", 5),
                    ("i", 4), ("f", 6))

LIBRARY = KernelLibrary("p3_cellwise", {
    "p3_cellwise": [INT, PTRS, INT, PTRS, INT, PTRS, INT, PTR, INT, LONG,
                    DOUBLE, PTR]})


def _launch(phase, predict_nc, arrays, dt=0.0, table=None):
    """Run one phase's kernel on same-shape contiguous CUDA tensors;
    ``table``: the packed ice table of the table tier's part3."""
    a0 = arrays[0]
    check_operands(f"p3 {phase} input", arrays, a0, a0.shape)
    n_f, n_i, n_flag = _N_OUT[phase]
    outs = [torch.empty_like(a0) for _ in range(n_f)]
    iouts = [torch.empty_like(a0, dtype=torch.int32) for _ in range(n_i)]
    flags = (torch.zeros(n_flag, dtype=torch.bool, device=a0.device)
             if n_flag else None)
    LIBRARY.launch("p3_cellwise", a0, _PHASE_ID[(phase, predict_nc)],
                   pointers(arrays), len(arrays), pointers(outs), n_f,
                   pointers(iouts), n_i, data_ptr(flags), n_flag, a0.numel(),
                   float(dt), data_ptr(table))
    if phase == "rates_pre":
        got = {"f": outs, "i": iouts}
        return (*(got[k][i] for k, i in _RATES_PRE_ORDER), flags)
    return tuple(outs)


def plain_phase(phase: str, predict_nc: bool, arrays, dt=0.0, dtab=None):
    """The plain version of one phase on its kernel's argument list
    (part3: ``dtab`` the tables, or None)."""
    if phase == "part3":
        return part3_plain(*arrays, dtab)
    if phase == "part3_diag":
        return part3_plain(*arrays, dtab, diagnostics=True)
    if phase == "wrapper_out":
        return wrapper_out_plain(*arrays)
    if phase == "part1":
        return part1_plain(*arrays, do_predict_nc=predict_nc)
    if phase == "update":
        return update_plain(dt, *arrays, do_predict_nc=predict_nc)
    if phase == "rates_pre":
        return rates_pre_plain(*arrays)
    if phase == "rates_post":
        return rates_post_plain(dt, *arrays)
    return wrapper_plain(*arrays)


def _run(phase, predict_nc, arrays, dt=0.0):
    """The phase's kernel on CUDA tensors, its plain version on CPU ones;
    returns (outputs, whether the kernel ran)."""
    if not on_cuda(arrays[0]):
        return plain_phase(phase, predict_nc, arrays, dt), False
    return _launch(phase, bool(predict_nc), arrays, dt), True


def p3_part1(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, rho, *,
             do_predict_nc: bool):
    """part1 + in-cloud values + pre-process DSD writebacks (see
    ``p3._p3_part1_cellwise`` for inputs and outputs)."""
    out, launched = _run("part1", do_predict_nc, (
        qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, rho))
    if launched:
        count("p3_part1.launches")
    return out


def p3_update(dt, *arrays, do_predict_nc: bool):
    """Conservation rescaling, prognostic update and end-of-part2 clip on
    the 45 fields of ``p3._p3_update_cellwise``; ``dt`` is a number."""
    if len(arrays) != 45:
        raise ValueError(f"p3_update takes 45 fields, got {len(arrays)}")
    out, launched = _run("update", do_predict_nc, arrays, dt)
    if launched:
        count("p3_update.launches")
    return out


def p3_wrapper(rho_d, temp, rho_c, rho_nc, rho_r, rho_nr, rho_i, rho_ni,
               rho_m, rho_bm, rho_v, qv_prev_f, t_prev_f):
    """The wrapper's per-cell inputs with the saturation Newton (see
    ``p3._p3_wrapper_inputs_cellwise``)."""
    out, launched = _run("wrapper", False, (
        rho_d, temp, rho_c, rho_nc, rho_r, rho_nr, rho_i, rho_ni, rho_m,
        rho_bm, rho_v, qv_prev_f, t_prev_f))
    if launched:
        count("p3_wrapper.launches")
    return out


def p3_rates_pre(qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in, qr_in, nr_in):
    """The table tier's rime re-bounds and lookup index sets, with the
    lookups' presence flags (see ``p3._p3_rates_pre_cellwise``)."""
    out, launched = _run("rates_pre", False, (
        qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in, qr_in, nr_in))
    if launched:
        count("p3_rates_pre.launches")
    return out


def p3_rates_post(dt, *arrays):
    """The table tier's process rates from part1's state and the ten lookup
    values, on the 30 fields of ``p3._p3_rates_post_cellwise``; ``dt`` is a
    number."""
    if len(arrays) != 30:
        raise ValueError(f"p3_rates_post takes 30 fields, got {len(arrays)}")
    out, launched = _run("rates_post", False, arrays, dt)
    if launched:
        count("p3_rates_post.launches")
    return out


def p3_part3(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, exner, rho,
             inv_rho, dtab, diagnostics=False):
    """Homogeneous freezing and part3 on the state after sedimentation (see
    ``p3._p3_part3_cellwise``); ``dtab``: the table tier's
    ``DeviceTables``, or None for the [approx] tier.  With
    ``diagnostics=True`` returns (the ten prognostics, a dict of the
    diagnostic fields per cell), as the plain version does."""
    arrays = (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, exner, rho,
              inv_rho)
    if not on_cuda(qc):
        return part3_plain(*arrays, dtab, diagnostics=diagnostics)
    table = None
    if dtab is not None:
        table = ice_table(dtab, qc, PART3_DIAG_COLS if diagnostics
                          else ICE_COLS)
    out = _launch("part3_diag" if diagnostics else "part3", dtab is not None,
                  arrays, table=table)
    count("p3_part3.launches")
    if not diagnostics:
        return out
    return out[:10], dict(zip(DIAG_NAMES, out[10:]))


def p3_wrapper_out(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, rho_d):
    """The wrapper's output pass: the nine clamped densities, temp and
    qv_prev (see ``p3._p3_wrapper_out_cellwise``)."""
    out, launched = _run("wrapper_out", False, (
        qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, rho_d))
    if launched:
        count("p3_wrapper_out.launches")
    return out
