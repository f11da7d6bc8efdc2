"""The P3 native twin: C++ built on first use with g++ and bound with ctypes.

Port of ``miniweatherml_tpu/native/__init__.py``.  The reference's native
tier is the P3 Fortran library called through bind(C)
(microphysics_p3.h:7-30) on host-staged arrays (microphysics_p3.h:364-376).
Here it is ``csrc/p3_native.cpp``, the repository's ``native/p3_kernels.cpp``
with its own header, compiled with the JAX loader's exact flags into a cached
shared object under ``_build/`` and called on float64 numpy arrays.  The
same flags (``-std=c++17`` keeps floating-point contraction off) make the two
packages' libraries compute alike bit for bit on one machine.

Nothing builds at import time: the first call of ``load_p3_library`` does,
and installs the P3 lookup tables when the table asset is there.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..cuda_build import cached_build

__all__ = ["load_p3_library", "native_available", "p3_adjust_state_native",
           "p3_column_step_native", "GXX_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "p3_native.cpp")
_BUILD = os.path.join(_PKG_DIR, "_build")

# The JAX loader's flags (miniweatherml_tpu/native/__init__.py:30-34).
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the library's entry points
    (``miniweatherml_tpu/native/__init__.py:58-66``)."""
    dp = ctypes.POINTER(ctypes.c_double)
    lib.p3_adjust_state.argtypes = [ctypes.c_int64] + [dp] * 5
    lib.p3_adjust_state.restype = None
    lib.p3_column_step.argtypes = (
        [ctypes.c_int64, ctypes.c_int64, ctypes.c_double] + [dp] * 18)
    lib.p3_column_step.restype = None
    lib.p3_set_tables.argtypes = [dp] * 5
    lib.p3_set_tables.restype = None
    lib.p3_has_tables.argtypes = []
    lib.p3_has_tables.restype = ctypes.c_int
    return lib


def load_p3_library() -> ctypes.CDLL:
    """Build (once) and load the twin, with the lookup tables installed when
    the asset is there; raises RuntimeError with the compiler's output when
    the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = cached_build("p3_native", [_SRC], GXX_FLAGS, lambda: "g++",
                                _BUILD, "native P3 build failed")
            lib = bind(ctypes.CDLL(path))
            install_tables(lib)
            _lib = lib
        return _lib


def install_tables(lib: ctypes.CDLL) -> None:
    """Install the parsed v4.1.1 ice / collection tables and the generated
    rain tables (p3_init_a / p3_init_b) into ``lib``, as the JAX loader's
    ``_maybe_load_tables`` does (:76-98).  Without a table asset the twin
    stays at the continuous tier; an asset that fails to parse raises (the
    JAX loader drops to the continuous tier then)."""
    from ..physics.p3_tables import (default_table_path, generate_rain_tables,
                                     load_p3_tables)
    path = default_table_path()
    if path is None:
        return
    tables = load_p3_tables(path)
    # (5, 4, 50, 12), (5, 4, 50, 30, 2), 3 x (300,): p3_set_tables's sizes
    arrays = [np.ascontiguousarray(a, np.float64)
              for a in (tables.ice, tables.collect, *generate_rain_tables())]
    lib.p3_set_tables(*(_ptr(a) for a in arrays))


def native_available() -> bool:
    """Whether the twin builds and loads here (the JAX package's query of the
    same name).  Nothing in the port chooses a path by it: ``p3_backend:
    native`` calls ``load_p3_library``, which raises with the compiler's
    output."""
    try:
        load_p3_library()
        return True
    except RuntimeError:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def p3_adjust_state_native(rho, rho_d, rho_v, rho_c, temp):
    """numpy wrapper: returns (rho_v, rho_c, temp) adjusted."""
    lib = load_p3_library()
    rho = np.ascontiguousarray(rho, np.float64)
    rho_d = np.ascontiguousarray(rho_d, np.float64)
    rv = np.array(rho_v, np.float64)
    rc = np.array(rho_c, np.float64)
    t = np.array(temp, np.float64)
    lib.p3_adjust_state(rho.size, _ptr(rho), _ptr(rho_d), _ptr(rv), _ptr(rc),
                        _ptr(t))
    return rv, rc, t


def column_step(lib, prog, const, dt, qv_prev=None, t_prev=None):
    """One P3 step of ``lib`` over (ncol, nz) float64 C-contiguous arrays:
    the 10 prognostic ``prog`` (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta)
    are updated IN PLACE, ``const`` = (exner, pres, rho_d, dz) only read.
    Returns (precip_liq, precip_ice), each (ncol,)."""
    arrays = (*prog, *const, *(a for a in (qv_prev, t_prev) if a is not None))
    ncol, nz = prog[0].shape
    for a in arrays:
        if (a.dtype != np.float64 or a.shape != (ncol, nz)
                or not a.flags.c_contiguous):
            raise ValueError(f"the twin takes C-contiguous float64 "
                             f"({ncol}, {nz}) arrays, got {a.dtype} "
                             f"{a.shape}")
    pl = np.zeros(ncol, np.float64)
    pi_ = np.zeros(ncol, np.float64)
    null = ctypes.POINTER(ctypes.c_double)()
    lib.p3_column_step(ncol, nz, float(dt), *(_ptr(a) for a in prog),
                       *(_ptr(a) for a in const),
                       *(null if a is None else _ptr(a)
                         for a in (qv_prev, t_prev)),
                       _ptr(pl), _ptr(pi_))
    return pl, pi_


def p3_column_step_native(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                          pres, rho_d, dz, dt, qv_prev=None, t_prev=None):
    """numpy wrapper over (ncol, nz) arrays; returns the updated prognostics
    plus (precip_liq, precip_ice) of shape (ncol,).  ``qv_prev``/``t_prev``
    feed evaporate_rain's supersaturation history (None = first step)."""
    lib = load_p3_library()
    prog = [np.array(a, np.float64, order="C")
            for a in (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta)]
    const = [np.ascontiguousarray(a, np.float64)
             for a in (exner, pres, rho_d, dz)]
    hist = [None if a is None else np.ascontiguousarray(a, np.float64)
            for a in (qv_prev, t_prev)]
    pl, pi_ = column_step(lib, prog, const, dt, *hist)
    return (*prog, pl, pi_)
