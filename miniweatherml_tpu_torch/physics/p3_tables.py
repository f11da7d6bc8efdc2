"""P3 ice lookup tables: ASCII loader, index finding and interpolation.

Port of ``miniweatherml_tpu/physics/p3_tables.py``.  The reference's P3
reads its ice process-rate lookup table at init (micro_p3.F90
p3_init_a:133-204: ASCII file ``p3_lookup_table_1.dat-v4.1.1`` with a VERSION
header, then ``densize x rimsize x isize`` ice rows of 12 process values and
``densize x rimsize x isize x rcollsize`` ice-rain collection rows,
log10-transformed) and interpolates it tri/quad-linearly per cell per process
(access_lookup_table, :1508-1556; find_lookupTable_indices_1a/1b,
:1620-1720).  The rain tables are generated at init (p3_init_b, :236-345).

The table file is parsed with numpy into a ``P3Tables``; ``P3Tables.to``
puts its arrays on a device in a dtype once and packs each column set a
lookup asks for (K-major, contiguous) once.  The three ``interp_*_multi``
entry points launch the CUDA kernels of ``p3_lookup_cuda`` on CUDA tensors
and run their plain versions on CPU tensors; there is no other switch.

Table dimensions (micro_p3_utils.F90:43-46): isize=50 (normalized size),
rimsize=4 (rime fraction), densize=5 (rime density), rcollsize=30 (rain
size).
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache

import numpy as np
import torch

from ..ops.exact_div import exact_div
from . import p3_lookup_cuda as _lk

__all__ = ["P3Tables", "DeviceTables", "load_p3_tables", "default_table_path",
           "ice_table_indices", "rain_collection_index", "rain_size_index",
           "generate_rain_tables", "interp_ice", "interp_collect",
           "interp_rain", "interp_ice_multi", "interp_collect_multi",
           "interp_rain_multi", "cbrt"]

ISIZE, RIMSIZE, DENSIZE, RCOLLSIZE = 50, 4, 5, 30
# 1/(0.1*log10(261.7)) (micro_p3_utils.F90:34)
_DUM1_C = 4.135985029041767
QSMALL = 1.0e-14
RHO_H2O = 1000.0
_ASSET = "p3_lookup_table_1.dat-v4.1.1"


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a positive tensor, for the sites where the JAX package
    calls ``jnp.cbrt`` (PyTorch has none): ``pow(x, 1/3)`` (1/3 is inexact,
    so a few ulp off) polished by one Newton step to about one ulp."""
    y = x ** (1.0 / 3.0)
    return y - (y * y * y - x) / (3.0 * (y * y))


def _full_device(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class P3Tables:
    """ice: (densize, rimsize, isize, 12); collect: (densize, rimsize,
    isize, rcollsize, 2) with log10 applied (p3_init_a:192-194).  Host
    numpy arrays; ``to`` gives their device form."""

    version: str
    ice: np.ndarray
    collect: np.ndarray
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    def to(self, device, dtype: torch.dtype) -> "DeviceTables":
        """The tables on ``device`` in ``dtype`` (built once per pair)."""
        device = _full_device(device)
        if (device, dtype) not in self._on:
            self._on[device, dtype] = DeviceTables(self, device, dtype)
        return self._on[device, dtype]


class DeviceTables:
    """A ``P3Tables`` on one device in one dtype, plus the generated rain
    rows (vn, vm, revap).  ``ice_cols`` / ``collect_cols`` / ``rain_rows``
    give a column set K-major, once per set: the ice and collection sets
    in the lookup kernels' packed layout (``p3_lookup_cuda.pack_ice`` /
    ``pack_collect``), the rain rows contiguous."""

    def __init__(self, host: P3Tables, device: torch.device,
                 dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self._host = host
        self._packed: dict = {}

    def to(self, device, dtype: torch.dtype) -> "DeviceTables":
        """These tables on ``device`` in ``dtype`` (self when they are)."""
        if _full_device(device) == self.device and dtype == self.dtype:
            return self
        return self._host.to(device, dtype)

    def _pack(self, key, make, layout=lambda t: t):
        if key not in self._packed:
            self._packed[key] = layout(torch.as_tensor(
                np.ascontiguousarray(make()), dtype=self.dtype,
                device=self.device))
        return self._packed[key]

    def ice_cols(self, cols) -> torch.Tensor:
        """(K, densize, rimsize, isize) for 1-based ice columns ``cols``."""
        cols = tuple(cols)
        return self._pack(("ice", cols), lambda: np.moveaxis(
            self._host.ice[..., [c - 1 for c in cols]], -1, 0), _lk.pack_ice)

    def collect_cols(self, cols) -> torch.Tensor:
        """(K, densize, rimsize, isize, rcollsize) for 1-based columns."""
        cols = tuple(cols)
        return self._pack(("collect", cols), lambda: np.moveaxis(
            self._host.collect[..., [c - 1 for c in cols]], -1, 0),
            _lk.pack_collect)

    def rain_rows(self, names) -> torch.Tensor:
        """(K, 300) generated rain rows by name ("vn", "vm", "revap")."""
        names = tuple(names)
        rows = dict(zip(("vn", "vm", "revap"), generate_rain_tables()))
        return self._pack(("rain", names),
                          lambda: np.stack([rows[n] for n in names]))


def default_table_path() -> str | None:
    """The v4.1.1 lookup table asset in the JAX package's ``assets/``
    directory (the data file the reference vendors from SCREAM, read by
    path; the port does not import that package); ``MWML_P3_TABLE``
    overrides."""
    env = os.environ.get("MWML_P3_TABLE")
    if env:
        return env
    asset = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "miniweatherml_tpu", "assets", _ASSET)
    return os.path.abspath(asset) if os.path.exists(asset) else None


def _read_vals(f, n: int) -> list[str]:
    """At least ``n`` whitespace-separated tokens; raises at EOF."""
    vals: list[str] = []
    while len(vals) < n:
        line = f.readline()
        if not line:
            raise ValueError("truncated P3 lookup table file (unexpected EOF "
                             f"while reading a {n}-value row)")
        vals += line.split()
    return vals


def load_p3_tables(path: str | None = None) -> P3Tables:
    """Parse the v4.1.1 ASCII table (p3_init_a row layout)."""
    path = path or default_table_path()
    if path is None:
        raise FileNotFoundError(
            "no P3 lookup table available; set MWML_P3_TABLE")
    ice = np.zeros((DENSIZE, RIMSIZE, ISIZE, 12))
    coll = np.zeros((DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, 2))
    with open(path) as f:
        version = f.readline().split()[-1]
        for jj in range(DENSIZE):
            for ii in range(RIMSIZE):
                for i in range(ISIZE):
                    # row: i, ?, dum, dum, k1..k8, dum, k9..k12 (:183-186)
                    v = [float(x) for x in _read_vals(f, 17)]
                    ice[jj, ii, i, :8] = v[4:12]
                    ice[jj, ii, i, 8:] = v[13:17]
                for i in range(ISIZE):
                    for j in range(RCOLLSIZE):
                        # row: i, j, dum, dum, dum, k1, k2, dum (:188-194)
                        v = [float(x) for x in _read_vals(f, 8)]
                        coll[jj, ii, i, j, 0] = np.log10(v[5])
                        coll[jj, ii, i, j, 1] = np.log10(v[6])
    return P3Tables(version=version, ice=ice, collect=coll)


def _floor_i32(x):
    return torch.floor(x).to(torch.int32)


def ice_table_indices(qi, ni, qm, rhop):
    """find_lookupTable_indices_1a (micro_p3.F90:1620-1677).

    Returns (i0, fi, ii0, fii, jj0, fjj): 0-based int32 base indices and
    the Fortran-style fractional positions (dum - dumi) for the size, rime
    fraction and rime density axes."""
    dum1 = (torch.log10(torch.clamp(qi, min=QSMALL)
                        / torch.clamp(ni, min=1e-30)) + 18.0) * _DUM1_C - 10.0
    dumi = torch.clamp(_floor_i32(dum1), 1, ISIZE - 1)
    dum1 = torch.clamp(dum1, 1.0, float(ISIZE))

    dum4 = (qm / torch.clamp(qi, min=QSMALL)) * 3.0 + 1.0
    dumii = torch.clamp(_floor_i32(dum4), 1, RIMSIZE - 1)
    dum4 = torch.clamp(dum4, 1.0, float(RIMSIZE))

    dum5 = torch.where(rhop <= 650.0, (rhop - 50.0) * 0.005 + 1.0,
                       (rhop - 650.0) * 0.004 + 4.0)
    dumjj = torch.clamp(_floor_i32(dum5), 1, DENSIZE - 1)
    dum5 = torch.clamp(dum5, 1.0, float(DENSIZE))

    return (dumi - 1, dum1 - dumi.to(dum1.dtype),
            dumii - 1, dum4 - dumii.to(dum4.dtype),
            dumjj - 1, dum5 - dumjj.to(dum5.dtype))


def rain_collection_index(qr, nr):
    """find_lookupTable_indices_1b (micro_p3.F90:1681-1720)."""
    has_rain = (qr >= QSMALL) & (nr > 0.0)
    dumlr = cbrt(torch.clamp(qr, min=QSMALL)
                 / (np.pi * RHO_H2O * torch.clamp(nr, min=1e-30)))
    dum3 = (torch.log10(dumlr) + 5.0) * 10.70415
    dumj = torch.clamp(_floor_i32(dum3), 1, RCOLLSIZE - 1)
    dum3 = torch.clamp(dum3, 1.0, float(RCOLLSIZE))
    dumj = torch.where(has_rain, dumj, torch.ones_like(dumj))
    dum3 = torch.where(has_rain, dum3, torch.ones_like(dum3))
    return dumj - 1, dum3 - dumj.to(dum3.dtype)


def interp_ice(tables: P3Tables, col: int, i0, fi, ii0, fii, jj0, fjj):
    """Trilinear interpolation of ice table column ``col`` (1-based like
    the Fortran ``index`` argument) (access_lookup_table,
    micro_p3.F90:1508-1545)."""
    t = _device(tables, fi).ice_cols((col,))
    return _lk.interp_ice_plain(t, i0, fi, ii0, fii, jj0, fjj)[0]


def interp_collect(tables: P3Tables, col: int, i0, fi, ii0, fii, jj0, fjj,
                   j0, fj):
    """Quadrilinear interpolation of the ice-rain collection table
    (access_lookup_table_coll; values stored as log10 and exponentiated
    after interpolation)."""
    t = _device(tables, fi).collect_cols((col,))
    return _lk.interp_collect_plain(t, i0, fi, ii0, fii, jj0, fjj, j0,
                                    fj)[0]


# -- generated rain tables (p3_init_b, micro_p3.F90:236-345) ---------------
# Number/mass-weighted rain fall speeds and the rain-evaporation ventilation
# integral over the size distribution, tabulated over 300 number-weighted
# mean sizes at the constant shape parameter mu_r = 1 (micro_p3_utils.F90:33);
# all 10 mu_r rows of the reference table are identical, so one row suffices.
MU_R = 1.0
F1R, F2R = 0.78, 0.32  # ventilation coefficients (micro_p3_utils:138-139)


@lru_cache(maxsize=None)
def generate_rain_tables():
    """Integrate the rain PSD as p3_init_b does; returns (vn, vm, revap),
    each of shape (300,)."""
    jj = np.arange(1, 301, dtype=np.float64)
    dm = np.where(jj <= 20, (jj * 10.0 - 5.0) * 1e-6,
                  ((jj - 20) * 30.0 + 195.0) * 1e-6)
    lamr = (MU_R + 1.0) / dm

    dd = 2.0
    kk = np.arange(1, 10001, dtype=np.float64)
    dia = (kk * dd - dd * 0.5) * 1e-6
    amg = np.pi / 6.0 * 997.0 * dia ** 3 * 1000.0  # mass in grams
    vt = np.where(
        dia * 1e6 <= 134.43, 4.5795e3 * amg ** (2.0 / 3.0),
        np.where(dia * 1e6 < 1511.64, 4.962e1 * amg ** (1.0 / 3.0),
                 np.where(dia * 1e6 < 3477.84, 1.732e1 * amg ** (1.0 / 6.0),
                          9.17)))
    # weights with the reference's underflow guards 10**(4 mu) / 10**(3 mu);
    # they cancel in the ratios
    w_n = 10.0 ** (MU_R * np.log10(dia) + 4.0 * MU_R)
    w_m = 10.0 ** ((MU_R + 3.0) * np.log10(dia) + 4.0 * MU_R)
    w_v = np.sqrt(vt * dia) * 10.0 ** ((MU_R + 1.0) * np.log10(dia)
                                       + 3.0 * MU_R)
    e = np.exp(-np.outer(lamr, dia)) * (dd * 1e-6)  # (300, 10000)
    vn = (e @ (vt * w_n)) / np.maximum(e @ w_n, 1e-30)
    vm = (e @ (vt * w_m)) / np.maximum(e @ w_m, 1e-30)
    dum5 = np.maximum(e @ w_v, 1e-30)
    revap = 10.0 ** (np.log10(dum5) + (MU_R + 1.0) * np.log10(lamr)
                     - 3.0 * MU_R)
    return vn, vm, revap


def rain_size_index(dm):
    """find_lookupTable_indices_3's size mapping (micro_p3.F90:1725-1770):
    number-weighted mean size -> (i0, frac), 0-based into the 300-entry
    generated tables."""
    rd_small = torch.clamp((dm * 1e6 + 5.0) * 0.1, 1.0, 20.0)
    rd_large = torch.clamp(exact_div(dm * 1e6 - 195.0, 30.0) + 20.0, 20.0,
                           300.0)
    small = dm <= 195.0e-6
    rdum = torch.where(small, rd_small, rd_large)
    idum = torch.where(small, torch.clamp(_floor_i32(rd_small), 1, 20),
                       torch.clamp(_floor_i32(rd_large), 20, 299))
    return idum - 1, rdum - idum.to(rdum.dtype)


def interp_rain(table_row, i0, fi):
    """Linear interpolation into one generated (300,) rain row; i0 is
    clipped so i0+1 stays in range (the reference caps rdumii at 300 with
    dumii at 299)."""
    row = torch.as_tensor(np.asarray(table_row), dtype=fi.dtype,
                          device=fi.device)
    return _lk.interp_rain_plain(row[None], i0, fi)[0]


def _device(tables, like: torch.Tensor) -> DeviceTables:
    return tables.to(like.device, like.dtype)


def interp_ice_multi(tables, cols, i0, fi, ii0, fii, jj0, fjj, present=None):
    """Trilinear ice-table interpolation of several 1-based columns that
    share one index set; a tuple in ``cols`` order, in ``fi``'s dtype.
    ``present``: optional 0-d bool tensor; where it is False every output
    is zero (the JAX package's ``lax.cond`` presence gate)."""
    t = _device(tables, fi).ice_cols(cols)
    return tuple(_lk.interp_ice(t, i0, fi, ii0, fii, jj0, fjj, present))


def interp_collect_multi(tables, cols, i0, fi, ii0, fii, jj0, fjj, j0, fj,
                         present=None):
    """Quadrilinear ice-rain collection interpolation of several 1-based
    columns sharing one index set (log10 values, exponentiated after
    interpolation); ``present`` as in ``interp_ice_multi``."""
    t = _device(tables, fi).collect_cols(cols)
    return tuple(_lk.interp_collect(t, i0, fi, ii0, fii, jj0, fjj, j0, fj,
                                    present))


def interp_rain_multi(rows, i0, fi, present=None):
    """Linear interpolation into several (300,) rain rows sharing one index
    set.  ``rows``: a (K, 300) tensor (``DeviceTables.rain_rows``) or a
    sequence of 1-D arrays; ``present`` as in ``interp_ice_multi``."""
    if not torch.is_tensor(rows):
        rows = torch.as_tensor(np.stack([np.asarray(r) for r in rows]),
                               dtype=fi.dtype, device=fi.device)
    return tuple(_lk.interp_rain(rows, i0, fi, present))
