"""The P3 table lookups: CUDA kernels and their plain versions.

``interp_ice`` (trilinear, ice table), ``interp_collect`` (quadrilinear of
log10 values, then 10**, ice-rain collection table) and ``interp_rain``
(linear, generated rain rows) each take a K-major table
(``p3_tables.DeviceTables``), one index set and an optional
0-d bool ``present``, and return a (K, *cells) tensor; where ``present`` is
False every value is zero.  On a CUDA tensor each launches its kernel in
``csrc/p3_lookup.cu`` (the port of the Pallas kernels
``miniweatherml_tpu/physics/p3_pallas_lookup.py::interp_{ice,collect,rain}_pallas``
and ``interp_{ice,collect,rain}_lane``), with ``present`` read on the
device; on a CPU tensor it runs its ``*_plain`` version, which does the
corner sums in the same order as the JAX package's ``interp_*``.

The ice and collection kernels read the table in a layout of their own,
K columns innermost (``pack_ice``, ``pack_collect``; the offsets are
``ice_offset`` and ``collect_offset``, which ``csrc/p3_lookup.cu`` mirrors).
A packed table is a (K, 5, 4, 50[, 30]) view of that layout's storage, so
the plain versions read it as they read a contiguous one, and the kernels
read its storage.  ``DeviceTables`` packs each column set once per device
and dtype; on a CUDA tensor the wrappers take only packed tables.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import (INT, LONG, PTR, KernelLibrary, check_operands,
                          data_ptr, on_cuda)

__all__ = ["interp_ice", "interp_collect", "interp_rain", "interp_ice_plain",
           "interp_collect_plain", "interp_rain_plain", "pack_ice",
           "pack_collect", "ice_offset", "collect_offset", "vec_width",
           "entry_width", "ice_entry", "ice_block", "ice_strides",
           "collect_strides",
           "launch_config"]

DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE = 5, 4, 50, 30
_ICE_SHAPE = (DENSIZE, RIMSIZE, ISIZE)
_COLLECT_SHAPE = (DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE)


def _gate(out, present):
    if present is None:
        return out
    return torch.where(present, out, 0.0)


def _lerp(a, b, f):
    return a + f * (b - a)


def interp_ice_plain(table, i0, fi, ii0, fii, jj0, fjj, present=None):
    """Plain version of ``interp_ice``."""
    i0, ii0, jj0 = i0.long(), ii0.long(), jj0.long()

    def lin_i(jj, ii):
        return _lerp(table[:, jj, ii, i0], table[:, jj, ii, i0 + 1], fi)

    def lin_ii(jj):
        return _lerp(lin_i(jj, ii0), lin_i(jj, ii0 + 1), fii)

    return _gate(_lerp(lin_ii(jj0), lin_ii(jj0 + 1), fjj), present)


def interp_collect_plain(table, i0, fi, ii0, fii, jj0, fjj, j0, fj,
                         present=None):
    """Plain version of ``interp_collect``."""
    i0, ii0, jj0, j0 = i0.long(), ii0.long(), jj0.long(), j0.long()

    def lin_j(jj, ii, i):
        return _lerp(table[:, jj, ii, i, j0], table[:, jj, ii, i, j0 + 1], fj)

    def lin_i(jj, ii):
        return _lerp(lin_j(jj, ii, i0), lin_j(jj, ii, i0 + 1), fi)

    def lin_ii(jj):
        return _lerp(lin_i(jj, ii0), lin_i(jj, ii0 + 1), fii)

    v = _lerp(lin_ii(jj0), lin_ii(jj0 + 1), fjj)
    return _gate(torch.pow(10.0, v), present)


def interp_rain_plain(rows, i0, fi, present=None):
    """Plain version of ``interp_rain``; i0 is clipped to [0, size - 2]."""
    i0 = torch.clamp(i0.long(), 0, rows.shape[1] - 2)
    return _gate(_lerp(rows[:, i0], rows[:, i0 + 1], fi), present)


# -- the kernels' table layout ------------------------------------------------

def vec_width(K: int, dtype: torch.dtype) -> int:
    """W: the values a kernel thread loads at once for K columns, K rounded
    up to a power of two and at most 16 bytes."""
    w, item = 1, torch.finfo(dtype).bits // 8
    while w < K and w * item < 16:
        w *= 2
    return w


def entry_width(K: int, dtype: torch.dtype) -> int:
    """kp: values per table point of the packed tables (the K columns),
    K rounded up to a multiple of ``vec_width``."""
    w = vec_width(K, dtype)
    return -(-K // w) * w


def ice_entry(K: int, dtype: torch.dtype) -> int:
    """es: values from one ice table point to the next in ``pack_ice``'s
    table, ``entry_width`` rounded up to an odd number of vectors (so that
    in shared memory neighbouring points start in different banks)."""
    w, kp = vec_width(K, dtype), entry_width(K, dtype)
    return kp if kp // w % 2 else kp + w


def ice_block(K: int, dtype: torch.dtype) -> int:
    """bs: values per (jj, ii) block of ``pack_ice``'s table, ISIZE entries
    and one vector of skew (so that in shared memory the blocks start in
    different banks)."""
    return ISIZE * ice_entry(K, dtype) + vec_width(K, dtype)


def ice_strides(K: int, dtype: torch.dtype) -> tuple[int, ...]:
    """Strides of a (K, 5, 4, 50) ``pack_ice`` table: value (k, jj, ii, i)
    lies at (jj * RIMSIZE + ii) * bs + i * es + k, K columns innermost."""
    bs = ice_block(K, dtype)
    return (1, RIMSIZE * bs, bs, ice_entry(K, dtype))


def collect_strides(K: int, dtype: torch.dtype) -> tuple[int, ...]:
    """Strides of a (K, 5, 4, 50, 30) ``pack_collect`` table: value
    (k, jj, ii, i, j) lies at (((jj * RIMSIZE + ii) * ISIZE + i) * RCOLLSIZE
    + j) * kp + k, so entries j and j + 1 of one (jj, ii, i) row are 2 kp
    values in a row."""
    kp = entry_width(K, dtype)
    return (1, RIMSIZE * ISIZE * RCOLLSIZE * kp, ISIZE * RCOLLSIZE * kp,
            RCOLLSIZE * kp, kp)


def ice_offset(k, jj, ii, i, K, dtype):
    """Where ``pack_ice`` puts ice value (k, jj, ii, i) of a K-column table
    in its storage."""
    return sum(x * s for x, s in zip((k, jj, ii, i), ice_strides(K, dtype)))


def collect_offset(k, jj, ii, i, j, K, dtype):
    """Where ``pack_collect`` puts collection value (k, jj, ii, i, j) of a
    K-column table in its storage."""
    return sum(x * s for x, s in zip((k, jj, ii, i, j),
                                     collect_strides(K, dtype)))


def _packed_numel(shape, dtype) -> int:
    """Values of a packed table's storage: its (jj, ii) blocks, padded to
    whole 16-byte copies (the kernels stage it in shared memory so)."""
    K, item = shape[0], torch.finfo(dtype).bits // 8
    strides = (ice_strides if len(shape) == 4 else collect_strides)(K, dtype)
    return -(-DENSIZE * strides[1] * item // 16) * 16 // item


def _pack(table, strides):
    out = table.new_zeros(_packed_numel(table.shape, table.dtype))
    out = out.as_strided(table.shape, strides)
    out.copy_(table)
    return out


def pack_ice(table: torch.Tensor) -> torch.Tensor:
    """The ice kernel's layout of a (K, 5, 4, 50) table: a view of the same
    values with ``ice_strides``; the storage's pad values are zero."""
    return _pack(table, ice_strides(table.shape[0], table.dtype))


def pack_collect(table: torch.Tensor) -> torch.Tensor:
    """The collection kernel's layout of a (K, 5, 4, 50, 30) table: a view
    of the same values with ``collect_strides``; pad values are zero."""
    return _pack(table, collect_strides(table.shape[0], table.dtype))


LIBRARY = KernelLibrary("p3_lookup", {
    "p3_interp_ice": [PTR, INT] + [PTR] * 8 + [LONG],
    "p3_interp_collect": [PTR, INT] + [PTR] * 10 + [LONG],
    "p3_interp_rain": [PTR, INT, INT] + [PTR] * 4 + [LONG],
}, {"p3_lookup_launch": ([INT, INT, INT, LONG, PTR, PTR, PTR], INT)})


def launch_config(kind: str, K: int, dtype: torch.dtype,
                  n: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared memory per block in bytes) of the
    "ice" or "collect" kernel's launch for K columns and n cells on the
    current card: a persistent grid, each block staging in shared memory
    the whole ice table or as many (jj, ii) blocks of the collection table
    as fit."""
    blocks, threads, smem = (ctypes.c_uint(), ctypes.c_int(),
                             ctypes.c_longlong())
    LIBRARY.call("p3_lookup_launch", int(kind == "collect"), K,
                 int(dtype == torch.float64), n, ctypes.byref(blocks),
                 ctypes.byref(threads), ctypes.byref(smem))
    return blocks.value, threads.value, smem.value


def _check(table, tshape, fracs, idxs, present, strides=None):
    """Validate a CUDA call's arguments; returns (K, cells shape).
    ``strides``: the function giving the packed layout the table must have
    (None: the table must be contiguous)."""
    f0 = fracs[0]
    check_operands("fraction", fracs, f0, f0.shape)
    check_operands("index", idxs, f0, f0.shape, torch.int32)
    if strides is None:
        layout, ok = "contiguous", table.is_contiguous()
    else:
        layout = "packed (pack_ice / pack_collect)"
        ok = (table.dim() == 1 + len(tshape) and table.dtype == f0.dtype
              and table.stride() == strides(table.shape[0], f0.dtype)
              and table.storage_offset() == 0
              and table.untyped_storage().nbytes() >= _packed_numel(
                  table.shape, f0.dtype) * table.element_size())
    if (not ok or table.device != f0.device or table.dtype != f0.dtype
            or table.dim() != 1 + len(tshape)
            or tuple(table.shape[1:]) != tshape):
        raise ValueError(f"table must be a {layout} {f0.dtype} tensor of "
                         f"shape (K, {', '.join(map(str, tshape))}) on "
                         f"{f0.device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    if present is not None and (present.device != f0.device
                                or present.dtype != torch.bool
                                or present.numel() != 1):
        raise ValueError("present must be one bool on the fields' device")
    return table.shape[0], tuple(f0.shape)


def _launch(kind, table, args, present, K, shape, dtype, device,
            extra_ints=()):
    out = torch.empty((K, *shape), dtype=dtype, device=device)
    LIBRARY.launch(f"p3_interp_{kind}", out, table.data_ptr(), K, *extra_ints,
                   *(a.data_ptr() for a in args), data_ptr(present),
                   out.data_ptr(), out[0].numel(),
                   counter=f"interp_{kind}.launches")
    return out


def interp_ice(table, i0, fi, ii0, fii, jj0, fjj, present=None):
    """Trilinear ice-table lookup.  ``table``: (K, 5, 4, 50), on a CUDA
    device packed (``pack_ice``, as ``DeviceTables.ice_cols`` gives it);
    indices int32, fractions float, all of one shape.  Returns (K, *cells)."""
    if not on_cuda(fi):
        return interp_ice_plain(table, i0, fi, ii0, fii, jj0, fjj, present)
    K, shape = _check(table, _ICE_SHAPE, (fi, fii, fjj), (i0, ii0, jj0),
                      present, ice_strides)
    return _launch("ice", table, (i0, fi, ii0, fii, jj0, fjj), present, K,
                   shape, fi.dtype, fi.device)


def interp_collect(table, i0, fi, ii0, fii, jj0, fjj, j0, fj, present=None):
    """Quadrilinear ice-rain collection lookup, 10** of the interpolated
    log10 values.  ``table``: (K, 5, 4, 50, 30), on a CUDA device packed
    (``pack_collect``, as ``DeviceTables.collect_cols`` gives it).  Returns
    (K, *cells)."""
    if not on_cuda(fi):
        return interp_collect_plain(table, i0, fi, ii0, fii, jj0, fjj, j0, fj,
                                    present)
    K, shape = _check(table, _COLLECT_SHAPE, (fi, fii, fjj, fj),
                      (i0, ii0, jj0, j0), present, collect_strides)
    return _launch("collect", table, (i0, fi, ii0, fii, jj0, fjj, j0, fj),
                   present, K, shape, fi.dtype, fi.device)


def interp_rain(rows, i0, fi, present=None):
    """Linear lookup into K rain rows.  ``rows``: (K, size >= 2).  Returns
    (K, *cells)."""
    if not on_cuda(fi):
        return interp_rain_plain(rows, i0, fi, present)
    if rows.dim() != 2 or rows.shape[1] < 2:
        raise ValueError(f"rows must be (K, size >= 2), got "
                         f"{tuple(rows.shape)}")
    K, shape = _check(rows, (rows.shape[1],), (fi,), (i0,), present)
    return _launch("rain", rows, (i0, fi), present, K, shape, fi.dtype,
                   fi.device, extra_ints=(rows.shape[1],))
