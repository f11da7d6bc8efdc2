"""The lookup kernels' table layout, checked on the CPU.

``csrc/p3_lookup.cu`` reads the ice and collection tables packed K columns
innermost (``p3_lookup_cuda.pack_ice`` / ``pack_collect``: views of the
canonical (K, 5, 4, 50[, 30]) shape over storage in the kernels' layout), at
the offsets ``ice_offset`` / ``collect_offset`` that it mirrors.  These
tests hold every value of the packed storage to the canonical tables at
those offsets, check that pad values are zero, replay the kernels' corner
addressing and arithmetic order on the storage against the plain versions
bit for bit, and check that ``DeviceTables`` packs a column set once per
device and dtype.  No GPU is needed.
"""

import numpy as np
import pytest
import torch

from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
from miniweatherml_tpu_torch.physics import p3_tables as PT

DTYPES = (torch.float32, torch.float64)


@pytest.fixture(scope="module")
def tables():
    return PT.load_p3_tables()


def _cols(K, ncols):
    """K 1-based columns of a table with ``ncols`` (repeating past them)."""
    return tuple(1 + (c * 5) % ncols for c in range(K))


def _grid(*sizes):
    return np.meshgrid(*(np.arange(s) for s in sizes), indexing="ij")


def _canonical(tables, kind, cols, dtype):
    """The contiguous K-major table of 1-based ``cols``."""
    host = tables.ice if kind == "ice" else tables.collect
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(
        host[..., [c - 1 for c in cols]], -1, 0)), dtype=dtype)


def _storage(packed):
    """A packed table's whole storage, as the kernels read it."""
    return packed.as_strided(
        (packed.untyped_storage().nbytes() // packed.element_size(),), (1,))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 2, 3, 4, 7, 8, 12])
def test_pack_ice_layout(K, dtype, tables):
    table = _canonical(tables, "ice", _cols(K, 12), dtype)
    view = tables.to("cpu", dtype).ice_cols(_cols(K, 12))
    assert torch.equal(view, table)
    assert view.stride() == LK.ice_strides(K, dtype)
    packed = _storage(view)
    w, kp = LK.vec_width(K, dtype), LK.entry_width(K, dtype)
    # a load is K rounded up to a power of two, at most 16 bytes
    assert w * table.element_size() <= 16 and (w >= K or w * table
                                               .element_size() == 16)
    assert kp % w == 0 and K <= kp < K + w
    # entries an odd number of vectors apart, blocks skewed by one vector
    es, bs = LK.ice_entry(K, dtype), LK.ice_block(K, dtype)
    assert es // w % 2 == 1 and kp <= es <= kp + w and bs == 50 * es + w
    # whole 16-byte copies stage it in shared memory
    assert packed.shape == (5 * 4 * bs,) and packed.dtype == dtype
    assert packed.numel() * packed.element_size() % 16 == 0
    k, jj, ii, i = _grid(K, 5, 4, 50)
    off = torch.as_tensor(LK.ice_offset(k, jj, ii, i, K, dtype))
    assert torch.equal(packed[off], table)
    pad = torch.ones_like(packed, dtype=torch.bool)
    pad[off.reshape(-1)] = False
    assert int(pad.sum()) == packed.numel() - table.numel()
    assert not packed[pad].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 2, 3])
def test_pack_collect_layout(K, dtype, tables):
    table = _canonical(tables, "collect", _cols(K, 2), dtype)
    view = tables.to("cpu", dtype).collect_cols(_cols(K, 2))
    assert torch.equal(view, table)
    assert view.stride() == LK.collect_strides(K, dtype)
    packed = _storage(view)
    kp = LK.entry_width(K, dtype)
    # the entries in a row, in whole 16-byte vectors
    size = 20 * 50 * 30 * kp
    assert size <= packed.numel() < size + 16 // packed.element_size()
    assert packed.numel() * packed.element_size() % 16 == 0
    k, jj, ii, i, j = _grid(K, 5, 4, 50, 30)
    off = torch.as_tensor(LK.collect_offset(k, jj, ii, i, j, K, dtype))
    assert torch.equal(packed[off], table)
    pad = torch.ones_like(packed, dtype=torch.bool)
    pad[off.reshape(-1)] = False
    assert int(pad.sum()) == packed.numel() - table.numel()
    assert not packed[pad].any()


def _inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype)
    qi = 10.0 ** rng.uniform(-15, -1, n)
    idx = PT.ice_table_indices(t(qi), t(10.0 ** rng.uniform(-3, 10, n)),
                               t(qi * rng.uniform(0.0, 1.2, n)),
                               t(rng.uniform(0.0, 1000.0, n)))
    jr = PT.rain_collection_index(t(10.0 ** rng.uniform(-15, -1, n)),
                                  t(10.0 ** rng.uniform(-3, 8, n)))
    return idx, jr


def _corners(r, steps, kk):
    """The kernels' corner offsets: corner s = 4 a + 2 b + c at
    r + a steps[0] + b steps[1] + c steps[2] + kk."""
    return [r + (s >> 2) * steps[0] + ((s >> 1) & 1) * steps[1]
            + (s & 1) * steps[2] + kk for s in range(8)]


def _lerp(a, b, f):
    return a + f * (b - a)


def _ice_as_kernel(packed, K, i0, fi, ii0, fii, jj0, fjj):
    """csrc/p3_lookup.cu's ice_kernel, one value at a time."""
    es, bs = LK.ice_entry(K, fi.dtype), LK.ice_block(K, fi.dtype)
    r = (jj0.clamp(0, 3).long() * 4 + ii0.clamp(0, 2).long()) * bs + (
        i0.clamp(0, 48).long() * es)
    out = []
    for k in range(K):
        v = [packed[o] for o in _corners(r, (4 * bs, bs, es), k)]
        li = [_lerp(v[2 * q], v[2 * q + 1], fi) for q in range(4)]
        out.append(_lerp(_lerp(li[0], li[1], fii), _lerp(li[2], li[3], fii),
                         fjj))
    return torch.stack(out)


def _collect_as_kernel(packed, K, i0, fi, ii0, fii, jj0, fjj, j0, fj):
    """csrc/p3_lookup.cu's collect_kernel, one value at a time."""
    kp = LK.entry_width(K, fi.dtype)
    row = 30 * kp
    bs = 50 * row
    r = ((jj0.clamp(0, 3).long() * 4 + ii0.clamp(0, 2).long()) * bs
         + i0.clamp(0, 48).long() * row + j0.clamp(0, 28).long() * kp)
    out = []
    for k in range(K):
        lo = _corners(r, (4 * bs, bs, row), k)
        lj = [_lerp(packed[o], packed[o + kp], fj) for o in lo]
        li = [_lerp(lj[2 * s], lj[2 * s + 1], fi) for s in range(4)]
        v = _lerp(_lerp(li[0], li[1], fii), _lerp(li[2], li[3], fii), fjj)
        out.append(torch.pow(10.0, v))
    return torch.stack(out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ice", "collect"])
def test_kernel_reads_match_plain(kind, dtype, tables):
    """The kernels' reads of the packed tables, replayed here, give the
    plain versions' values bit for bit (index sets that reach every clip
    range)."""
    dev = tables.to("cpu", dtype)
    idx, jr = _inputs(3000, dtype, seed=5)
    assert int(idx[0].min()) == 0 and int(idx[0].max()) == 48
    if kind == "ice":
        table = dev.ice_cols((7, 8, 4, 2, 3, 5, 10))
        want = LK.interp_ice_plain(table, *idx)
        got = _ice_as_kernel(_storage(table), table.shape[0], *idx)
    else:
        table = dev.collect_cols((2, 1))
        want = LK.interp_collect_plain(table, *idx, *jr)
        got = _collect_as_kernel(_storage(table), table.shape[0], *idx,
                                 *jr)
    assert torch.equal(got, want)


def test_packed_once_per_column_set_and_dtype(tables):
    """DeviceTables packs a column set once per device and dtype (a second
    lookup of the same set returns the same tensor; another set or dtype
    is packed anew), and the CUDA wrappers' check takes only tables in the
    kernels' layout."""
    f32, f64 = tables.to("cpu", torch.float32), tables.to("cpu", torch.float64)
    a = f32.ice_cols((7, 8))
    assert f32.ice_cols((7, 8)) is a
    b = f32.ice_cols((2, 1, 7, 8))
    assert b is not a and _storage(b).numel() == 20 * (50 * 4 + 4)
    c = f64.ice_cols((7, 8))
    assert c.dtype == torch.float64 and torch.equal(c.float(), a)
    # the vector width, and so the layout, follows the dtype
    assert f64.ice_cols((7, 8, 4)).stride() != f32.ice_cols((7, 8, 4)).stride()
    coll = f32.collect_cols((2, 1))
    assert f32.collect_cols((2, 1)) is coll
    assert torch.equal(_storage(coll), _storage(LK.pack_collect(
        _canonical(tables, "collect", (2, 1), torch.float32))))
    args = ((torch.zeros(3),) * 3, (torch.zeros(3, dtype=torch.int32),) * 3)
    assert LK._check(a, (5, 4, 50), *args, None, LK.ice_strides)[0] == 2
    for bad in (a.contiguous(), a[:1], f64.ice_cols((7, 8))):
        with pytest.raises(ValueError, match="packed"):
            LK._check(bad, (5, 4, 50), *args, None, LK.ice_strides)
