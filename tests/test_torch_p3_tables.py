"""The port's P3 lookup tables against the JAX package's, on the CPU.

The loader's and the rain generator's arrays equal JAX's exactly.  The index
finders give the same int32 indices and fractions to 1e-13 (absolute, on
fractions in [0, 1]: ``log10`` and the cube root differ in the last bits
between the two libraries).  The lookups, fed the same indices, agree with
JAX's gather path at rtol 1e-13 in f64; in f32 they are held to the JAX
suite's own bounds between its lookup forms, 3e-5 (ice, rain) and 2e-4
(collect, where exponentiating the log10 values amplifies rounding;
tests/test_p3_tables.py:269-345): under x64 JAX's gathers return f64 for f32
fractions, the port computes in the state dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.physics import p3_tables as JT
from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
from miniweatherml_tpu_torch.physics import p3_tables as PT

ICE_COLS = (7, 8, 4, 2, 3, 5, 10)
F32_RTOL = {"ice": 3e-5, "collect": 2e-4, "rain": 3e-5}


@pytest.fixture(scope="module")
def jtab():
    return JT.load_p3_tables()


@pytest.fixture(scope="module")
def ptab():
    return PT.load_p3_tables()


def _inputs(n=4000, seed=0):
    """Physical inputs spanning past the tables' ranges, so every index
    finder hits its clips."""
    rng = np.random.default_rng(seed)
    qi = 10.0 ** rng.uniform(-15, -1, n)
    return dict(qi=qi, ni=10.0 ** rng.uniform(-3, 10, n),
                qm=qi * rng.uniform(0.0, 1.2, n),
                rhop=rng.uniform(0.0, 1000.0, n),
                qr=10.0 ** rng.uniform(-15, -1, n),
                nr=np.where(rng.random(n) < 0.1, 0.0,
                            10.0 ** rng.uniform(-3, 8, n)),
                dm=10.0 ** rng.uniform(-7, -1, n))


def _pt(a, dtype=torch.float64):
    a = np.array(a)
    return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None)


def test_loader_matches_jax(jtab, ptab):
    assert ptab.version == jtab.version == "4.1.1"
    np.testing.assert_array_equal(ptab.ice, jtab.ice)
    np.testing.assert_array_equal(ptab.collect, jtab.collect)


def test_tables_from_jax_arrays(jtab):
    """P3Tables built from JAX's numpy arrays packs exactly those values,
    once per column set and device/dtype, in the lookup kernels' layout."""
    t = PT.P3Tables(jtab.version, np.asarray(jtab.ice),
                    np.asarray(jtab.collect))
    dev = t.to("cpu", torch.float64)
    assert t.to("cpu", torch.float64) is dev
    ice = dev.ice_cols(range(1, 13))
    np.testing.assert_array_equal(ice.numpy(),
                                  np.moveaxis(np.asarray(jtab.ice), -1, 0))
    assert dev.ice_cols(ICE_COLS) is dev.ice_cols(ICE_COLS)
    coll = dev.collect_cols((2, 1))
    np.testing.assert_array_equal(
        coll.numpy(), np.moveaxis(np.asarray(jtab.collect)[..., [1, 0]], -1,
                                  0))
    # in the lookup kernels' packed layout (p3_lookup_cuda.pack_collect)
    assert coll.stride() == LK.collect_strides(2, torch.float64)
    assert tuple(coll.shape) == (2, 5, 4, 50, 30)
    assert t.to("cpu", torch.float32).ice_cols((2,)).dtype == torch.float32


def test_rain_tables_match_jax():
    for a, b in zip(JT.generate_rain_tables(), PT.generate_rain_tables()):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("finder", ["ice", "collect", "rain_size"])
def test_index_finders_match_jax(finder):
    x = _inputs()
    if finder == "ice":
        args = (x["qi"], x["ni"], x["qm"], x["rhop"])
        fj, fp = JT.ice_table_indices, PT.ice_table_indices
    elif finder == "collect":
        args = (x["qr"], x["nr"])
        fj, fp = JT.rain_collection_index, PT.rain_collection_index
    else:
        args = (x["dm"],)
        fj, fp = JT.rain_size_index, PT.rain_size_index
    want = fj(*(jnp.asarray(a) for a in args))
    got = fp(*(_pt(a) for a in args))
    for k, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        if k % 2 == 0:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-13)
    # the inputs reach both ends of every axis (the clip ranges)
    i0 = got[0].numpy()
    assert i0.min() == 0 and i0.max() == {"ice": 48, "collect": 28,
                                          "rain_size": 298}[finder]


def _lookup(kind, jtab, ptab, dtype):
    """(JAX result, port result) for one lookup family on the same indices
    (JAX's index finders, handed to the port as numpy)."""
    x = _inputs(seed=1)
    idx = JT.ice_table_indices(*(jnp.asarray(x[k])
                                 for k in ("qi", "ni", "qm", "rhop")))
    jr = JT.rain_collection_index(jnp.asarray(x["qr"]), jnp.asarray(x["nr"]))
    rs = JT.rain_size_index(jnp.asarray(x["dm"]))

    def cast(arrs):
        return tuple(a.astype(np.float32) if dtype == torch.float32
                     and a.dtype.kind == "f" else a
                     for a in (np.asarray(b) for b in arrs))
    idx, jr, rs = cast(idx), cast(jr), cast(rs)
    if kind == "ice":
        want = JT.interp_ice_multi(jtab, ICE_COLS,
                                   *(jnp.asarray(a) for a in idx))
        got = PT.interp_ice_multi(ptab, ICE_COLS, *(_pt(a, dtype)
                                                    for a in idx))
    elif kind == "collect":
        want = JT.interp_collect_multi(jtab, (2, 1),
                                       *(jnp.asarray(a) for a in idx + jr))
        got = PT.interp_collect_multi(ptab, (2, 1), *(_pt(a, dtype)
                                                      for a in idx + jr))
    else:
        rows = JT.generate_rain_tables()
        want = JT.interp_rain_multi(rows, *(jnp.asarray(a) for a in rs))
        got = PT.interp_rain_multi(rows, *(_pt(a, dtype) for a in rs))
    return want, got


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["ice", "collect", "rain"])
def test_lookups_match_jax(kind, dtype, jtab, ptab):
    want, got = _lookup(kind, jtab, ptab, dtype)
    assert len(want) == len(got)
    rtol = 1e-13 if dtype == torch.float64 else F32_RTOL[kind]
    for w, g in zip(want, got):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.double().numpy(), np.asarray(w),
                                   rtol=rtol, atol=1e-30)


def test_single_column_forms_match_multi(ptab):
    x = _inputs(seed=2)
    idx = PT.ice_table_indices(*(_pt(x[k]) for k in ("qi", "ni", "qm",
                                                      "rhop")))
    jr = PT.rain_collection_index(_pt(x["qr"]), _pt(x["nr"]))
    multi = PT.interp_ice_multi(ptab, (2, 7), *idx)
    assert torch.equal(PT.interp_ice(ptab, 7, *idx), multi[1])
    assert torch.equal(PT.interp_collect(ptab, 1, *idx, *jr),
                       PT.interp_collect_multi(ptab, (1,), *idx, *jr)[0])
    rows = PT.generate_rain_tables()
    rs = PT.rain_size_index(_pt(x["dm"]))
    assert torch.equal(PT.interp_rain(rows[1], *rs),
                       PT.interp_rain_multi(rows, *rs)[1])


@pytest.mark.parametrize("kind", ["ice", "collect", "rain"])
def test_presence_gate(kind, ptab):
    """present=False gives zeros (the JAX lax.cond's other branch);
    present=True gives the ungated values."""
    x = _inputs(seed=3)
    idx = PT.ice_table_indices(*(_pt(x[k]) for k in ("qi", "ni", "qm",
                                                      "rhop")))
    jr = PT.rain_collection_index(_pt(x["qr"]), _pt(x["nr"]))
    rs = PT.rain_size_index(_pt(x["dm"]))
    dev = ptab.to("cpu", torch.float64)
    call = {"ice": lambda p: LK.interp_ice(dev.ice_cols(ICE_COLS), *idx,
                                           present=p),
            "collect": lambda p: LK.interp_collect(dev.collect_cols((2, 1)),
                                                   *idx, *jr, present=p),
            "rain": lambda p: LK.interp_rain(dev.rain_rows(("vm", "vn")),
                                             *rs, present=p)}[kind]
    base = call(None)
    assert torch.equal(call(torch.tensor(True)), base)
    off = call(torch.tensor(False))
    assert off.shape == base.shape and not off.any() and base.abs().max() > 0


def test_cbrt_is_close_to_exact():
    x = torch.as_tensor(10.0 ** np.random.default_rng(4).uniform(-30, 10,
                                                                 10000))
    np.testing.assert_allclose(PT.cbrt(x).numpy(), np.cbrt(x.numpy()),
                               rtol=4e-16)


def test_table_path_override(monkeypatch, tmp_path):
    assert PT.default_table_path() == JT.default_table_path()
    monkeypatch.setenv("MWML_P3_TABLE", str(tmp_path / "t.dat"))
    assert PT.default_table_path() == str(tmp_path / "t.dat")
    (tmp_path / "t.dat").write_text("VERSION 4.1.1\n 1 2 3\n")
    with pytest.raises(ValueError, match="truncated"):
        PT.load_p3_tables()
