"""The reduced-operation WENO algebra (``opt``) and its approximate-weight
form (``fast_weights``): the flux kernel's form in the JAX package's Pallas
kernels, ported as ``weno_fused.reconstruct_edges_opt``, the flux call's
``opt`` / ``fast_weights`` keywords and ``Dycore(riemann_impl="pallas")``.
On the CPU in float64 and float32.

* Tables: the port's copies of ``_opt_terms`` and ``_high_symforms`` equal
  the JAX package's exactly, at ord 3, 5, 7 and 9.
* ``reconstruct_edges_opt`` against JAX's ``_weno_edges_block_opt`` (a
  plain jnp function, no ``pallas_call``) with exact weights: bit for bit,
  f64 and f32.
* The CUDA kernel's limiter (``weno_edges_opt`` in
  ``csrc/direction_fluxes.cuh``) transliterated to numpy from the flat
  ``opt_coef_table``: bit for bit against the plain version.
* The plain flux in the ``opt`` form against JAX's Pallas kernels
  (``direction_fluxes_pallas`` / ``_sub(..., opt=True,
  fast_weights=False)``, interpret mode): x, y, z bare, z accumulating, y
  with the stage update, at rtol 1e-9 plus 1e-9 of each variable's scale
  (the bound of the reference form, tests/test_torch_flux_epilogue.py).
* One f64 step of ``Dycore(riemann_impl="pallas", fast_weights=False)``
  against JAX's XLA step within 1e-9 of each field's scale, on the fields
  JAX's own test holds to that bound between its Pallas and XLA paths
  (tests/test_pallas.py:60-80; v differs by 3.0e-9 of its scale between
  JAX's own paths, so it is left out there), and every field against JAX's
  Pallas step at the port's step bar.
* Dispatch: a cutoff takes the reference algebra; ``fast_weights`` changes
  nothing in f64, under "xla", or on the CPU; the argument resolution of
  ``Dycore`` is JAX's, ``opt_algebra`` and the cutoff included.
* The reference algebra as the Pallas kernels write it, with a reciprocal
  hook (``weno_fused.reconstruct_edges_recip``, the plain version of the
  kernel with approximate reciprocals): bit for bit against JAX's
  ``_weno_edges_block`` with exact weights, cutoff 0 and 0.1, f64 and f32;
  one f64 step of a dycore that runs it against JAX's
  ``Dycore(riemann_impl="pallas", opt_algebra=False, fast_weights=False)``
  step (interpret mode) at the step bar; and chip_smoke.py's fast bar on it,
  with opt off and with a cutoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.dycore.euler import Dycore as JDycore
from miniweatherml_tpu.ops import weno_fused as JW
from miniweatherml_tpu.ops.pallas_recon import (_weno_edges_block,
                                                _weno_edges_block_opt,
                                                direction_fluxes_pallas,
                                                direction_fluxes_pallas_sub)
from miniweatherml_tpu_torch.dycore.euler import Dycore
from miniweatherml_tpu_torch.ops import weno_fused as PW
from miniweatherml_tpu_torch.ops.direction_fluxes import (
    direction_fluxes, direction_fluxes_plain, limiter_algebra)
from miniweatherml_tpu_torch.ops.weno import weno_matrices
from miniweatherml_tpu_torch.ops.weno_fused import (opt_coef_table,
                                                    opt_dropped,
                                                    reconstruct_edges_opt,
                                                    reconstruct_edges_recip,
                                                    reconstruct_edges_shifted,
                                                    substencils)
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL, _case,
                                     assert_fields_close)
from tests.test_torch_flux_epilogue import (_AX_X, _AX_Y, _AX_Z, _MODE, _call,
                                            _dirs, _rk, _stage_inputs, _state)

torch.set_num_threads(1)

ORDERS = [3, 5, 7, 9]
# the port's table of the reference algebra, which the fast bar's planted
# faults replace for a call and must restore
SPARSE_TERMS = PW._sparse_terms


def _stencils(ord_, dtype, seed):
    """Rows of seeded values with flat, stepped, tiny and smooth stretches
    (flat windows give zero smoothness indicators, so the tiny floor and the
    ideal weights decide there)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 64)) * 0.1 + 1.0
    x[1] = np.sin(0.4 * np.arange(64))
    x[2, 20:] = 0.0
    x[3] = np.where(np.arange(64) < 30, 1.0, 2.0)
    x[4] *= 1e-12
    x[5, ::7] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("ord_", ORDERS)
def test_opt_tables_equal_jax(ord_):
    jt, pt = JW._opt_terms(ord_), PW._opt_terms(ord_)
    assert pt[0] == jt[0] and pt[1] == jt[1] and pt[3] == jt[3]
    assert (jt[2] is None) == (pt[2] is None) == (ord_ > 5)
    if jt[2] is not None:
        np.testing.assert_array_equal(pt[2], jt[2])
    assert PW._high_symforms(ord_) == JW._high_symforms(ord_)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ord_", ORDERS)
def test_reconstruct_edges_opt_matches_jax(ord_, dtype):
    """Bit for bit (tolerance 0) along the last axis and a middle one."""
    x = _stencils(ord_, dtype, ord_)
    n = x.shape[-1] - ord_ + 1
    jl, jr = _weno_edges_block_opt(jnp.asarray(x), n, ord_, axis=-1,
                                   fast_weights=False)
    pl, pr = reconstruct_edges_opt(torch.from_numpy(x), -1, n, ord_)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    y = np.ascontiguousarray(np.stack([x, x[::-1]]).transpose(1, 2, 0))
    jl, jr = _weno_edges_block_opt(jnp.asarray(y), n, ord_, axis=1)
    pl, pr = reconstruct_edges_opt(torch.from_numpy(y), 1, n, ord_)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


def _table_edges_opt(s, ord_):
    """The CUDA kernel's reduced-operation limiter (weno_edges_opt in
    csrc/direction_fluxes.cuh) transliterated to numpy: the flat table read
    at the offsets of ``OptLimiter``, the dropped tap skipped, each sum
    started from its first term.  ``s`` is the list of ord stencil
    arrays."""
    cf = opt_coef_table(ord_)
    dt = s[0].dtype.type
    c = lambda i: dt(cf[i])  # noqa: E731  (the f64 table cast to the type)
    sup = substencils(ord_)
    K, H = len(sup), ord_ // 2
    gamma = ord_ <= 5
    low = [0]
    for st, w in sup[:-1]:
        low.append(low[-1] + (0 if ord_ == 5 else (w - 1) * w))
    ev_off = low[K - 1]
    od_off = ev_off + H * (H + 1)
    gamma_off = od_off + H * H
    edge_off = [gamma_off + (2 * (K - 1) if gamma else 0)]
    for st, w in sup:
        edge_off.append(edge_off[-1] + 2 * w)
    nedge = K - 1 if gamma else K
    idl_off = edge_off[nedge]
    assert idl_off + K == cf.size

    P = [s[i] + s[ord_ - 1 - i] for i in range(H)]
    M = [s[i] - s[ord_ - 1 - i] for i in range(H)]
    th = None
    for e in range(H):
        o = ev_off + e * (H + 1)
        f = c(o + H) * s[H]
        for i in range(H):
            f = f + c(o + i) * P[i]
        th = f * f if th is None else th + f * f
    for d in range(H):
        o = od_off + d * H
        f = c(o) * M[0]
        for i in range(1, H):
            f = f + c(o + i) * M[i]
        th = th + f * f
    tv = [None] * K
    tv[K - 1] = th
    if ord_ == 5:
        e0, e1, e2, e3 = s[0] - s[1], s[2] - s[1], s[2] - s[3], s[4] - s[3]
        d0, d1, d2 = e0 + e1, e1 + e2, e2 + e3
        m13 = e2 - e1
        f0, f2 = d0 + dt(2) * e1, d2 + dt(2) * e2
        c1312, c14 = dt(13.0 / 12.0), dt(0.25)
        tv[0] = c1312 * (d0 * d0) + c14 * (f0 * f0)
        tv[1] = c1312 * (d1 * d1) + c14 * (m13 * m13)
        tv[2] = c1312 * (d2 * d2) + c14 * (f2 * f2)
    else:
        for k, (st, w) in enumerate(sup[:-1]):
            acc = None
            for m in range(w - 1):
                f = None
                for q in range(w):
                    if opt_dropped(ord_, k, m, q):
                        continue
                    t = c(low[k] + m * w + q) * s[st + q]
                    f = t if f is None else f + t
                acc = f * f if acc is None else acc + f * f
            tv[k] = acc
    T = tv[0]
    for v in tv[1:]:
        T = T + v
    tiny = dt(1e-300 if dt is np.float64 else 1e-35)
    e2 = dt(1e-20) * (T * T) + tiny
    w = [c(idl_off + k) * (dt(1) / (tv[k] * tv[k] + e2)) for k in range(K)]
    tot = w[0]
    for v in w[1:]:
        tot = tot + v
    inv = dt(1) / tot
    edges = []
    for e in range(2):
        acc = None
        for k in range(nedge):
            st, wd = sup[k]
            cw = ((w[k] + c(gamma_off + e * (K - 1) + k) * w[K - 1]) * inv
                  if gamma else w[k] * inv)
            o = edge_off[k] + e * wd
            ek = c(o) * s[st]
            for i in range(1, wd):
                ek = ek + c(o + i) * s[st + i]
            t = cw * ek
            acc = t if acc is None else acc + t
        edges.append(acc)
    return edges


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ord_", ORDERS)
def test_opt_table_reproduces_reconstruction(ord_, dtype):
    """The kernel's table-driven limiter equals the plain version bit for
    bit, and the table has the kernel's layout size."""
    x = _stencils(ord_, dtype, 20 + ord_)
    n = x.shape[-1] - ord_ + 1
    with np.errstate(all="ignore"):
        left, right = _table_edges_opt(
            [x[:, i:i + n] for i in range(ord_)], ord_)
    pl, pr = reconstruct_edges_opt(torch.from_numpy(x), -1, n, ord_)
    np.testing.assert_array_equal(left, pl.numpy())
    np.testing.assert_array_equal(right, pr.numpy())
    assert opt_coef_table(ord_).size == {3: 22, 5: 38, 7: 75, 9: 94}[ord_]


@pytest.mark.parametrize("ord_", ORDERS)
def test_opt_table_fits_the_kernels_constant_memory(ord_):
    """csrc/direction_fluxes.cuh keeps each order's opt table in a
    __constant__ row of COEF_MAX values and checks its size against the
    layout (static_assert of OptLimiter<ORD>::SIZE)."""
    import os
    import re

    from miniweatherml_tpu_torch.ops import direction_fluxes as DF
    src = open(os.path.join(os.path.dirname(DF.__file__), "..", "csrc",
                            "direction_fluxes.cuh")).read()
    assert opt_coef_table(ord_).size <= int(
        re.search(r"COEF_MAX = (\d+);", src).group(1))
    assert f"OptLimiter<{ord_}>::SIZE == {opt_coef_table(ord_).size}" in src


# -- the flux call against the JAX package's Pallas kernels -------------------

@pytest.fixture(scope="module")
def supercell():
    return _state("supercell", 16, 8, 10)


def _jax_fluxes(prim, d, ps, pd, acc=None, rk=None):
    """JAX's Pallas kernel of the direction in its default (opt) algebra
    with exact weights, whole axis (in-kernel halos), on the layout its
    dycore hands it; the state divergence back as (5, nens, nz, ny, nx)
    and the tracer faces as (ntr, ...) with n + 1 along the axis."""
    axis, n, bc, nid, width, hr, ht = d
    g, c = ps.grid, pd._consts(ps)
    nvar = prim.shape[0]
    mode = _MODE[bc]
    kw = dict(fast_weights=False, opt=True, bc=(mode, mode),
              div_scale=1.0 / width, self_bc=mode)
    args = (n, pd.mats, 0.0, nid, c.C0, c.gamma)
    if axis == _AX_X:
        B = g.nens * g.nz * g.ny
        rows = lambda h: np.broadcast_to(  # noqa: E731
            h.numpy()[:, :, None, None], (g.nens, g.nz, g.ny, n + 1)
        ).reshape(B, n + 1)
        sf, tf = direction_fluxes_pallas(
            jnp.asarray(prim.numpy().reshape(nvar, B, n)), None, None,
            jnp.asarray(rows(hr)), jnp.asarray(rows(ht)), *args, **kw)
        tshape = (nvar - 5, g.nens, g.nz, g.ny, n + 1)
    else:
        if axis == _AX_Y:
            shape = (g.nens * g.nz, n, g.nx)
            hy_r = hr.numpy().reshape(-1, 1)
            hy_t = ht.numpy().reshape(-1, 1)
            tshape = (nvar - 5, g.nens, g.nz, n + 1, g.nx)
        else:
            shape = (g.nens, n, g.ny * g.nx)
            hy_r, hy_t = hr.numpy(), ht.numpy()
            tshape = (nvar - 5, g.nens, n + 1, g.ny, g.nx)

        def j(a, rows_):
            return None if a is None else jnp.asarray(
                a.numpy().reshape((rows_,) + shape))
        kw["acc"] = j(acc, 5)
        if rk is not None:
            kw["rk"] = (np.array([rk.c0, rk.c1, rk.cdt]), j(rk.b0, 5),
                        j(rk.b1, 5), 0.0 if rk.grav is None else rk.grav,
                        rk.fcor)
        sf, tf = direction_fluxes_pallas_sub(
            j(prim, nvar), None, None, jnp.asarray(hy_r), jnp.asarray(hy_t),
            *args, **kw)
    return (np.asarray(sf).reshape((5,) + tuple(prim.shape[1:])),
            np.asarray(tf).reshape(tshape))


def _close(got, want, rtol=1e-9, of_scale=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=of_scale * np.abs(want).max())


# (direction, epilogue: None bare, "acc" accumulating, stage of the update)
JAX_FORMS = {"x": (_AX_X, None), "y": (_AX_Y, None), "z": (_AX_Z, None),
             "z_acc": (_AX_Z, "acc"), "y_stage2": (_AX_Y, 2)}


@pytest.mark.parametrize("form", list(JAX_FORMS))
def test_plain_opt_flux_matches_jax_kernel(form, supercell):
    ps, pd = supercell
    axis, epi = JAX_FORMS[form]
    prim, b0, b1 = _stage_inputs(ps, pd, epi if isinstance(epi, int) else 1)
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    opt = dict(opt=True, fast_weights=False)
    acc = rk = None
    if epi is not None:
        acc = _call(direction_fluxes_plain, prim, dirs[_AX_X], pd, c,
                    **opt)[0]
        if axis == _AX_Y:
            acc = acc + _call(direction_fluxes_plain, prim, dirs[_AX_Z], pd,
                              c, **opt)[0]
        if isinstance(epi, int):
            rk = _rk(ps, pd, epi, b0, b1)
    want_s, want_t = _jax_fluxes(prim, dirs[axis], ps, pd, acc, rk)
    got_s, got_t = _call(direction_fluxes_plain, prim, dirs[axis], pd, c,
                         acc=None if acc is None else acc.clone(), rk=rk,
                         **opt)
    for v in range(5):
        _close(got_s[v], want_s[v])
    for q in range(got_t.shape[0]):
        _close(got_t[q], want_t[q])
    # the opt form is not the reference form: the two differ in rounding
    ref_s, _ = _call(direction_fluxes_plain, prim, dirs[axis], pd, c,
                     acc=None if acc is None else acc.clone(), rk=rk)
    assert not torch.equal(ref_s, got_s)


# the fields JAX's own Pallas-against-XLA step test holds at 1e-9 of scale
# (tests/test_pallas.py:60-80); v, near zero in this case, differs there by
# 3.0e-9 of its scale between JAX's own two paths
XLA_FIELDS = ("density_dry", "uvel", "wvel", "temp", "water_vapor")


def test_pallas_dycore_step_matches_jax():
    """One f64 step of the 16x8x10 supercell with riemann_impl="pallas"
    (exact weights): the fields of JAX's own test within 1e-9 of each
    field's scale of JAX's XLA step, and every field within the port's step
    bar (rtol 1e-9 plus 1e-7 of scale, tests/test_torch_dycore.py) of JAX's
    jitted Pallas step (interpret mode)."""
    js, jd, ps, _ = _case("supercell", 16, 8, 10)
    assert jd.riemann_impl == "xla"
    pd = Dycore(ord=5, riemann_impl="pallas", fast_weights=False)
    assert pd.limiter_form() == {"opt": True, "fast_weights": False}
    dt = jd.compute_time_step(js)
    got = pd.time_step(ps, dt)
    xla = jax.jit(lambda s: jd.time_step(s, dt))(js)
    assert_fields_close(xla, got, 0.0, 1e-9, names=XLA_FIELDS)
    jp = JDycore(ord=5, riemann_impl="pallas", fast_weights=False)
    pallas = jax.jit(lambda s: jp.time_step(s, dt))(js)
    assert_fields_close(pallas, got, STEP_RTOL, STEP_ATOL_OF_SCALE)
    # and not the reference algebra's step
    ref = Dycore(ord=5).time_step(ps, dt)
    assert not torch.equal(ref["uvel"], got["uvel"])


# -- dispatch -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cutoff", "no_opt"])
def test_reference_algebra_without_opt_or_with_a_cutoff(case, supercell):
    """A cutoff (the Pallas kernels take the reference algebra then) or
    opt=False runs reconstruct_edges_shifted: the reference form bit for
    bit."""
    ps, pd = supercell
    prim, _, _ = _stage_inputs(ps, pd, 1)
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    axis, n, bc, nid, width, hr, ht = dirs[_AX_Y]
    cutoff = 0.1 if case == "cutoff" else 0.0
    form = dict(opt=case == "cutoff", fast_weights=True)
    assert limiter_algebra(cutoff=cutoff, dtype=prim.dtype, **form) == "ref"
    args = (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht, pd.mats, cutoff,
            1.0 / width)
    got = direction_fluxes_plain(*args, **form)
    want = direction_fluxes_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fast_weights_changes_nothing_on_the_cpu_in_f64_or_under_xla(
        supercell):
    """On the CPU fast_weights runs the exact reciprocal (f32 and f64: equal
    to opt bit for bit); in f64 the algebra is "opt" even on the card; a
    dycore under "xla" ignores it."""
    assert limiter_algebra(True, True, 0.0, torch.float64) == "opt"
    assert limiter_algebra(True, True, 0.0, torch.float32) == "fast"
    assert limiter_algebra(True, False, 0.0, torch.float32) == "opt"
    ps, pd = supercell
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    for dtype in (torch.float64, torch.float32):
        prim = _stage_inputs(ps, pd, 1)[0].to(dtype)
        for d in dirs.values():
            d = d[:5] + (d[5].to(dtype), d[6].to(dtype))
            fast = _call(direction_fluxes, prim, d, pd, c, opt=True,
                         fast_weights=True)
            opt = _call(direction_fluxes, prim, d, pd, c, opt=True)
            assert all(torch.equal(a, b) for a, b in zip(fast, opt))
    xla = Dycore(ord=5, riemann_impl="xla", fast_weights=True)
    assert xla.limiter_form() == {"opt": False, "fast_weights": False}


# chip_smoke.py's bar of the fast form (approximate reciprocals) against
# its exact plain version, run here on the plain opt flux of the f32
# supercell: a one-ulp change of the reciprocals that is not one of the
# bar's own model runs passes; planted faults fail
BAR_CASES = ["one ulp toward 2^-60", "reciprocals 2^-12 off",
             "idl_0 off by 1e-3"]


@pytest.fixture(scope="module")
def supercell_f32():
    ps, pd = _state("supercell", 16, 8, 10, dtype="float32")
    return ps, pd, _stage_inputs(ps, pd, 1)[0]


@pytest.mark.parametrize("case", BAR_CASES)
@pytest.mark.parametrize("axis", [_AX_X, _AX_Y, _AX_Z])
def test_fast_bar_passes_one_ulp_and_fails_planted_faults(axis, case,
                                                          supercell_f32):
    import chip_smoke as cs
    ps, pd, prim = supercell_f32
    d, c = _dirs(ps, pd)[axis], pd._consts(ps)

    def plain():
        return _call(direction_fluxes_plain, prim, d, pd, c, opt=True,
                     fast_weights=False)
    ref = plain()
    model = cs._one_ulp_model(plain, ref)
    exact = PW._recip
    if case == BAR_CASES[0]:
        recip, terms = (lambda v: torch.nextafter(
            exact(v), torch.full_like(v, 2.0 ** -60))), None
    else:
        recip, terms = cs._fault_models()[case]
    got = cs._with_recip(recip, plain, terms)
    assert not all(torch.equal(a, b) for a, b in zip(ref, got))
    ok, per = cs._fast_verdict(ref, got, model)
    assert ok == (case == BAR_CASES[0]), cs._verdict_text(per, model)
    assert PW._recip is exact  # the limiter is restored


# every combination the JAX package accepts but "auto" (the port's "auto"
# is "xla" on every device) and its test oracle opt_algebra=False (the
# port's oracle of the reference algebra is "xla")
RESOLUTIONS = [(impl, fw) for impl in ("xla", "pallas")
               for fw in (None, True, False)]


@pytest.mark.parametrize("impl,fw", RESOLUTIONS)
def test_dycore_resolution_matches_jax(impl, fw):
    j = JDycore(ord=5, riemann_impl=impl, fast_weights=fw)
    p = Dycore(ord=5, riemann_impl=impl, fast_weights=fw)
    assert (p.riemann_impl, p.fast_weights) == (j.riemann_impl,
                                                j.fast_weights)
    assert p.limiter_form() == {"opt": impl == "pallas" and j.opt_algebra,
                                "fast_weights": impl == "pallas"
                                and j.fast_weights}


def test_dycore_auto_is_the_reference_algebra_and_bad_impls_raise():
    d = Dycore()
    assert (d.riemann_impl, d.fast_weights) == ("xla", False)
    assert d.limiter_form() == {"opt": False, "fast_weights": False}
    for cls in (JDycore, Dycore):
        with pytest.raises(ValueError, match="riemann_impl"):
            cls(ord=5, riemann_impl="cuda")


# the YAML keys of the JAX package's builds (supercell_example.py:36-42,
# simple_city.py:33-35)
YAML_KEYS = {"none": {}, "pallas": {"riemann_impl": "pallas"},
             "pallas_exact": {"riemann_impl": "pallas",
                              "fast_weights": False},
             "xla_fast": {"riemann_impl": "xla", "fast_weights": True}}


@pytest.mark.parametrize("keys", list(YAML_KEYS))
@pytest.mark.parametrize("experiment", ["supercell_example", "simple_city"])
def test_yaml_keys_reach_the_dycore(experiment, keys):
    import importlib

    from miniweatherml_tpu.config import config_from_dict as jax_config
    from miniweatherml_tpu_torch.config import config_from_dict
    raw = dict(sim_time=1.0, nens=1, nx_glob=8, ny_glob=4, nz=6,
               xlen=2000.0, ylen=2000.0, zlen=300.0, out_prefix="t",
               dt_phys=0.0, out_freq=-1.0, dtype="float64", dyn_order=3,
               init_data="supercell" if experiment == "supercell_example"
               else "city", **YAML_KEYS[keys])
    mod = importlib.import_module(
        f"miniweatherml_tpu_torch.experiments.{experiment}")
    built = mod.build(config_from_dict(raw), "cpu")
    got = built[2]
    # the JAX build's own Dycore call on its config (its build would run
    # JAX's whole init; the constructor call is written out as it is there)
    ex = jax_config(raw).extras
    want = JDycore(ord=int(ex.get("dyn_order", 5)),
                   riemann_impl=str(ex.get("riemann_impl", "auto")),
                   fast_weights=(bool(ex["fast_weights"])
                                 if "fast_weights" in ex else None))
    if keys == "none":  # JAX's "auto" is "xla" off a single TPU
        assert want.riemann_impl == "xla"
    assert (got.ord, got.riemann_impl, got.fast_weights) \
        == (want.ord, want.riemann_impl, want.fast_weights)
    assert got.limiter_form()["opt"] == (want.riemann_impl == "pallas"
                                         and want.opt_algebra)


# -- the reference algebra with a reciprocal hook ------------------------------

@pytest.mark.parametrize("cutoff", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ord_", ORDERS)
def test_reconstruct_edges_recip_matches_jax(ord_, dtype, cutoff):
    """reconstruct_edges_recip against JAX's _weno_edges_block (a plain jnp
    function) with exact weights: bit for bit along the last axis and a
    middle one; and within rounding of reconstruct_edges_shifted (the same
    algebra with idl / x weights)."""
    x = _stencils(ord_, dtype, ord_ + 50)
    n = x.shape[-1] - ord_ + 1
    terms = JW._sparse_terms(ord_, 0)
    mats = weno_matrices(ord_)
    for arr, axis in ((x, -1), (np.ascontiguousarray(
            np.stack([x, x[::-1]]).transpose(1, 2, 0)), 1)):
        jl, jr = _weno_edges_block(jnp.asarray(arr), n, ord_, *terms, cutoff,
                                   axis=axis, fast_weights=False)
        pl, pr = reconstruct_edges_recip(torch.from_numpy(arr), axis, n,
                                         mats, cutoff)
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        sl, sr = reconstruct_edges_shifted(torch.from_numpy(arr), axis, n,
                                           mats, cutoff)
        eps = np.finfo(dtype).eps
        for a, b in ((pl, sl), (pr, sr)):
            assert (a - b).abs().max().item() <= 64 * eps * max(
                b.abs().max().item(), 1e-300)


def test_recip_algebra_dycore_step_matches_jax(monkeypatch):
    """One f64 step of the 16x8x10 supercell whose flux runs
    reconstruct_edges_recip (riemann_impl="pallas", opt_algebra=False, the
    dispatch sent to the reference-with-reciprocals form, which f64 never
    takes on its own) against JAX's jitted Dycore(riemann_impl="pallas",
    opt_algebra=False, fast_weights=False) step (interpret mode: the same
    algebra with exact reciprocals) at the port's step bar."""
    from miniweatherml_tpu_torch.ops import direction_fluxes as DF
    js, jd, ps, _ = _case("supercell", 16, 8, 10)
    pd = Dycore(ord=5, riemann_impl="pallas", opt_algebra=False,
                fast_weights=False)
    assert pd.limiter_form() == {"opt": False, "fast_weights": False}
    calls = []
    real = DF.reconstruct_edges_recip

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(DF, "reconstruct_edges_recip", counted)
    monkeypatch.setattr(DF, "limiter_algebra",
                        lambda *a, **k: "ref_fast")
    dt = jd.compute_time_step(js)
    got = pd.time_step(ps, dt)
    assert len(calls) >= 9  # every direction of every stage
    jp = JDycore(ord=5, riemann_impl="pallas", opt_algebra=False,
                 fast_weights=False)
    pallas = jax.jit(lambda s: jp.time_step(s, dt))(js)
    assert_fields_close(pallas, got, STEP_RTOL, STEP_ATOL_OF_SCALE)


# every combination of the JAX package's keywords but "auto" (the port's
# "auto" is "xla" on every device), with a cutoff and without
OPT_RESOLUTIONS = [(impl, fw, oa, co) for impl in ("xla", "pallas")
                   for fw in (None, True, False) for oa in (True, False)
                   for co in (0.0, 0.1)]


@pytest.mark.parametrize("impl,fw,oa,co", OPT_RESOLUTIONS)
def test_dycore_opt_algebra_resolves_as_jax(impl, fw, oa, co):
    """Dycore(riemann_impl, fast_weights, opt_algebra, cutoff): the flux
    call's algebra in f32 and f64 is the one JAX's dycore runs -- "xla"
    the reference algebra with exact weights; "pallas" the Pallas kernels'
    _weno_edges, opt with opt_algebra at cutoff 0, approximate reciprocals
    with fast_weights in f32."""
    j = JDycore(ord=5, cutoff=co, riemann_impl=impl, fast_weights=fw,
                opt_algebra=oa)
    p = Dycore(ord=5, cutoff=co, riemann_impl=impl, fast_weights=fw,
               opt_algebra=oa)
    assert (p.riemann_impl, p.fast_weights, p.opt_algebra, p.cutoff) == (
        j.riemann_impl, j.fast_weights, j.opt_algebra, j.cutoff)
    for dtype in (torch.float32, torch.float64):
        if j.riemann_impl == "xla":
            want = "ref"
        else:
            opt = j.opt_algebra and j.cutoff == 0.0
            fast = j.fast_weights and dtype == torch.float32
            want = {(True, True): "fast", (True, False): "opt",
                    (False, True): "ref_fast", (False, False): "ref"}[
                        (opt, fast)]
        got = limiter_algebra(cutoff=p.cutoff, dtype=dtype,
                              **p.limiter_form())
        assert got == want, (dtype, got, want)


@pytest.mark.parametrize("case", BAR_CASES)
@pytest.mark.parametrize("axis", [_AX_X, _AX_Y, _AX_Z])
@pytest.mark.parametrize("form", ["no_opt", "cutoff"])
def test_fast_bar_on_the_reference_algebra(form, axis, case, supercell_f32):
    """chip_smoke.py's fast bar on the plain flux of the reference algebra
    with approximate reciprocals (opt off, or a cutoff of 0.1 with opt on)
    of the f32 supercell: a one-ulp change of its reciprocals outside the
    bar's own model passes; planted faults (reciprocals 2^-12 off, idl_0
    off in the reference table) fail."""
    import chip_smoke as cs
    ps, pd, prim = supercell_f32
    d, c = _dirs(ps, pd)[axis], pd._consts(ps)
    cutoff = 0.1 if form == "cutoff" else 0.0
    kw = dict(opt=form == "cutoff", fast_weights=True)
    assert limiter_algebra(cutoff=cutoff, dtype=prim.dtype, **kw) == \
        "ref_fast"
    axis_, n, bc, nid, width, hr, ht = d

    def plain():
        return direction_fluxes_plain(prim, axis_, n, bc, nid, c.C0,
                                      c.gamma, hr, ht, pd.mats, cutoff,
                                      1.0 / width, **kw)
    ref = plain()
    model = cs._one_ulp_model(plain, ref)
    exact = PW._recip
    if case == BAR_CASES[0]:
        recip, terms = (lambda v: torch.nextafter(
            exact(v), torch.full_like(v, 2.0 ** -60))), None
    else:
        recip, terms = cs._fault_models()[case]
    got = cs._with_recip(recip, plain, terms)
    assert not all(torch.equal(a, b) for a, b in zip(ref, got))
    ok, per = cs._fast_verdict(ref, got, model)
    assert ok == (case == BAR_CASES[0]), cs._verdict_text(per, model)
    assert PW._recip is exact and PW._sparse_terms is SPARSE_TERMS
