"""WENO reconstruction from shifted slices, in two algebras.

The reference algebra is the port of
``miniweatherml_tpu/ops/weno_fused.py::reconstruct_edges_shifted``: the
limiter evaluated as elementwise arithmetic over ``ord`` shifted views of
the padded input,

  TV_k   = sum_{ij} G_k[i,j] * shift_i * shift_j     (sparse symmetric sum)
  w_k    = convexify(idl_k / (convexify(TV)_k^2 + 1e-20))
  edge_e = sum_k w_k * sum_i E_k[e,i] * shift_i

with the same term order as the JAX function.  The reduced-operation
("opt") algebra, ``reconstruct_edges_opt``, is the port of the one the JAX
package's Pallas kernels run (``miniweatherml_tpu/ops/pallas_recon.py::
_weno_edges_block_opt`` with ``weno_fused._opt_terms`` and
``_high_symforms``): squared linear forms for the smoothness indicators
(the Jiang-Shu form on shared differences at ord 5), one fused weight
normalisation, and at ord 3 and 5 the high-order edge folded into the
low-order blend through the exact optimal weights.  A third,
``reconstruct_edges_recip``, is the reference algebra as the Pallas
kernels write it (``pallas_recon.py::_weno_edges_block``): each weight is
idl_k times the reciprocal of its denominator, every reciprocal through
``_recip``, the hook that the approximate-reciprocal kernel's bar moves by
one ulp.  All are plain reconstructions; the CUDA flux kernels
(``csrc/direction_fluxes.cuh``, ``csrc/direction_fluxes_opt.cu``,
``csrc/direction_fluxes_ref_fast.cu``) run the same sums from the
coefficient tables that ``weno_coef_table`` and ``opt_coef_table`` build.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .exact_div import exact_div
from .weno import WenoMatrices, weno_matrices

__all__ = ["reconstruct_edges_shifted", "reconstruct_edges_recip",
           "reconstruct_edges_opt", "weno_coef_table", "opt_coef_table",
           "substencils"]


@lru_cache(maxsize=None)
def _sparse_terms(ord_: int):
    """Sparse (i, j, coef) TV terms, (i, coef) edge terms and the convexified
    ideal weights of one order (terms with a coefficient below 1e-14 of the
    largest are dropped, as in the JAX package)."""
    mats = weno_matrices(ord_)
    K = mats.G.shape[0]
    tv_terms = []
    for k in range(K):
        G = mats.G[k]
        terms = []
        for i in range(ord_):
            for j in range(i, ord_):
                c = G[i, j] if i == j else G[i, j] + G[j, i]
                if abs(c) > 1e-14 * max(1.0, abs(G).max()):
                    terms.append((i, j, float(c)))
        tv_terms.append(tuple(terms))
    edge_terms = []
    for k in range(K):
        per_edge = []
        for e in range(2):
            row = [(i, float(mats.E[k, e, i])) for i in range(ord_)
                   if abs(mats.E[k, e, i]) > 1e-14]
            per_edge.append(tuple(row))
        edge_terms.append(tuple(per_edge))
    return tuple(tv_terms), tuple(edge_terms), tuple(float(v) for v in mats.idl)


def substencils(ord_: int) -> list[tuple[int, int]]:
    """(first stencil index, width) of each candidate polynomial's support
    within the ``ord``-wide stencil (ops/weno.py ``_substencils``)."""
    hs = (ord_ - 1) // 2
    if ord_ == 3:
        return [(0, 2), (1, 2), (0, 3)]
    return [(hs - 2, 3), (hs - 1, 3), (hs, 3), (0, ord_)]


@lru_cache(maxsize=None)
def weno_coef_table(ord_: int) -> np.ndarray:
    """The limiter as one flat float64 table for the CUDA flux kernel.

    For each candidate k with support (s, w) from ``substencils``: the TV
    pair coefficients c_ij for s <= i <= j < s + w in row-major order, then
    for each candidate and edge the w edge coefficients, then the K ideal
    weights.  Coefficients that ``_sparse_terms`` drops are stored as exact
    zeros, so a kernel that walks the dense support adds the same nonzero
    terms in the same order as ``reconstruct_edges_shifted``.
    """
    tv_terms, edge_terms, idl = _sparse_terms(ord_)
    sup = substencils(ord_)
    out: list[float] = []
    for k, (s, w) in enumerate(sup):
        c = {(i, j): v for i, j, v in tv_terms[k]}
        if any(not (s <= i <= j < s + w) for i, j in c):
            raise AssertionError("TV term outside its candidate's support")
        out += [c.get((i, j), 0.0) for i in range(s, s + w)
                for j in range(i, s + w)]
    for k, (s, w) in enumerate(sup):
        for e in range(2):
            c = dict(edge_terms[k][e])
            if any(not (s <= i < s + w) for i in c):
                raise AssertionError("edge term outside its candidate's support")
            out += [c.get(i, 0.0) for i in range(s, s + w)]
    out += list(idl)
    return np.asarray(out, np.float64)


def _reference_edges(padded, axis, n_out, mats, cutoff, inverse, weight):
    """The reference algebra's edges; ``inverse(tot)`` is a normalisation's
    reciprocal and ``weight(idl_k, d)`` the weight idl_k / d."""
    ord_ = mats.ord
    tv_terms, edge_terms, idl = _sparse_terms(ord_)
    shifts = [padded.narrow(axis, i, n_out) for i in range(ord_)]

    tvs = []
    for terms in tv_terms:
        acc = None
        for i, j, c in terms:
            t = c * shifts[i] * shifts[j]
            acc = t if acc is None else acc + t
        tvs.append(acc)

    eps = 1e-20

    def convexify(vals):
        tot = vals[0]
        for v in vals[1:]:
            tot = tot + v
        big = tot > eps
        inv = torch.where(big, inverse(torch.where(big, tot, 1.0)), 1.0)
        return [v * inv for v in vals]

    tvs = convexify(tvs)
    ws = convexify([weight(idl_k, tv * tv + eps)
                    for idl_k, tv in zip(idl, tvs)])
    if cutoff > 0.0:
        ws = [torch.where(w > cutoff, w, 0.0) for w in ws[:-1]] + [ws[-1]]
        ws = convexify(ws)

    edges = []
    for e in range(2):
        acc = None
        for k, w in enumerate(ws):
            ek = None
            for i, c in edge_terms[k][e]:
                t = c * shifts[i]
                ek = t if ek is None else ek + t
            t = w * ek
            acc = t if acc is None else acc + t
        edges.append(acc)
    return edges[0], edges[1]


def reconstruct_edges_shifted(padded: torch.Tensor, axis: int, n_out: int,
                              mats: WenoMatrices, cutoff: float = 0.0):
    """WENO-limited left/right edge values from a padded tensor.

    ``padded`` holds >= (ord-1)/2 halo cells on each side of ``axis``;
    returns (left, right), each shaped like the input with ``axis`` length
    ``n_out``: the limited values at each cell's minus/plus face.  Each
    weight is an IEEE division: a 0-d numerator keeps it one (Python scalar
    / tensor in torch is a reciprocal times the scalar).
    """
    return _reference_edges(
        padded, axis, n_out, mats, cutoff, lambda tot: 1.0 / tot,
        exact_div)


def reconstruct_edges_recip(padded: torch.Tensor, axis: int, n_out: int,
                            mats: WenoMatrices, cutoff: float = 0.0):
    """WENO-limited left/right edge values in the reference algebra as the
    Pallas kernels write it (``_weno_edges_block`` of the JAX package, term
    for term): ``reconstruct_edges_shifted`` with every normalisation
    ``tot > eps ? _recip(tot) : 1`` and each weight idl_k times
    ``_recip(tv^2 + eps)``.  With the exact ``_recip`` it differs from
    ``reconstruct_edges_shifted`` only in the weights' rounding, idl_k
    (1 / x) against idl_k / x; it is the plain version of the kernel that
    takes the approximate reciprocal
    (``csrc/direction_fluxes_ref_fast.cu``).  Arguments and result as in
    ``reconstruct_edges_shifted``."""
    # _recip is looked up at each call: the fast bar's model runs replace it
    return _reference_edges(padded, axis, n_out, mats, cutoff,
                            lambda tot: _recip(tot),
                            lambda idl_k, d: idl_k * _recip(d))


# -- the reduced-operation algebra ---------------------------------------------

@lru_cache(maxsize=None)
def _opt_terms(ord_: int):
    """The reduced-operation formulation of the limiter (a copy of the JAX
    package's ``weno_fused._opt_terms``, on the port's tables):

    * TV_k as a sum of squared linear forms from the eigendecomposition of
      the PSD G_k, rank(G_k) = taps - 1 forms;
    * the two normalisations folded into one, w'_k = idl_k / (TV_k^2 +
      eps T^2 + tiny) with T = sum TV;
    * at ord 3 and 5 the high-order edge as the exact optimal combination
      ``gamma`` of the low-order edges, so it is never evaluated.

    Returns (tv_factors, edge_terms, gamma, idl): per candidate a tuple of
    linear forms, each a tuple of (i, coef); per candidate (the low-order
    ones only when ``gamma`` is set) and edge a tuple of (i, coef); gamma a
    (2, K - 1) array or None (ord 7 and 9); the convexified ideal weights.
    """
    mats = weno_matrices(ord_)
    K = mats.G.shape[0]
    tv_factors = []
    for k in range(K):
        G = mats.G[k]
        w, V = np.linalg.eigh(G)
        forms = []
        for m in range(len(w)):
            if w[m] > 1e-12 * w.max():
                g = np.sqrt(w[m]) * V[:, m]
                forms.append(tuple((i, float(g[i])) for i in range(ord_)
                                   if abs(g[i]) > 1e-14))
        tv_factors.append(tuple(forms))

    gamma = None
    if ord_ in (3, 5):
        gam = np.empty((2, K - 1))
        for e in range(2):
            A = np.stack([mats.E[k, e] for k in range(K - 1)], axis=1)
            g, _, _, _ = np.linalg.lstsq(A, mats.E[K - 1, e], rcond=None)
            assert np.abs(A @ g - mats.E[K - 1, e]).max() < 1e-12
            gam[e] = g
        gamma = gam
        ks = range(K - 1)
    else:
        ks = range(K)
    edge_terms = []
    for k in ks:
        per_edge = []
        for e in range(2):
            row = [(i, float(mats.E[k, e, i])) for i in range(ord_)
                   if abs(mats.E[k, e, i]) > 1e-14]
            per_edge.append(tuple(row))
        edge_terms.append(tuple(per_edge))
    return (tuple(tv_factors), tuple(edge_terms), gamma,
            tuple(float(v) for v in mats.idl))


@lru_cache(maxsize=None)
def _high_symforms(ord_: int):
    """Even and odd eigenforms of the high-order TV (a copy of the JAX
    package's ``weno_fused._high_symforms``): G_high is persymmetric, so
    TV_high = sum_e (ev_e . P)^2 + sum_o (od_o . M)^2 on the pair sums
    P_i = s_i + s_{n-1-i} (plus the centre sample) and pair differences
    M_i = s_i - s_{n-1-i}.  Returns (even, odd): an even entry is (pair
    coefs..., centre coef), an odd one (pair coefs...)."""
    G = np.asarray(weno_matrices(ord_).G[-1], float)
    n = G.shape[0]
    J = np.eye(n)[::-1]
    assert np.abs(J @ G @ J - G).max() <= 1e-12 * np.abs(G).max()
    h = n // 2
    # G block-diagonalises exactly in the orthonormal even / odd bases, so
    # every eigenform is purely even or purely odd
    Be = np.zeros((n, h + n % 2))
    Bo = np.zeros((n, h))
    for i in range(h):
        Be[i, i] = Be[n - 1 - i, i] = 1.0 / np.sqrt(2.0)
        Bo[i, i] = 1.0 / np.sqrt(2.0)
        Bo[n - 1 - i, i] = -1.0 / np.sqrt(2.0)
    if n % 2:
        Be[h, h] = 1.0
    blocks = []
    for B in (Be, Bo):
        Gs = B.T @ G @ B
        w, U = np.linalg.eigh((Gs + Gs.T) / 2.0)
        blocks.append((B, w, U))
    wmax = max(b[1].max(initial=0.0) for b in blocks)
    even, odd = [], []
    for out, (B, w, U) in zip((even, odd), blocks):
        for i in range(len(w)):
            if w[i] <= 1e-12 * wmax:
                continue
            out.append(B @ U[:, i] * np.sqrt(w[i]))
    ev = tuple(tuple([float(v[i]) for i in range(h)] + [float(v[h])])
               for v in even)
    od = tuple(tuple(float(v[i]) for i in range(h)) for v in odd)
    return ev, od


def opt_dropped(ord_: int, k: int, m: int, q: int) -> bool:
    """Whether tap ``q`` of candidate ``k``'s smoothness form ``m`` is one
    that ``_opt_terms`` drops (its coefficient is zero): the middle tap of
    the centred 3-tap candidate's first form, (1, 0, -1), at ord 7 and 9
    (ord 5 runs the Jiang-Shu form instead).  The CUDA kernel skips the
    same tap at compile time (``csrc/direction_fluxes.cuh``,
    ``OptLimiter::dropped``)."""
    return ord_ >= 7 and k == 1 and m == 0 and q == 1


@lru_cache(maxsize=None)
def opt_coef_table(ord_: int) -> np.ndarray:
    """The reduced-operation limiter as one flat float64 table for the CUDA
    flux kernel's ``__constant__`` memory, in this order:

      1. ord 3, 7, 9: for each low-order candidate k with support (s, w)
         from ``substencils``, its w - 1 smoothness forms, w coefficients
         each over the support (a dropped tap, ``opt_dropped``, is stored
         as 0 and skipped by the kernel); ord 5 has none (Jiang-Shu);
      2. the ord // 2 even high-order forms (ord // 2 pair coefficients,
         then the centre one), then the ord // 2 odd ones;
      3. ord 3, 5: gamma[0, :], gamma[1, :];
      4. for each candidate of ``_opt_terms``'s edge terms and each edge,
         w coefficients over its support;
      5. the K ideal weights.
    """
    tv_factors, edge_terms, gamma, idl = _opt_terms(ord_)
    ev, od = _high_symforms(ord_)
    sup = substencils(ord_)
    K, h = len(sup), ord_ // 2
    out: list[float] = []
    if ord_ != 5:
        for k, (s, w) in enumerate(sup[:-1]):
            if len(tv_factors[k]) != w - 1:
                raise AssertionError(f"ord {ord_} candidate {k}: "
                                     f"{len(tv_factors[k])} forms")
            for m, form in enumerate(tv_factors[k]):
                c = dict(form)
                if any(not (s <= i < s + w) for i in c):
                    raise AssertionError("TV form outside its support")
                if any((s + q not in c) != opt_dropped(ord_, k, m, q)
                       for q in range(w)):
                    raise AssertionError(f"ord {ord_} candidate {k} form "
                                         f"{m}: unexpected dropped taps")
                out += [c.get(s + q, 0.0) for q in range(w)]
    if len(ev) != h or len(od) != h:
        raise AssertionError(f"ord {ord_}: {len(ev)} even, {len(od)} odd "
                             f"high-order forms, expected {h} each")
    for coefs in ev + od:
        out += list(coefs)
    if (gamma is None) != (ord_ not in (3, 5)):
        raise AssertionError(f"ord {ord_}: gamma {gamma}")
    if gamma is not None:
        out += [float(v) for v in gamma.reshape(-1)]
    for k, per_edge in enumerate(edge_terms):
        s, w = sup[k]
        for terms in per_edge:
            if [i for i, _ in terms] != list(range(s, s + w)):
                raise AssertionError("edge form without its full support")
            out += [c for _, c in terms]
    out += list(idl)
    if len(idl) != K:
        raise AssertionError(f"ord {ord_}: {len(idl)} ideal weights")
    return np.asarray(out, np.float64)


def _recip(v: torch.Tensor) -> torch.Tensor:
    """1 / v as an IEEE division (``exact_div``)."""
    return exact_div(1.0, v)


def reconstruct_edges_opt(padded: torch.Tensor, axis: int, n_out: int,
                          ord_: int):
    """WENO-limited left/right edge values in the reduced-operation algebra
    (``_weno_edges_block_opt`` of the JAX package, term for term: every
    linear form and sum starts from its first term; ord 5 takes the
    Jiang-Shu form; each weight is idl_k times the exact reciprocal of its
    denominator).  ``padded`` and the result as in
    ``reconstruct_edges_shifted``."""
    tv_factors, edge_terms, gamma, idl = _opt_terms(ord_)
    s = [padded.narrow(axis, i, n_out) for i in range(ord_)]

    def linform(terms):
        acc = None
        for i, c in terms:
            t = c * s[i]
            acc = t if acc is None else acc + t
        return acc

    def high_tv():
        ev, od = _high_symforms(ord_)
        h = ord_ // 2
        P = [s[i] + s[ord_ - 1 - i] for i in range(h)]
        M = [s[i] - s[ord_ - 1 - i] for i in range(h)]
        th = None
        for coefs in ev:
            f = coefs[-1] * s[h]
            for c, p in zip(coefs[:-1], P):
                f = f + c * p
            th = f * f if th is None else th + f * f
        for coefs in od:
            f = None
            for c, m in zip(coefs, M):
                t = c * m
                f = t if f is None else f + t
            th = th + f * f
        return th

    if ord_ == 5:
        # Jiang-Shu: 13/12 d^2 + 1/4 f^2 of each 3-tap candidate, on
        # shared first differences
        e0, e1, e2, e3 = s[0] - s[1], s[2] - s[1], s[2] - s[3], s[4] - s[3]
        d0, d1, d2 = e0 + e1, e1 + e2, e2 + e3
        m13 = e2 - e1
        f0 = d0 + 2.0 * e1
        f2 = d2 + 2.0 * e2
        c1312 = 13.0 / 12.0
        tvs = [c1312 * (d0 * d0) + 0.25 * (f0 * f0),
               c1312 * (d1 * d1) + 0.25 * (m13 * m13),
               c1312 * (d2 * d2) + 0.25 * (f2 * f2),
               high_tv()]
    else:
        tvs = []
        for forms in tv_factors[:-1]:
            acc = None
            for terms in forms:
                f = linform(terms)
                acc = f * f if acc is None else acc + f * f
            tvs.append(acc)
        tvs.append(high_tv())

    T = tvs[0]
    for tv in tvs[1:]:
        T = T + tv
    tiny = 1e-300 if padded.dtype == torch.float64 else 1e-35
    e2 = 1e-20 * (T * T) + tiny
    ws = [ik * _recip(tv * tv + e2) for ik, tv in zip(idl, tvs)]
    tot = ws[0]
    for w in ws[1:]:
        tot = tot + w
    inv = _recip(tot)

    edges = []
    for e in range(2):
        acc = None
        for k, terms in enumerate(edge_terms):
            if gamma is not None:
                c = (ws[k] + float(gamma[e, k]) * ws[-1]) * inv
            else:
                c = ws[k] * inv
            t = c * linform(terms[e])
            acc = t if acc is None else acc + t
        edges.append(acc)
    return edges[0], edges[1]
