"""The port's numerics against the JAX package: WENO reconstruction, the
CUDA kernel's coefficient table, BC padding, and one direction of fluxes
(plain version on the CPU), all in float64.

Tolerance of a direction's state divergence: it is a difference of face
fluxes whose pressure part is 1e2-1e4 times larger than the result, and
XLA's pow() and libm's differ in the last bit (1.6e-15 of the face mass
flux), so the divergence agrees to ~3e-13 of its scale: rtol 1e-12 plus
an atol of 1e-12 of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.ops.stencil import pad_bc as jax_pad_bc
from miniweatherml_tpu.ops.weno import weno_matrices as jax_weno_matrices
from miniweatherml_tpu.ops.weno_fused import \
    reconstruct_edges_shifted as jax_recon
from miniweatherml_tpu_torch.ops.direction_fluxes import direction_fluxes
from miniweatherml_tpu_torch.ops.stencil import pad_bc
from miniweatherml_tpu_torch.ops.weno import weno_matrices
from miniweatherml_tpu_torch.ops.weno_fused import (reconstruct_edges_shifted,
                                                    substencils,
                                                    weno_coef_table)
from tests.test_torch_dycore import _case

torch.set_num_threads(1)

DIRS = {"x": (-1, 1), "y": (-2, 2), "z": (-3, 3)}


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_reconstruct_edges_shifted_matches_jax(ord_):
    rng = np.random.default_rng(ord_)
    x = rng.standard_normal((3, 6, 40)) * np.linspace(1, 5, 40)
    n_out = 40 - (ord_ - 1)
    jl, jr = jax_recon(jnp.asarray(x), -1, n_out, jax_weno_matrices(ord_), 0.0)
    pl, pr = reconstruct_edges_shifted(torch.as_tensor(x), -1, n_out,
                                       weno_matrices(ord_), 0.0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-12)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-12)
    np.testing.assert_array_equal(weno_matrices(ord_).G,
                                  jax_weno_matrices(ord_).G)


def _table_edges(s, ord_, cutoff):
    """The CUDA kernel's limiter (weno_edges in csrc/direction_fluxes.cuh)
    transliterated to numpy: dense sums over each candidate's support,
    read from the flat coefficient table."""
    cf = weno_coef_table(ord_)
    sup = substencils(ord_)
    K = len(sup)
    o, tv = 0, []
    for st, w in sup:
        acc = 0.0
        for i in range(w):
            for j in range(i, w):
                acc = acc + cf[o] * s[st + i] * s[st + j]
                o += 1
        tv.append(acc)

    def convexify(v):
        tot = sum(v[1:], v[0])
        inv = np.where(tot > 1e-20, 1.0 / np.where(tot > 1e-20, tot, 1.0), 1.0)
        return [x * inv for x in v]

    tv = convexify(tv)
    w = convexify([cf[-K + k] / (tv[k] * tv[k] + 1e-20) for k in range(K)])
    if cutoff > 0:
        w = convexify([np.where(x > cutoff, x, 0.0) for x in w[:-1]] + [w[-1]])
    edges = []
    for e in range(2):
        acc, eo = 0.0, o
        for k, (st, wd) in enumerate(sup):
            ek = 0.0
            for i in range(wd):
                ek = ek + cf[eo + e * wd + i] * s[st + i]
            acc = acc + w[k] * ek
            eo += 2 * wd
        edges.append(acc)
    return edges


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_coef_table_reproduces_reconstruction(ord_):
    rng = np.random.default_rng(10 + ord_)
    n = 50
    x = rng.standard_normal(n + ord_ - 1) * np.linspace(1, 3, n + ord_ - 1)
    x[10:20] = 1.5  # a flat stretch: vanishing smoothness indicators
    s = np.stack([x[i:i + n] for i in range(ord_)])
    sup = substencils(ord_)
    ntv = sum(w * (w + 1) // 2 for _, w in sup)
    for cutoff in (0.0, 0.1):
        left, right = _table_edges(s, ord_, cutoff)
        pl, pr = reconstruct_edges_shifted(torch.as_tensor(x), 0, n,
                                           weno_matrices(ord_), cutoff)
        np.testing.assert_allclose(left, pl.numpy(), rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(right, pr.numpy(), rtol=1e-13, atol=1e-15)
    assert weno_coef_table(ord_).size == ntv + sum(2 * w for _, w in sup) + len(sup)


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_coef_table_fits_the_kernels_constant_memory(ord_):
    """csrc/direction_fluxes.cuh keeps each order's table in a __constant__
    row of COEF_MAX values and unrolls its tracer loop up to NTR_MAX, the
    wrapper's MAX_TRACERS."""
    import os
    import re

    from miniweatherml_tpu_torch.ops import direction_fluxes as DF
    src = open(os.path.join(os.path.dirname(DF.__file__), "..", "csrc",
                            "direction_fluxes.cuh")).read()
    coef_max = int(re.search(r"COEF_MAX = (\d+);", src).group(1))
    assert weno_coef_table(ord_).size <= coef_max
    assert int(re.search(r"NTR_MAX = (\d+);", src).group(1)) == \
        DF.MAX_TRACERS


@pytest.mark.parametrize("bc,zero_var", [(0, None), (1, None), (2, 1)])
def test_pad_bc_matches_jax(bc, zero_var):
    x = np.random.default_rng(bc).standard_normal((4, 3, 5, 7))
    for axis in (-1, -2):
        for halo in (2, 6):
            a = jax_pad_bc(jnp.asarray(x), axis, halo, bc, zero_var=zero_var)
            b = pad_bc(torch.as_tensor(x), axis, halo, bc, zero_var=zero_var)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def advanced_supercell():
    """JAX's de-densitized supercell state after one dycore step, with the
    dycore, its constants and background profiles."""
    js, jd, _, _ = _case("supercell", 16, 8, 10)
    dt = jd.compute_time_step(js)
    js = jax.jit(lambda s: jd.time_step(s, dt))(js)
    s, tr = jd.convert_coupler_to_dynamics(js)
    hy = jd._hy(js)
    full_r = s[0] + hy[0][:, :, None, None]
    prim = jnp.concatenate([s[0:1], s[1:4] / full_r, s[4:5], tr / full_r])
    return jd, js.grid, jd._consts(js), hy, prim


@pytest.mark.parametrize("direction", ["x", "y", "z"])
@pytest.mark.parametrize("bc", [0, 1, 2], ids=["periodic", "open", "wall"])
def test_direction_fluxes_matches_jax(direction, bc, advanced_supercell):
    """Plain direction_fluxes against JAX's Dycore._direction_fluxes (XLA)
    followed by div, on the de-densitized supercell state after one step."""
    jd, g, consts, hy, prim = advanced_supercell
    axis, nid = DIRS[direction]
    n, d = {-1: (g.nx, g.dx), -2: (g.ny, g.dy), -3: (g.nz, g.dz)}[axis]
    SF, TF = jd._direction_fluxes(g, consts, hy, prim, axis, n, bc, nid)
    ax = SF.ndim + axis
    jdiv = -(jax.lax.slice_in_dim(SF, 1, n + 1, axis=ax)
             - jax.lax.slice_in_dim(SF, 0, n, axis=ax)) / d
    hr, ht = (hy[2], hy[3]) if axis == -3 else (hy[0], hy[1])
    t = lambda a: torch.as_tensor(np.array(a))
    sdiv, tf = direction_fluxes(t(prim), axis, n, bc, nid, consts.C0,
                                consts.gamma, t(hr), t(ht), weno_matrices(5),
                                0.0, 1.0 / d)
    assert tuple(sdiv.shape) == (5,) + g.field_shape
    assert tuple(tf.shape) == tuple(TF.shape)
    for v in range(5):
        a = np.asarray(jdiv[v])
        np.testing.assert_allclose(sdiv[v].numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=f"state var {v}")
    a = np.asarray(TF)
    np.testing.assert_allclose(tf.numpy(), a, rtol=1e-12,
                               atol=1e-12 * np.abs(a).max())


def test_direction_fluxes_rejects_unsupported_device():
    prim = torch.zeros((8, 1, 4, 4, 4), device="meta")
    hy = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        direction_fluxes(prim, -1, 4, 0, 1, 1.0, 1.4, hy, hy,
                         weno_matrices(5), 0.0, 1.0)
