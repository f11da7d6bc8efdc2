"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerance: max|kernel - plain| over max|plain| of each output, 1e-12 in
f64 and 1e-5 in f32 (an index set of the P3 rates by its lookup positions,
index plus fraction); the flux kernel, fct_mult, the Kessler step and its
sub-cycle step, the P3 lookups, the P3 output pass, the surrogate's
forward and the dycore's state transforms equal their plain versions bit
for bit.
"""

import numpy as np
import pytest
import torch

from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments.supercell_example import build
from miniweatherml_tpu_torch.ops import dycore_state as ds
from miniweatherml_tpu_torch.ops.direction_fluxes import (
    direction_fluxes, direction_fluxes_plain)
from miniweatherml_tpu_torch.ops.weno import weno_matrices
from miniweatherml_tpu_torch.physics.kessler import kessler_rainsplit
from miniweatherml_tpu_torch.physics.kessler_cuda import (
    kessler_staging, kessler_step, kessler_step_plain, min_step,
    min_step_plain)
from miniweatherml_tpu_torch.utils.profiling import counter

import chip_smoke as cs

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DIRS = ((-1, 1), (-2, 2), (-3, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return "cuda"


def _rel(a, b):
    return (a - b).abs().max().item() / max(a.abs().max().item(), 1e-300)


def _prim(shape, dtype, device, rng, nvar=8):
    p = np.empty((nvar,) + shape)
    p[0] = 0.01 * rng.standard_normal(shape)
    p[1:4] = 10 * rng.standard_normal((3,) + shape)
    p[4] = 0.5 * rng.standard_normal(shape)
    p[5:] = rng.uniform(0, 0.01, (nvar - 5,) + shape)
    return torch.as_tensor(p, dtype=dtype, device=device)


# (nens, nz, ny, nx): ragged tiles; a 2-D slab (ny = 1); and a box whose
# axes are no multiple of the y/z kernel's 16-line tiles and 16-cell steps
# or of the x kernel's 30-cell rows
FLUX_SHAPES = ((2, 7, 5, 70), (1, 100, 2, 18), (2, 12, 1, 40), (2, 67, 35, 70))


@pytest.mark.parametrize("nvar", [5, 6, 8, 14])
@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_direction_fluxes_kernel_matches_plain(ord_, nvar, cuda_device):
    """Every direction and BC, both types, equal to the plain version bit
    for bit (and so within the 1e-5 / 1e-12 bound)."""
    rng = np.random.default_rng(ord_ * 100 + nvar)
    for dtype in (torch.float64, torch.float32):
        for shape in FLUX_SHAPES:
            prim = _prim(shape, dtype, cuda_device, rng, nvar)
            for axis, nid in DIRS:
                nl = shape[1] + (1 if axis == -3 else 0)
                hr = torch.as_tensor(1 + 0.1 * rng.random((shape[0], nl)),
                                     dtype=dtype, device=cuda_device)
                ht = 300 * hr
                for bc in (0, 1, 2):
                    args = (prim, axis, prim.shape[axis], bc, nid, 27.56,
                            1.4008, hr, ht, weno_matrices(ord_), 0.0, 2e-3)
                    n0 = counter("direction_fluxes.launches")
                    got = direction_fluxes(*args)
                    assert counter("direction_fluxes.launches") == n0 + 1
                    for a, b in zip(direction_fluxes_plain(*args), got):
                        where = (dtype, shape, axis, bc)
                        assert a.shape == b.shape, where
                        assert torch.equal(a, b), where
                        if a.numel():
                            assert _rel(a, b) <= TOL[dtype], where


def test_direction_fluxes_rejects_bad_input(cuda_device):
    prim = torch.zeros((8, 1, 4, 6, 8), device=cuda_device)
    hy = torch.ones((1, 4), device=cuda_device)
    args = (-1, 8, 0, 1, 27.56, 1.4008)
    with pytest.raises(ValueError, match="contiguous"):
        direction_fluxes(prim.transpose(3, 4), -1, 6, 0, 1, 27.56, 1.4008,
                         hy, hy, weno_matrices(5), 0.0, 1.0)
    with pytest.raises(TypeError):
        direction_fluxes(prim.half(), *args, hy.half(), hy.half(),
                         weno_matrices(5), 0.0, 1.0)
    with pytest.raises(ValueError, match="hy_r"):
        direction_fluxes(prim, -3, 4, 2, 3, 27.56, 1.4008, hy, hy,
                         weno_matrices(5), 0.0, 1.0)
    # above 9 tracers the wrapper launches once per group of at most 9
    many = _prim((1, 4, 6, 8), torch.float64, cuda_device,
                 np.random.default_rng(1), nvar=15)
    args = (many, -1, 8, 0, 1, 27.56, 1.4008, hy.double(), 300 * hy.double(),
            weno_matrices(5), 0.0, 1.0)
    n0 = counter("direction_fluxes.launches")
    got = direction_fluxes(*args)
    assert counter("direction_fluxes.launches") == n0 + 2
    for a, b in zip(direction_fluxes_plain(*args), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nvar", [5, 6, 8, 14])
@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_direction_fluxes_opt_kernels_match_plain(ord_, nvar, cuda_device):
    """The reduced-operation algebra (``opt``): every direction and BC, both
    types, equal to the plain version bit for bit; with ``fast_weights``
    (the approximate reciprocal, f32) within 1e-5 of each output's scale of
    the plain version, which is exact; each launch counted as its form."""
    rng = np.random.default_rng(ord_ * 100 + nvar + 7)
    for dtype in (torch.float64, torch.float32):
        for shape in FLUX_SHAPES[:2] + FLUX_SHAPES[3:]:
            prim = _prim(shape, dtype, cuda_device, rng, nvar)
            for axis, nid in DIRS:
                nl = shape[1] + (1 if axis == -3 else 0)
                hr = torch.as_tensor(1 + 0.1 * rng.random((shape[0], nl)),
                                     dtype=dtype, device=cuda_device)
                ht = 300 * hr
                for bc in (0, 1, 2):
                    args = (prim, axis, prim.shape[axis], bc, nid, 27.56,
                            1.4008, hr, ht, weno_matrices(ord_), 0.0, 2e-3)
                    want = direction_fluxes_plain(*args, opt=True)
                    n0 = counter("direction_fluxes.opt_launches")
                    got = direction_fluxes(*args, opt=True)
                    assert counter("direction_fluxes.opt_launches") == n0 + 1
                    for a, b in zip(want, got):
                        where = (dtype, shape, axis, bc)
                        assert torch.equal(a, b), where
                    n0 = counter("direction_fluxes.fast_launches")
                    fast = direction_fluxes(*args, opt=True,
                                            fast_weights=True)
                    if dtype == torch.float64:  # f64 runs exact
                        assert counter("direction_fluxes.fast_launches") == n0
                        assert all(torch.equal(a, b)
                                   for a, b in zip(want, fast))
                        continue
                    assert counter("direction_fluxes.fast_launches") == n0 + 1
                    for a, b in zip(want, fast):
                        if a.numel():
                            assert _rel(a, b) <= TOL[dtype], where


@pytest.mark.parametrize("case", ["no_opt", "cutoff"])
def test_direction_fluxes_reference_fast_weights_raise(case, cuda_device):
    """The reference algebra with approximate reciprocals (fast_weights in
    f32 with opt off, or with a cutoff, which takes the reference algebra
    even with opt on) runs its kernel (csrc/direction_fluxes_ref_fast.cu)
    on every direction, each launch counted in its form, meets
    chip_smoke.py's fast bar against the exact plain version (its model
    runs of the plain version's reciprocals) and equals the plain version
    run on the card's approximate reciprocal bit for bit; a reciprocal
    2^-12 off fails the bar.  f64 runs the exact reference kernel."""
    import chip_smoke as cs

    rng = np.random.default_rng(2)
    cutoff, opt = (0.2, True) if case == "cutoff" else (0.0, False)
    for shape in FLUX_SHAPES[:2] + FLUX_SHAPES[3:]:
        prim = _prim(shape, torch.float32, cuda_device, rng)
        for axis, nid in DIRS:
            nl = shape[1] + (1 if axis == -3 else 0)
            hr = torch.as_tensor(1 + 0.1 * rng.random((shape[0], nl)),
                                 dtype=torch.float32, device=cuda_device)
            args = (prim, axis, prim.shape[axis], 0, nid, 27.56, 1.4008, hr,
                    300 * hr, weno_matrices(5), cutoff, 2e-3)
            kw = dict(opt=opt, fast_weights=True)

            def plain():
                return direction_fluxes_plain(*args, **kw)
            ref = plain()
            n0 = (counter("direction_fluxes.launches"),
                  counter("direction_fluxes.ref_fast_launches"))
            got = direction_fluxes(*args, **kw)
            assert (counter("direction_fluxes.launches"),
                    counter("direction_fluxes.ref_fast_launches")) == (n0[0] + 1,
                                                            n0[1] + 1)
            model = cs._one_ulp_model(plain, ref)
            ok, per = cs._fast_verdict(ref, got, model)
            assert ok, (shape, axis, cs._verdict_text(per, model))
            twin = cs._with_recip(cs._card_recip, plain)
            assert all(torch.equal(a, b) for a, b in zip(twin, got))
            off = cs._with_recip(*cs._fault_models()[
                "reciprocals 2^-12 off"][:1], plain)
            assert not cs._fast_verdict(ref, off, model)[0], (shape, axis)
    # f64 runs exact: the reference kernel, bit for bit; so does f32
    # without fast_weights, opt asked for or not
    for dtype, fast in ((torch.float64, True), (torch.float32, False)):
        prim = _prim(FLUX_SHAPES[0], dtype, cuda_device, rng)
        hy = torch.ones((2, 7), dtype=dtype, device=cuda_device)
        args = (prim, -1, 70, 0, 1, 27.56, 1.4008, hy, 300 * hy,
                weno_matrices(5), cutoff, 1.0)
        n0 = (counter("direction_fluxes.ref_fast_launches"),
              counter("direction_fluxes.opt_launches"))
        got = direction_fluxes(*args, opt=opt, fast_weights=fast)
        assert (counter("direction_fluxes.ref_fast_launches"),
                counter("direction_fluxes.opt_launches")) == n0
        assert all(torch.equal(a, b) for a, b in zip(
            direction_fluxes_plain(*args), got))


def _coupler_columns(shape, dtype, device, seed=3):
    """Moist columns as the coupler holds them (rho_d, temp, rho_v, rho_c,
    rho_r), spanning 8 km over shape[1] levels, and the level heights: heavy
    rain in two columns of three, none in the third, and cloud below 5 km
    with some -0.0 above it (the kernel's zero shortcuts must keep signs)."""
    rng = np.random.default_rng(seed)
    nz = shape[1]
    dz = 8000.0 / nz
    z = ((np.arange(nz) + 0.5) * dz)[None, :, None, None]
    rho = 1.2 * np.exp(-z / 8000.0) * np.ones(shape)
    temp = 300.0 - 0.0065 * z + rng.uniform(0, 1, shape)
    qv = 0.016 * np.exp(-z / 3000.0) * (0.9 + 0.2 * rng.random(shape))
    qc = np.where(z < 5000.0, 1e-4, 0.0) * rng.random(shape)
    qc[(rng.random(shape) < 0.2) & (qc == 0.0)] = -0.0
    wet = np.arange(shape[3]) % 3 != 2
    qr = (np.where(z < 3000.0, 5e-4, 0.0) + 5e-3 * rng.random(shape)) * wet
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return [t(a) for a in (rho, temp, qv * rho, qc * rho, qr * rho)], t(z), dz


@pytest.mark.parametrize("several", [False, True])
@pytest.mark.parametrize("nz", [2, 64, 100, 101])
def test_kessler_kernel_matches_plain(nz, several, cuda_device):
    """The fused step against kessler_step_plain, nens 2 and 3x37 columns
    (no multiple of the block's 32), f64 and f32, bit for bit.  nz: the
    fewest levels, the chain's 64 and 100, and one above the most staged
    whole in f32 (101 = 100 + 1; in f64 64 = 50 + 14 and 101 = 50 + 50 +
    1); dt 2 s gives one sub-cycle, 0.3 s per metre of dz several."""
    for dtype in (torch.float64, torch.float32):
        fields, z, dz = _coupler_columns((2, nz, 3, 37), dtype, cuda_device)
        dt = 0.3 * dz if several else 2.0
        rs = kessler_rainsplit(fields[4] / fields[0], fields[0], z, dt)
        assert (int(rs) > 1) == several, int(rs)
        args = (*fields, rs, dt, dz, 287.0, 461.0, 1003.0, 1e5)
        n0 = counter("kessler_step.launches")
        got = kessler_step(*args)
        assert counter("kessler_step.launches") == n0 + 1
        for i, (a, b) in enumerate(zip(kessler_step_plain(*args), got)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert _rel(a, b) <= TOL[dtype], (dtype, i)
            assert torch.equal(a, b), (dtype, i)


# (nens, nz, ny, nx), dry, misaligned: planes that are odd or a multiple
# of 8, within one 2048-column tile or over two, nz 2 (one level below the
# top), and fields one value past a 16-byte boundary
MIN_STEP_CASES = (((2, 64, 3, 37), False, False), ((2, 101, 3, 37), False, False),
                  ((1, 16, 3, 37), True, False), ((2, 64, 16, 40), False, False),
                  ((1, 12, 48, 50), False, False), ((2, 2, 5, 7), False, False),
                  ((2, 2, 8, 8), False, False), ((2, 64, 16, 40), False, True),
                  ((1, 16, 16, 40), True, False))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kessler_min_step_kernel_equals_plain(dtype, cuda_device):
    """The sub-cycle step against its plain version, bit for bit, and the
    count made of it: heavy-rain columns (counts above 1 at dt 0.3 s per
    metre of dz) and dry states (count 1) on MIN_STEP_CASES; the wrapper
    counts one launch a call and never reaches the plain version."""
    import miniweatherml_tpu_torch.physics.kessler_cuda as KC

    for shape, dry, misaligned in MIN_STEP_CASES:
        fields, _, dz = _coupler_columns(shape, dtype, cuda_device)
        rho_r = torch.zeros_like(fields[4]) if dry else fields[4]
        rho_d = fields[0]
        if misaligned:
            rho_r, rho_d = (torch.cat([a.new_zeros(1), a.reshape(-1)])[1:]
                            .view(shape) for a in (rho_r, rho_d))
            assert rho_r.data_ptr() % 16 != 0
        dt = 0.3 * dz
        n0 = counter("min_step.launches")
        real, KC.min_step_plain = KC.min_step_plain, None
        try:
            got = min_step(rho_r, rho_d, dt, dz)
        finally:
            KC.min_step_plain = real
        assert counter("min_step.launches") == n0 + 1
        want = min_step_plain(rho_r, rho_d, dt, dz)
        assert got.shape == () and got.dtype == dtype
        assert torch.equal(got, want), (shape, float(got), float(want))
        count = int(torch.ceil(dt / got))
        assert (count == 1) if dry else (count > 1), (shape, count)


def test_kessler_min_step_rejects_bad_input(cuda_device):
    x = torch.ones((1, 4, 3, 5), device=cuda_device)
    with pytest.raises(TypeError):
        min_step(x.half(), x.half(), 1.0, 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        min_step(x.transpose(2, 3), x, 1.0, 10.0)
    with pytest.raises(ValueError, match="nz>=2"):
        min_step(x[:, :1], x[:, :1], 1.0, 10.0)


def test_kessler_staging(cuda_device):
    """Columns up to 100 levels in f32 and 50 in f64 are staged whole, at
    most two blocks' worth of shared memory per SM."""
    for nz, dtype, kc in ((64, torch.float32, 64), (100, torch.float32, 100),
                          (101, torch.float32, 100), (50, torch.float64, 50),
                          (64, torch.float64, 50)):
        staged, smem = kessler_staging(nz, dtype)
        assert staged == kc, (nz, dtype)
        assert 2 * (smem + 1024) <= 228 * 1024


def test_kessler_rejects_bad_input(cuda_device):
    fields, z, dz = _coupler_columns((1, 8, 2, 4), torch.float32,
                                     cuda_device)
    rs = torch.ones((), dtype=torch.int32, device=cuda_device)
    tail = (1.0, dz, 287.0, 461.0, 1003.0, 1e5)
    with pytest.raises(ValueError, match="contiguous"):
        kessler_step(fields[0], fields[1].transpose(2, 3).contiguous()
                     .transpose(2, 3), *fields[2:], rs, *tail)
    with pytest.raises(TypeError, match="temp"):
        kessler_step(fields[0], fields[1].double(), *fields[2:], rs, *tail)
    with pytest.raises(ValueError, match="rho_v"):
        kessler_step(*fields[:2], fields[2].cpu(), *fields[3:], rs, *tail)
    with pytest.raises(TypeError):
        kessler_step(*(f.half() for f in fields), rs, *tail)
    with pytest.raises(ValueError, match="nz>=2"):
        kessler_step(*(f[:, :1].contiguous() for f in fields), rs, *tail)
    with pytest.raises(ValueError, match="rainsplit"):
        kessler_step(*fields, rs.long(), *tail)


def test_slice_on_card_matches_cpu(cuda_device):
    """The main path through both kernels against the port's CPU run (plain
    versions): 16x8x10 supercell, f64, 3 steps; rtol 1e-9 plus 1e-7 of each
    field's scale (WENO weight switching amplifies last-bit differences,
    see tests/test_torch_dycore.py)."""
    cfg = config_from_dict(dict(
        sim_time=100.0, nx_glob=16, ny_glob=8, nz=10, xlen=40000.0,
        ylen=40000.0, zlen=10000.0, init_data="supercell", dtype="float64"))
    states = []
    for device in ("cpu", cuda_device):
        state, mods, dycore = build(cfg, device)
        dt = dycore.compute_time_step(state)
        n0 = (counter("direction_fluxes.launches"), counter("kessler_step.launches"))
        for _ in range(3):
            for m in mods:
                state = m(state, dt)
        states.append(state)
    assert counter("direction_fluxes.launches") - n0[0] == 3 * 3 * 3
    assert counter("kessler_step.launches") - n0[1] == 3
    for name, a in states[0].fields.items():
        a = a.numpy()
        b = states[1][name].cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-9,
                                   atol=1e-7 * np.abs(a).max(), err_msg=name)


# -- P3: table lookups and the per-cell phases -------------------------------

def _lookup_inputs(n, dtype, device, seed):
    """Index sets from the index finders on physical inputs that span past
    the tables (so the clip ranges are hit)."""
    from miniweatherml_tpu_torch.physics import p3_tables as PT
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    qi = 10.0 ** rng.uniform(-15, -1, n)
    idx = PT.ice_table_indices(t(qi), t(10.0 ** rng.uniform(-3, 10, n)),
                               t(qi * rng.uniform(0, 1.2, n)),
                               t(rng.uniform(0, 1000, n)))
    jr = PT.rain_collection_index(t(10.0 ** rng.uniform(-15, -1, n)),
                                  t(10.0 ** rng.uniform(-3, 8, n)))
    rs = PT.rain_size_index(t(10.0 ** rng.uniform(-7, -1, n)))
    return idx, jr, rs


@pytest.mark.parametrize("n", [1, 255, 4097])
def test_p3_lookup_kernels_match_plain(n, cuda_device):
    """Ice, collection and rain lookups equal their plain versions bit for
    bit, f32 and f64, with the presence gate None / True / False."""
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    tables = load_p3_tables()
    for dtype in (torch.float64, torch.float32):
        dev = tables.to(cuda_device, dtype)
        idx, jr, rs = _lookup_inputs(n, dtype, cuda_device, n)
        calls = {
            "ice": (LK.interp_ice, LK.interp_ice_plain,
                    (dev.ice_cols((7, 8, 4, 2, 3, 5, 10)), *idx)),
            "collect": (LK.interp_collect, LK.interp_collect_plain,
                        (dev.collect_cols((2, 1)), *idx, *jr)),
            "rain": (LK.interp_rain, LK.interp_rain_plain,
                     (dev.rain_rows(("vm", "vn", "revap")), *rs))}
        for kind, (kern, plain, args) in calls.items():
            for present in (None, True, False):
                p = (None if present is None
                     else torch.tensor(present, device=cuda_device))
                launches = f"{kern.__name__}.launches"
                n0 = counter(launches)
                got = kern(*args, present=p)
                assert counter(launches) == n0 + 1
                want = plain(*args, present=p)
                assert got.shape == want.shape and got.dtype == dtype
                assert torch.equal(got, want), (kind, dtype, present)
                if present is False:
                    assert not got.any(), kind


def _edge_inputs(n, dtype, device, seed):
    """Ice and collection index sets whose indices sit at each axis's two
    clip edges (0 and size - 2) or between them, fractions in [0, 1]."""
    rng = np.random.default_rng(seed)

    def index(size):
        a = rng.integers(0, size - 1, n)
        pick = rng.integers(0, 3, n)
        a = np.where(pick == 0, 0, np.where(pick == 1, size - 2, a))
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    def frac():
        return torch.as_tensor(rng.random(n), dtype=dtype, device=device)
    return ((index(50), frac(), index(4), frac(), index(5), frac()),
            (index(30), frac()))


@pytest.mark.parametrize("K", [1, 2, 3, 4, 7, 8])
def test_p3_lookup_packed_layout_on_card(K, cuda_device):
    """The ice and collection kernels at K columns (K pads to a power of
    two, at most 16 bytes; collection columns repeat past the table's 2),
    at 1, 255 and 4097 cells and one past each persistent grid's stride,
    with indices at both clip edges, bit for bit."""
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    tables = load_p3_tables()
    for dtype in (torch.float64, torch.float32):
        dev = tables.to(cuda_device, dtype)
        ice = dev.ice_cols(tuple(1 + (3 * c) % 12 for c in range(K)))
        coll = dev.collect_cols(tuple(1 + c % 2 for c in range(K)))
        grids = {kind: LK.launch_config(kind, K, dtype, 1 << 36)
                 for kind in ("ice", "collect")}
        # the whole packed ice table
        assert grids["ice"][2] == ice.untyped_storage().nbytes()
        # the collection table is read from L1/L2
        assert grids["collect"][2] == 0
        ns = {1, 255, 4097} | {b * t + 1 for b, t, _ in grids.values()}
        for n in sorted(ns):
            for kind, (blocks, threads, _) in grids.items():
                got = LK.launch_config(kind, K, dtype, n)[0]
                assert got == min(blocks, -(-n // threads))
            idx, jr = _edge_inputs(n, dtype, cuda_device, K * n)
            for present in (None, True, False):
                p = (None if present is None
                     else torch.tensor(present, device=cuda_device))
                for kern, plain, args in (
                        (LK.interp_ice, LK.interp_ice_plain, (ice, *idx)),
                        (LK.interp_collect, LK.interp_collect_plain,
                         (coll, *idx, *jr))):
                    got = kern(*args, present=p)
                    want = plain(*args, present=p)
                    assert torch.equal(got, want), (kern.__name__, dtype, n,
                                                    present)


def test_p3_lookup_column_sets_and_dtypes(cuda_device):
    """A second column set of one DeviceTables, and the same sets in the
    other dtype, are packed apart (the cache keys by columns and dtype) and
    each gives its plain version bit for bit; an ice table too large for a
    block's shared memory is refused."""
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    tables = load_p3_tables()
    seen = {}
    for dtype in (torch.float32, torch.float64):
        dev = tables.to(cuda_device, dtype)
        idx, jr = _edge_inputs(3001, dtype, cuda_device, 7)
        for cols in ((7, 8, 4, 2, 3, 5, 10), (2, 1, 7, 8), (9, 11, 12)):
            ice = dev.ice_cols(cols)
            assert dev.ice_cols(cols) is ice
            assert ice.stride() == LK.ice_strides(len(cols), dtype)
            seen[dtype, cols] = ice.data_ptr()
            assert torch.equal(LK.interp_ice(ice, *idx),
                               LK.interp_ice_plain(ice, *idx))
        for cols in ((2, 1), (1,)):
            coll = dev.collect_cols(cols)
            seen[dtype, cols] = coll.data_ptr()
            assert torch.equal(LK.interp_collect(coll, *idx, *jr),
                               LK.interp_collect_plain(coll, *idx, *jr))
    assert len(set(seen.values())) == len(seen)
    # 29 f64 columns: 20 blocks of 50 * 30 + 2 values, 240 KB > 227 KB
    big = tables.to(cuda_device, torch.float64).ice_cols(
        tuple(1 + c % 12 for c in range(29)))
    idx, _ = _edge_inputs(64, torch.float64, cuda_device, 8)
    with pytest.raises(RuntimeError, match="launch failed"):
        LK.interp_ice(big, *idx)


def test_p3_lookup_rejects_bad_input(cuda_device):
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    dev = load_p3_tables().to(cuda_device, torch.float32)
    idx, _, rs = _lookup_inputs(64, torch.float32, cuda_device, 1)
    table = dev.ice_cols((2,))
    with pytest.raises(TypeError, match="int32"):
        LK.interp_ice(table, idx[0].long(), *idx[1:])
    with pytest.raises(ValueError, match="contiguous"):
        LK.interp_ice(table, idx[0], idx[1].reshape(8, 8).t(), *idx[2:])
    with pytest.raises(ValueError, match="table"):
        LK.interp_ice(table.double(), *idx)
    with pytest.raises(ValueError, match="packed"):
        LK.interp_ice(table.contiguous(), *idx)
    with pytest.raises(ValueError, match="present"):
        LK.interp_rain(dev.rain_rows(("vm",)), *rs,
                       present=torch.tensor(1.0, device=cuda_device))


def _p3_state(dtype, device, nx=20, ny=3, nz=16):
    """A small supercell_p3 state with the mixed-regime seeds."""
    from miniweatherml_tpu_torch.experiments import supercell_p3
    cfg = config_from_dict(dict(
        sim_time=10.0, nx_glob=nx, ny_glob=ny, nz=nz, xlen=40000.0,
        ylen=40000.0, zlen=16000.0, init_data="supercell", dtype=dtype))
    state, mods, dycore = supercell_p3.build(cfg, device)
    return supercell_p3.seed_mixed_regimes(state), mods


def _close_to_plain(got, want, where):
    """rates_pre's index sets by their lookup positions (index + fraction,
    continuous where an index steps), every other output by its scale."""
    pairs = list(zip(got, want))
    if len(got) == 13:  # rates_pre: (qm, bm, 5 x (index, fraction), flags)
        assert torch.equal(got[12], want[12]), where
        pairs = pairs[:2] + [
            (got[i].double() + got[i + 1].double(),
             want[i].double() + want[i + 1].double()) for i in (2, 4, 6, 8,
                                                                10)]
    for i, (g, w) in enumerate(pairs):
        assert g.dtype == w.dtype and g.shape == w.shape, (where, i)
        scale = max(w.abs().max().item(), 1e-300)
        tol = TOL[got[0].dtype]
        assert (g - w).abs().max().item() / scale <= tol, (where, i)


def test_p3_cellwise_kernels_match_plain(cuda_device, monkeypatch):
    """Each phase's kernel against its plain version on the inputs one P3
    step hands it (20x3x16 = 960 cells: not a multiple of the block); the
    rates phases' index sets by their lookup positions."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    launch = CW._launch
    wrappers = ("p3_part1", "p3_update", "p3_wrapper", "p3_rates_pre",
                "p3_rates_post", "p3_part3", "p3_wrapper_out")
    for dtype in ("float64", "float32"):
        state, mods = _p3_state(dtype, cuda_device)
        dtab = mods[1].__self__.tables.to(cuda_device, state.meta.tdtype)
        seen = {}

        def spy(phase, predict_nc, arrays, dt=0.0, table=None):
            got = launch(phase, predict_nc, arrays, dt, table)
            seen[phase] = (got, CW.plain_phase(phase, predict_nc, arrays,
                                               dt, dtab))
            return got
        monkeypatch.setattr(CW, "_launch", spy)
        n0 = [counter(f"{w}.launches") for w in wrappers]
        mods[1](state, 2.0)
        monkeypatch.undo()
        assert [counter(f"{w}.launches") for w in wrappers] == [
            k + 1 for k in n0]
        assert set(seen) == {"part1", "update", "wrapper", "rates_pre",
                             "rates_post", "part3", "wrapper_out"}
        for name, (got, want) in seen.items():
            assert len(got) == len(want)
            _close_to_plain(got, want, (name, dtype))
        assert seen["rates_pre"][0][2].dtype == torch.int32


@pytest.mark.parametrize("layout", ["aligned", "offset 1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,at", cs.RATES_PRE_FLAG_CASES)
def test_p3_rates_pre_flags_match_plain(kind, at, dtype, layout, cuda_device):
    """rates_pre's kernel against its plain version on 963 cells (not a
    multiple of the block or of a thread's 16-byte word) in which no cell,
    or exactly one (the first, the middle or the last), holds ice, rain or
    both: the presence flags equal (the per-block reduction, the leftover
    cells of the vector path), the fields and lookup positions within the
    tolerance; "offset 1" hands the kernel views one element into their
    storage, contiguous but not 16-byte aligned (its one-cell path)."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    fields = cs._rates_pre_flag_fields(kind, at, dtype, cuda_device)
    if layout == "offset 1":
        views = []
        for f in fields:
            buf = torch.empty(f.numel() + 1, dtype=dtype, device=cuda_device)
            buf[1:] = f
            views.append(buf[1:])
        fields = views
        assert all(f.is_contiguous() and f.data_ptr() % 16 for f in fields)
    n0 = counter("p3_rates_pre.launches")
    got = CW.p3_rates_pre(*fields)
    want = CW.rates_pre_plain(*fields)
    assert counter("p3_rates_pre.launches") == n0 + 1
    assert got[-1].tolist() == ["ice" in kind, kind == "ice and rain",
                                "rain" in kind]
    _close_to_plain(got, want, (kind, at, dtype, layout))


def _offset_views(fields):
    """Each field as a contiguous view one element into its storage (not
    16-byte aligned)."""
    views = []
    for f in fields:
        buf = torch.empty(f.numel() + 1, dtype=f.dtype, device=f.device)
        buf[1:] = f
        views.append(buf[1:])
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    return views


@pytest.mark.parametrize("layout", ["aligned", "offset 1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,at", cs.RATES_POST_CASES)
def test_p3_rates_post_branches_match_plain(kind, at, dtype, layout,
                                            cuda_device):
    """rates_post's kernel against its plain version on 963 quiet cells (no
    gate holds), or with one cell of a cold mixed-phase regime (every
    gated group but rain evaporation) or of warm rain (rain evaporation)
    at the first, the middle or the last cell: a warp whose one cell
    passes a gate among 31 that fail it takes the branch for that cell
    alone; as made and one element into storage."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    fields = cs._rates_post_case(kind, at, dtype, cuda_device)
    if layout == "offset 1":
        fields = _offset_views(fields)
    gates = cs._rates_post_gates(fields)
    assert any(bool(g.any()) for g in gates.values()) == (at is not None)
    n0 = counter("p3_rates_post.launches")
    got = CW.p3_rates_post(2.0, *fields)
    want = CW.rates_post_plain(2.0, *fields)
    assert counter("p3_rates_post.launches") == n0 + 1
    _close_to_plain(got, want, (kind, at, dtype, layout))


def _newton_cells(dtype, device):
    """The wrapper's 13 inputs on 963 cells, made with numpy: the 8192-cell
    recipe of the CPU tests and as many cells within 1e-7 of saturation
    (where the Newton ends after one trip), placed by their trips
    (chip_smoke._newton_trips): warps of cells that skip the Newton, one
    that ends after one trip or that runs every trip among them at the
    first, a middle and the last cell, a warp of cells that run every trip
    and one of every kind."""
    from miniweatherml_tpu_torch.physics import p3 as P
    rng = np.random.default_rng(17)
    m = 8192
    rho_d = np.tile(0.3 + 1.0 * rng.random(m), 2)
    rho_v = 0.03 * rng.random(m)
    rho_c = np.where(rng.random(m) < 0.5, 0.01 * rng.random(m), 0.0)
    temp = np.tile(200.0 + 120.0 * rng.random(m), 2)
    svp = P.saturation_vapor_pressure(torch.as_tensor(temp[m:])).numpy()
    rho_v = np.concatenate([rho_v, svp / (P.R_V * temp[m:]) * (1 + 1e-7)])
    rho_c = np.concatenate([rho_c, np.full(m, 1e-3)])
    z = np.zeros(2 * m)
    pool = [rho_d, temp, rho_c, z, 1e-4 * rng.random(2 * m) * rho_d, z,
            1e-4 * rng.random(2 * m) * rho_d, z, z, z, rho_v, z, z]
    trips = cs._newton_trips([torch.as_tensor(a, dtype=dtype)
                              for a in pool]).numpy()
    full = 11 if dtype == torch.float64 else 8
    kinds = {t: np.flatnonzero(trips == t) for t in (0, 1, full)}
    assert all(len(v) >= 64 for v in kinds.values()), dtype
    n = 963
    pick = rng.choice(kinds[0], n)
    for t, at in ((1, 0), (1, 481), (1, 962), (full, 100), (full, 700)):
        pick[at] = rng.choice(kinds[t])
    pick[320:352] = rng.choice(kinds[full], 32)
    pick[384:416] = rng.choice(np.concatenate(list(kinds.values())), 32)
    first = rng.random(n) < 0.5  # the first step's t_prev = 0
    fields = [a[pick] for a in pool]
    for k, scale in ((3, 1e8), (5, 1e4), (7, 1e5), (8, 1e-5), (9, 1e-8)):
        fields[k] = scale * rng.random(n) * fields[0]
    fields[11] = np.where(first, 0.0, fields[10] / fields[0])
    fields[12] = np.where(first, 0.0, fields[1] - 0.3)
    return [torch.as_tensor(f).to(device=device, dtype=dtype)
            for f in fields]


@pytest.mark.parametrize("layout", ["aligned", "offset 1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_p3_wrapper_newton_cells_match_plain(dtype, layout, cuda_device):
    """The wrapper's kernel against its plain version on cells that skip
    the saturation Newton, end it after one trip or run every trip, alone
    or together in a warp (_newton_cells); as made and one element into
    storage."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    fields = _newton_cells(dtype, cuda_device)
    if layout == "offset 1":
        fields = _offset_views(fields)
    n0 = counter("p3_wrapper.launches")
    got = CW.p3_wrapper(*fields)
    want = CW.wrapper_plain(*fields)
    assert counter("p3_wrapper.launches") == n0 + 1
    _close_to_plain(got, want, (dtype, layout))


def _part3_calls(state, mods, monkeypatch):
    """The arguments one P3 step hands p3_part3 and p3_wrapper_out."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    seen = {}
    for name in ("p3_part3", "p3_wrapper_out"):
        real = getattr(CW, name)

        def call(*a, _real=real, _name=name):
            seen[_name] = a
            return _real(*a)
        monkeypatch.setattr(CW, name, call)
    mods[1](state, 2.0)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_p3_part3_and_output_pass_match_plain(dtype, tables, cuda_device,
                                              monkeypatch):
    """Freezing + part3 and the output pass against their plain versions on
    what one P3 step hands them (960 cells), both tiers; then part3 on that
    state with its ice taken away (and no cell below -40 C, so none
    freezes) and with ice in one cell only: the kernel's per-cell gate of
    the ice lookup against the plain version's gate on any cell having ice;
    part3 with and without its diagnostics; the output pass bit for bit."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    state, mods = _p3_state(dtype, cuda_device)
    if not tables:
        mods[1].__self__.tables = None
    seen = _part3_calls(state, mods, monkeypatch)
    args = list(seen["p3_part3"])
    assert (args[14] is None) == (not tables)
    n0 = (counter("p3_part3.launches"), counter("p3_wrapper_out.launches"))
    # no ice, and no cell below -40 C, so none freezes
    ice_free = list(args)
    for i in (4, 5, 6, 7):
        ice_free[i] = torch.zeros_like(args[i])
    ice_free[10] = torch.clamp(args[10], min=240.0)
    one_cell = list(ice_free)
    for i in (4, 5, 6, 7):
        one_cell[i] = one_cell[i].clone()
        one_cell[i].view(-1)[417] = args[i].flatten()[
            int(args[4].flatten().argmax())]
    assert float(args[4].max()) > 0.0
    for case, a in (("step", args), ("ice-free", ice_free),
                    ("one ice cell", one_cell)):
        got = CW.p3_part3(*a)
        want = CW.part3_plain(*a)
        assert len(got) == len(want) == 10
        _close_to_plain(got, want, (dtype, tables, case))
        if case != "step":
            assert int((got[4] > 0).sum()) == (case == "one ice cell")
        got_p, got_d = CW.p3_part3(*a, diagnostics=True)
        want_p, want_d = CW.part3_plain(*a, diagnostics=True)
        assert tuple(got_d) == tuple(want_d) == CW.DIAG_NAMES
        _close_to_plain((*got_p, *got_d.values()),
                        (*want_p, *want_d.values()),
                        (dtype, tables, case, "diagnostics"))
        for g, w in zip(got_p, got):
            assert torch.equal(g, w), (dtype, tables, case)
    got = CW.p3_wrapper_out(*seen["p3_wrapper_out"])
    want = CW.wrapper_out_plain(*seen["p3_wrapper_out"])
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (counter("p3_part3.launches"), counter("p3_wrapper_out.launches")) == (
        n0[0] + 6, n0[1] + 1)


def test_p3_cellwise_rejects_bad_input(cuda_device):
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW

    x = torch.ones((2, 3, 4, 5), device=cuda_device)
    args = [x] * 13
    with pytest.raises(ValueError, match="contiguous"):
        CW.p3_wrapper(*args[:-1], x.transpose(2, 3))
    with pytest.raises(TypeError):
        CW.p3_wrapper(*[x.half()] * 13)
    with pytest.raises(ValueError, match="45 fields"):
        CW.p3_update(1.0, *[x] * 44, do_predict_nc=False)
    with pytest.raises(ValueError, match="30 fields"):
        CW.p3_rates_post(1.0, *[x] * 29)
    with pytest.raises(ValueError, match="contiguous"):
        CW.p3_rates_pre(*[x] * 9, x.transpose(2, 3))
    with pytest.raises(TypeError, match="contiguous"):
        CW.p3_rates_post(1.0, *[x] * 29, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        CW.p3_wrapper_out(*[x] * 11, x.transpose(2, 3))
    with pytest.raises(TypeError, match="contiguous"):
        CW.p3_part3(*[x] * 13, x.double(), None)


def _p3_sed_calls(state, mods, monkeypatch):
    """The arguments one P3 step hands sed_step and sed_columns."""
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as SED

    seen = {}
    for name in ("sed_step", "sed_columns"):
        real = getattr(SED, name)

        def call(*a, _real=real, _name=name, **k):
            seen[_name] = (a, k)
            return _real(*a, **k)
        monkeypatch.setattr(SED, name, call)
    mods[1](state, 2.0)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_p3_sed_kernels_match_plain(dtype, tables, cuda_device, monkeypatch):
    """sed_step and sed_columns against their plain versions on what one P3
    step hands them (960 cells: not a multiple of the blocks), the table
    and the [approx] tier: the speed (also against the oracle
    _p3_sed_vmax), the one sub-step, and the rerun of sed_columns on
    sed_step's outputs at the step's one sub-step (kept) and at a dt that
    makes dt vmax / (0.9 dz_min) = 3.5 (4 sub-steps, overwritten), against
    sed_columns' plain version from the inputs, do_predict_nc both
    ways."""
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as SED

    state, mods = _p3_state(dtype, cuda_device)
    if not tables:
        mods[1].__self__.tables = None
    seen = _p3_sed_calls(state, mods, monkeypatch)
    sa, sk = seen["sed_step"]
    ca, ck = seen["sed_columns"]
    assert (sa[12] is None) == (not tables) and ck["rerun"] is not None
    n0 = (counter("sed_step.launches"), counter("sed_columns.launches"))
    fields, (rho, temp, dz, dt, dtab) = sa[:8], sa[8:13]
    vmax = None
    for dt_ in (dt, None):
        for pnc in (False, True):
            if dt_ is None:  # 4 sub-steps at the speed of the step
                dt_ = 3.5 * 0.9 * float(dz.min()) / float(vmax)
            vmax, one = SED.sed_step(*fields, rho, temp, dz, dt_, dtab,
                                     do_predict_nc=pnc)
            want_v, want_one = SED.step_plain(*fields, rho, temp, dz, dt_,
                                              dtab, pnc)
            oracle = SED.vmax_plain(*fields, rho, temp, dtab)
            assert vmax.shape == () and float(vmax) > 0.0
            for w in (want_v, oracle):
                assert abs(float(vmax) - float(w)) <= (TOL[vmax.dtype]
                                                       * float(w))
            _close_to_plain(one, want_one, (dtype, tables, pnc))
            nsub = torch.clamp(torch.ceil(dt_ * vmax / (0.9 * dz.min())),
                               min=1.0)
            got = SED.sed_columns(*fields, rho, temp, dz, dt_, nsub, dtab,
                                  do_predict_nc=pnc, rerun=one)
            assert all((g is o) for g, o in zip(got, one))
            ref = SED.columns_plain(*fields, rho, temp, dz, dt_, nsub, dtab,
                                    pnc, 1)
            assert len(got) == len(ref) == 10
            assert got[8].shape == (state.grid.nens, state.grid.ny,
                                    state.grid.nx)
            _close_to_plain(got, ref, (dtype, tables, int(nsub), pnc))
    assert int(nsub) == 4
    assert (counter("sed_step.launches"), counter("sed_columns.launches")) == (
        n0[0] + 4, n0[1] + 4)


def test_p3_sed_rejects_bad_input(cuda_device):
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as SED
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    x = torch.ones((2, 6, 4, 5), device=cuda_device)
    dtab = load_p3_tables().to(cuda_device, torch.float32)
    nsub = torch.tensor(1.0, device=cuda_device)
    kw = dict(do_predict_nc=False)
    with pytest.raises(TypeError):
        SED.sed_step(*[x.half()] * 11, 1.0, None, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        SED.sed_step(*[x] * 10, x.transpose(2, 3), 1.0, dtab, **kw)
    with pytest.raises(ValueError, match="axis 1"):
        SED.sed_step(*[x] * 11, 1.0, dtab, z_axis=2, **kw)
    with pytest.raises(ValueError, match="tables"):
        SED.sed_step(*[x] * 11, 1.0, load_p3_tables().to(cuda_device,
                                                         torch.float64), **kw)
    with pytest.raises(ValueError, match="nsub_t"):
        SED.sed_columns(*[x] * 11, 1.0, nsub.double(), dtab, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        SED.sed_columns(*[x] * 10, x[:, :, :, :4], 1.0, nsub, dtab, **kw)
    one = SED.sed_step(*[x] * 11, 1.0, dtab, **kw)[1]
    with pytest.raises(ValueError, match="rerun"):
        SED.sed_columns(*[x] * 11, 1.0, nsub, dtab, rerun=one[:9], **kw)
    with pytest.raises(ValueError, match="rerun"):
        SED.sed_columns(*[x] * 11, 1.0, nsub, dtab,
                        rerun=(*one[:8], one[8].double(), one[9]), **kw)


@pytest.mark.parametrize("tables", [True, False])
def test_p3_time_step_makes_no_host_sync(tables, cuda_device):
    """A whole MicrophysicsP3.time_step (f32, mixed regimes) after a warm
    step runs under torch.cuda's sync debug mode "error": the sub-step
    count stays on the card."""
    state, mods = _p3_state("float32", cuda_device)
    micro = mods[1].__self__
    if not tables:
        micro.tables = None
    state = micro.time_step(state, 2.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = micro.time_step(state, 2.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.validate() == {}


# -- FCT: the multiplier and the scaled tracer divergence --------------------

FCT_POSITIVE = (True, False, True, True, False)


def _fct_inputs(shape, dtype, device, rng):
    """Tracers, faces of both signs with zeros (so every branch of the
    upwind choice is taken), a running tendency and stage bases that go
    negative after the update."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def faces(axis):
        fshape = list(shape)
        fshape[axis] += 1
        F = rng.standard_normal(fshape)
        F[rng.random(fshape) < 0.1] = 0.0
        return t(F)
    tr = t(rng.uniform(-1e-4, 1e-2, shape))
    return (tr, {a: faces(a) for a in (-1, -2, -3)},
            t(rng.standard_normal(shape)), t(rng.uniform(-0.2, 1.0, shape)),
            t(rng.uniform(-0.2, 1.0, shape)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fct_kernels_match_plain(dtype, cuda_device):
    """fct_mult in 3-D and 2-D, and fct_scale_div along x, y and z in the
    forms the dycore uses (first, accumulating, the stage update with and
    without the second base), mixed positive flags, on a ragged shape."""
    from miniweatherml_tpu_torch.ops import fct

    rng = np.random.default_rng(11)
    shape = (len(FCT_POSITIVE), 2, 7, 9, 70)
    tr, F, t_prev, tr0, tr1 = _fct_inputs(shape, dtype, cuda_device, rng)
    for Fy in (F[-2], None):
        trm = tr if Fy is not None else tr[:, :, :, :1].contiguous()
        Fx = F[-1] if Fy is not None else F[-1][:, :, :, :1].contiguous()
        Fz = F[-3] if Fy is not None else F[-3][:, :, :, :1].contiguous()
        args = (trm, FCT_POSITIVE, Fx, Fy, Fz, 0.37, 5.0, 4.0, 2.5)
        n0 = counter("fct_mult.launches")
        got = fct.fct_mult(*args)
        assert counter("fct_mult.launches") == n0 + 1
        want = fct.fct_mult_plain(*args)
        assert got.shape == want.shape and (want < 1.0).any()
        assert _rel(want, got) <= TOL[dtype]
    mult = fct.fct_mult(tr, FCT_POSITIVE, F[-1], F[-2], F[-3], 0.37, 5.0,
                        4.0, 2.5)
    for axis in (-1, -2, -3):
        n = shape[axis]
        for form in ("first", "accumulate", "rk_tr1", "rk_no_tr1"):
            rk = None
            if form.startswith("rk"):
                rk = (0.75, 0.25, 0.1, tr0, tr1 if form == "rk_tr1" else None,
                      FCT_POSITIVE)
            prev = None if form == "first" else t_prev
            outs = []
            for fn in (fct.fct_scale_div_plain, fct.fct_scale_div):
                p = None if prev is None else prev.clone()
                n0 = counter("fct_scale_div.launches")
                out = fn(F[axis], mult, p, axis, n, 0.25, rk=rk)
                if p is not None:
                    assert out is p
                outs.append(out)
            assert counter("fct_scale_div.launches") == n0 + 1
            want, got = outs
            assert _rel(want, got) <= TOL[dtype], (axis, form)
            if rk is not None:
                assert got[0].min() == 0.0 and got[1].min() < 0.0


def _mult_case(ntr, nens, nz, ny, nx, dtype, device, rng, two_d):
    """tr and faces of an fct_mult call, with zeros of both signs among the
    faces and tracers (zero dividends take the kernel's shortcut); ny = 1
    and no Fy in 2-D."""
    shape = (ntr, nens, nz, 1 if two_d else ny, nx)
    tr, F, _, _, _ = _fct_inputs(shape, dtype, device, rng)

    def neg_zeros(a):
        hit = torch.as_tensor(rng.random(tuple(a.shape)) < 0.05,
                              device=a.device)
        return torch.where(hit, torch.full_like(a, -0.0), a)
    tr, F = neg_zeros(tr), {k: neg_zeros(v) for k, v in F.items()}
    return tr, F[-1], None if two_d else F[-2], F[-3]


@pytest.mark.parametrize("nx", [1, 3, 70, 128, 513, 1040])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fct_mult_kernel_equals_plain(dtype, nx, cuda_device):
    """fct_mult bit for bit against fct_mult_plain: 3-D and 2-D (Fy None),
    nens 2, mixed flags, no tracer flagged, 64 tracers with bit 63 set; row
    lengths that are and are not whole 16-byte vectors (and 1040 in f32: two
    sweeps of a 256-thread row), and arrays that are not 16-byte aligned."""
    from miniweatherml_tpu_torch.ops import fct

    rng = np.random.default_rng(nx)
    flags64 = tuple(i % 5 == 0 or i == 63 for i in range(64))
    cases = [(FCT_POSITIVE, 2, 3, 4, two_d) for two_d in (False, True)]
    cases += [((False,) * 3, 2, 3, 4, False), (flags64, 1, 2, 2, False)]
    for flags, nens, nz, ny, two_d in cases:
        tr, Fx, Fy, Fz = _mult_case(len(flags), nens, nz, ny, nx, dtype,
                                    cuda_device, rng, two_d)
        for shifted in (False, True):
            if shifted:  # the same values one element into their storage
                tr, Fx, Fz = (torch.cat([a.new_zeros(1), a.flatten()])[1:]
                              .view(a.shape) for a in (tr, Fx, Fz))
                assert tr.data_ptr() % 16 != 0
            args = (tr, flags, Fx, Fy, Fz, 0.37, 5.0, 4.0, 2.5)
            n0 = counter("fct_mult.launches")
            got = fct.fct_mult(*args)
            assert counter("fct_mult.launches") == n0 + 1
            want = fct.fct_mult_plain(*args)
            where = (len(flags), nens, nz, two_d, shifted)
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(got, want), where
            if any(flags):
                assert (want < 1.0).any(), where
            else:
                assert bool((got == 1.0).all()), where


def test_fct_mult_rejects_bad_input(cuda_device):
    from miniweatherml_tpu_torch.ops import fct

    rng = np.random.default_rng(4)
    tr, Fx, Fy, Fz = _mult_case(len(FCT_POSITIVE), 1, 4, 6, 8, torch.float32,
                                cuda_device, rng, False)
    rest = (0.37, 5.0, 4.0, 2.5)
    with pytest.raises(ValueError, match="contiguous"):
        fct.fct_mult(tr.transpose(3, 4).contiguous().transpose(3, 4),
                     FCT_POSITIVE, Fx, Fy, Fz, *rest)
    with pytest.raises(TypeError):
        fct.fct_mult(tr, FCT_POSITIVE, Fx.double(), Fy, Fz, *rest)
    with pytest.raises(TypeError):
        fct.fct_mult(tr.half(), FCT_POSITIVE, Fx.half(), Fy.half(),
                     Fz.half(), *rest)
    with pytest.raises(ValueError, match="device"):
        fct.fct_mult(tr, FCT_POSITIVE, Fx, Fy, Fz.cpu(), *rest)
    with pytest.raises(ValueError, match="shape"):
        fct.fct_mult(tr, FCT_POSITIVE, Fx, Fz, Fy, *rest)


def test_fct_rejects_bad_input(cuda_device):
    from miniweatherml_tpu_torch.ops import fct

    rng = np.random.default_rng(2)
    shape = (len(FCT_POSITIVE), 1, 4, 6, 8)
    tr, F, t_prev, _, _ = _fct_inputs(shape, torch.float32, cuda_device, rng)
    with pytest.raises(ValueError, match="contiguous"):
        fct.fct_scale_div(F[-1], tr.transpose(3, 4).contiguous().transpose(
            3, 4), None, -1, 8, 1.0)
    with pytest.raises(ValueError, match="shape"):
        fct.fct_scale_div(F[-2], tr, None, -1, 8, 1.0)
    with pytest.raises(TypeError):
        fct.fct_scale_div(F[-1], tr, t_prev.double(), -1, 8, 1.0)
    with pytest.raises(ValueError, match="device"):
        fct.fct_scale_div(F[-1], tr, t_prev.cpu(), -1, 8, 1.0)
    with pytest.raises(ValueError, match="flags"):
        fct.fct_mult(tr, FCT_POSITIVE[:2], F[-1], F[-2], F[-3], 1.0, 1.0,
                     1.0, 1.0)
    # above 64 tracers the wrapper launches once per group of at most 64
    many = torch.zeros((65, 1, 2, 2, 2), device=cuda_device)
    args = (many, (True,) * 65, torch.zeros((65, 1, 2, 2, 3),
                                            device=cuda_device),
            None, torch.zeros((65, 1, 3, 2, 2), device=cuda_device),
            1.0, 1.0, 1.0, 1.0)
    n0 = counter("fct_mult.launches")
    assert torch.equal(fct.fct_mult(*args), fct.fct_mult_plain(*args))
    assert counter("fct_mult.launches") == n0 + 2


def test_city_step_launches_its_kernels(cuda_device):
    """One step of the simple_city chain on the card goes through the flux
    and FCT kernels (9 + 3 + 9 launches at one CFL cycle) and matches the
    port's CPU run (f64, uniform cross-flow as in tests/test_torch_city.py,
    rtol 1e-9 plus 1e-7 of each field's scale)."""
    from miniweatherml_tpu_torch.experiments import simple_city

    cfg = config_from_dict(dict(
        sim_time=1.0, nens=2, nx_glob=64, ny_glob=64, nz=12, xlen=2000.0,
        ylen=2000.0, zlen=300.0, init_data="city", enable_gravity=False,
        dtype="float64"))
    counters = ("direction_fluxes.launches", "fct_mult.launches",
                "fct_scale_div.launches")
    states = []
    for device in ("cpu", cuda_device):
        state, mods, dycore = simple_city.build_chain(cfg, device)
        state = state.replace_fields(vvel=torch.full_like(state["vvel"], 2.0),
                                     wvel=torch.full_like(state["wvel"], 0.5))
        dt = dycore.compute_time_step(state)
        n0 = [counter(c) for c in counters]
        for m in mods:
            state = m(state, dt)
        states.append(state)
    assert [counter(c) - k for c, k in zip(counters, n0)] == [9, 3, 9]
    assert float(states[1]["immersed_proportion"].max()) == 1.0
    for name, a in states[0].fields.items():
        a = a.numpy()
        b = states[1][name].cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-9,
                                   atol=1e-7 * np.abs(a).max(), err_msg=name)


def test_p3_slice_on_card_matches_cpu(cuda_device):
    """The P3 chain through all its kernels against the port's CPU run:
    16x8x10 supercell_p3 f64 with smooth hydrometeor layers and part3
    diagnostics, 3 steps; rtol 1e-9 plus 1e-7 of each field's scale."""
    from miniweatherml_tpu_torch.experiments import supercell_p3

    cfg = config_from_dict(dict(
        sim_time=100.0, nx_glob=16, ny_glob=8, nz=10, xlen=40000.0,
        ylen=40000.0, zlen=16000.0, init_data="supercell", dtype="float64",
        p3_diagnostics=True))
    counters = [f"{k}.launches" for k in (
        "interp_ice", "interp_collect", "interp_rain", "p3_part1",
        "p3_update", "p3_wrapper", "p3_rates_pre", "p3_rates_post",
        "p3_part3", "p3_wrapper_out", "sed_step", "sed_columns")]
    states = []
    for device in ("cpu", cuda_device):
        state, mods, dycore = supercell_p3.build(cfg, device)
        state = supercell_p3.seed_layers(state)
        dt = dycore.compute_time_step(state)
        n0 = [counter(c) for c in counters]
        for _ in range(3):
            for m in mods:
                state = m(state, dt)
        states.append(state)
    assert all(counter(c) > k for c, k in zip(counters, n0))
    for name, a in states[0].fields.items():
        a = a.numpy()
        b = states[1][name].cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-9,
                                   atol=1e-7 * np.abs(a).max(), err_msg=name)


# -- the Kessler MLP surrogate ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_surrogate_forward_on_card_matches_cpu(dtype, cuda_device):
    """The surrogate's forward (normalise, two matmuls, LeakyReLU,
    denormalise, clamps) on the card against the CPU, on the same 16x8x10
    state after one step of the inference chain, with the shipped weights:
    f64 within 1e-12 of each output's scale, f32 within 1e-6 of each
    output's scaling range (the matmuls round differently; TF32 stays off)."""
    import os

    from miniweatherml_tpu_torch.core.coupler import (state_from_numpy,
                                                      state_to_numpy)
    from miniweatherml_tpu_torch.experiments import inference_surrogate

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    ex = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "inputs", "examples")
    cfg = config_from_dict(dict(
        sim_time=100.0, nx_glob=16, ny_glob=8, nz=10, xlen=40000.0,
        ylen=40000.0, zlen=10000.0, init_data="supercell", dtype=dtype,
        nn_weights=os.path.join(ex, "supercell_kessler_example_weights.npz"),
        nn_input_scaling=os.path.join(ex, "supercell_kessler_input_scaling.txt"),
        nn_output_scaling=os.path.join(
            ex, "supercell_kessler_output_scaling.txt"),
        surrogate_online=True))
    state, mods, dycore = inference_surrogate.build(cfg, "cpu")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    card = state_from_numpy(state_to_numpy(state), state.grid, state.options,
                            state.meta.tracers, dtype, device=cuda_device)
    micro = inference_surrogate.surrogate_from_config(cfg)
    want = micro._nn_forward(state)
    got = micro._nn_forward(card)
    scl_range = (micro.scl_out[:, 1] - micro.scl_out[:, 0]).double()
    for v, (a, b) in enumerate(zip(want, got)):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        err = (a.double() - b.cpu().double()).abs().max().item()
        if dtype == "float64":
            assert err <= 1e-12 * a.abs().max().item(), (v, err)
        else:
            assert err <= 1e-6 * scl_range[v].item(), (v, err)


def _surrogate_models(dtype, device):
    """(name, MLP, scl_in, scl_out) on ``device`` in ``dtype``: the shipped
    5 -> 10 -> 4 model with its scaling tables, then seeded models for the
    general form: 5 -> 17 -> 4, 5 -> 64 -> 64 -> 4, one of 18 layers, a 5
    -> 256 -> 256 -> 4 whose parameters exceed 227 KiB (the shared memory
    of a block) and a 5 -> 8000 -> 4 too wide for its activations to stay
    in shared memory."""
    import os
    from miniweatherml_tpu_torch.ml.mlp import (init_mlp, load_mlp,
                                                load_scaling)
    ex = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "inputs", "examples")
    si = load_scaling(os.path.join(
        ex, "supercell_kessler_input_scaling.txt"), 5, dtype, device)
    so = load_scaling(os.path.join(
        ex, "supercell_kessler_output_scaling.txt"), 4, dtype, device)
    gen = torch.Generator(device).manual_seed(5)
    out = [("shipped", load_mlp(os.path.join(
        ex, "supercell_kessler_example_weights.npz"), dtype, device), si, so)]
    for name, sizes, scale in (("5-17-4", (5, 17, 4), 0.5),
                               ("5-64-64-4", (5, 64, 64, 4), 0.2),
                               ("18 layers", (5,) + (8,) * 17 + (4,), 0.5),
                               ("5-256-256-4", (5, 256, 256, 4), 0.1),
                               ("5-8000-4", (5, 8000, 4), 0.02)):
        out.append((name, init_mlp(sizes, gen, scale, dtype), si, so))
    return out


def _surrogate_fields(shape, dtype, device, seed=9):
    """[T, rho_d, rho_v, rho_c, rho_r] over their scaling tables' ranges,
    with zero cloud and rain in a fifth of the cells."""
    rng = np.random.default_rng(seed)
    lo = np.array([200.0, 0.1, 0.0, 0.0, 0.0])
    hi = np.array([310.0, 1.2, 0.02, 3e-3, 8e-3])
    out = []
    for i in range(5):
        a = lo[i] + (hi[i] - lo[i]) * rng.random(shape)
        if i >= 3:
            a[rng.random(shape) < 0.2] = 0.0
        out.append(torch.as_tensor(a, dtype=dtype, device=device))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_surrogate_kernel_equals_plain(dtype, cuda_device):
    """Both kernel forms against the plain version (ordered sums), bit for
    bit: the fixed and the general form on the shipped 5 -> 10 -> 4 model,
    the general form on every other model of _surrogate_models; on
    2x7x9x13 cells (no multiple of the fixed form's 4-cell vectors or the
    general form's tiles), and the fixed form on fields one value past a
    16-byte boundary.  ``surrogate_forward`` takes the form kernel_form
    picks; the private ``_launch`` forces the other.  The launch counter
    shows the kernel ran and the plain version was never reached."""
    import miniweatherml_tpu_torch.physics.kessler_surrogate_cuda as SC

    shape = (2, 7, 9, 13)
    fields = _surrogate_fields(shape, dtype, cuda_device)
    shifted = [torch.cat([f.new_zeros(1), f.reshape(-1)])[1:].view(shape)
               for f in fields]
    for name, model, si, so in _surrogate_models(dtype, cuda_device):
        params, widths = SC.pack_mlp(model.weights, si, so)
        # None: surrogate_forward itself
        cases = [(None, fields)]
        if name == "shipped":
            assert SC.kernel_form(widths) == "fixed"
            cases += [("fixed", shifted), ("general", fields)]
        else:
            assert SC.kernel_form(widths) == "general"
        if name == "5-256-256-4":
            assert params.numel() * params.element_size() > 227 * 1024
        if name == "5-8000-4":
            assert SC._general_tile(widths, dtype)[2]  # activations in scratch
        for form, fs in cases:
            n0 = counter("surrogate_forward.launches")
            real, SC.surrogate_forward_plain = SC.surrogate_forward_plain, None
            try:
                got = (SC.surrogate_forward(*fs, params, widths) if form is None
                       else SC._launch(form, *fs, params, widths))
            finally:
                SC.surrogate_forward_plain = real
            assert counter("surrogate_forward.launches") == n0 + 1
            want = real(*fs, params, widths)
            for v, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == dtype and g.shape == shape
                assert torch.equal(g, w), (name, form, v, _rel(w, g))
            assert float(got[2].min()) >= 0.0


def test_surrogate_kernel_rejects_bad_input(cuda_device):
    """A model of other than 5 inputs and 4 outputs raises a ValueError on
    the card as on the CPU, and so does the fixed form for widths it is not
    built for; a field of the wrong shape, dtype or device, or a
    non-contiguous one, raises too."""
    from miniweatherml_tpu_torch.ml.mlp import init_mlp
    from miniweatherml_tpu_torch.physics.kessler_surrogate_cuda import (
        _launch, pack_mlp, surrogate_forward)

    si = torch.ones((5, 2), device=cuda_device)
    so = torch.ones((4, 2), device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(1)
    with pytest.raises(ValueError, match="5 inputs to 4 outputs"):
        pack_mlp(init_mlp((5, 8, 3), gen).weights, si, so)
    with pytest.raises(ValueError, match="5 inputs to 4 outputs"):
        pack_mlp(init_mlp((6, 8, 4), gen).weights, si, so)
    params, widths = pack_mlp(init_mlp((5, 8, 4), gen).weights, si, so)
    x = torch.ones((2, 3, 4, 5), device=cuda_device)
    with pytest.raises(ValueError, match="fixed"):
        _launch("fixed", x, x, x, x, x, params, widths)
    with pytest.raises(ValueError, match="contiguous"):
        surrogate_forward(x, x, x, x, x.transpose(2, 3), params, widths)
    with pytest.raises(ValueError, match="of shape"):
        surrogate_forward(x, x, x, x, x[:1], params, widths)
    with pytest.raises(TypeError, match="contiguous"):
        surrogate_forward(x, x, x, x.double(), x, params, widths)
    with pytest.raises(ValueError, match="contiguous"):
        surrogate_forward(x, x, x.cpu(), x, x, params, widths)
    with pytest.raises(TypeError, match="contiguous"):
        surrogate_forward(x, x, x, x, x, params.double(), widths)
    with pytest.raises(TypeError):
        surrogate_forward(*(x.half(),) * 5, params.half(), widths)


# -- the halo-strip form of the flux kernel, FCT edges, the decomposed step --

def _strips_of(prim, axis, bc, nid, i, ns, hp):
    """Shard i's block of ``prim`` along ``axis`` and its strips, cut from
    the global padding, with each end's face mode."""
    from miniweatherml_tpu_torch.ops.stencil import pad_bc
    pad = pad_bc(prim, axis, hp, bc, zero_var=nid if bc == 2 else None)
    nl = prim.shape[axis] // ns
    block = prim.narrow(axis, i * nl, nl).contiguous()
    lo = pad.narrow(axis, i * nl, hp).contiguous()
    hi = pad.narrow(axis, (i + 1) * nl + hp, hp).contiguous()
    return block, (lo, hi, bc if i == 0 else 0, bc if i == ns - 1 else 0)


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_direction_fluxes_strip_form_matches_plain(ord_, cuda_device):
    """x and y split in three: every shard (both boundary shards with each
    BC), both types, bit for bit; and the strip form of a periodic axis
    reassembles the whole-axis kernel's result."""
    rng = np.random.default_rng(ord_)
    hp = (ord_ - 1) // 2 + 1
    for dtype in (torch.float64, torch.float32):
        prim = _prim((2, 7, 36, 72), dtype, cuda_device, rng, 8)
        hr = torch.as_tensor(1 + 0.1 * rng.random((2, 7)), dtype=dtype,
                             device=cuda_device)
        for axis, nid in DIRS[:2]:
            n = prim.shape[axis]
            for bc in (0, 1, 2):
                whole = direction_fluxes(prim, axis, n, bc, nid, 27.56,
                                         1.4008, hr, 300 * hr,
                                         weno_matrices(ord_), 0.0, 2e-3)
                parts = []
                for i in range(3):
                    block, strips = _strips_of(prim, axis, bc, nid, i, 3, hp)
                    args = (block, axis, block.shape[axis], bc, nid, 27.56,
                            1.4008, hr, 300 * hr, weno_matrices(ord_), 0.0,
                            2e-3, strips)
                    n0 = counter("direction_fluxes.strip_launches")
                    got = direction_fluxes(*args)
                    assert counter("direction_fluxes.strip_launches") == n0 + 1
                    for a, b in zip(direction_fluxes_plain(*args), got):
                        assert torch.equal(a, b), (dtype, axis, bc, i)
                    parts.append(got)
                sdiv = torch.cat([p[0] for p in parts], dim=axis)
                assert torch.equal(sdiv, whole[0]), (dtype, axis, bc)


def test_direction_fluxes_strip_form_rejects_bad_strips(cuda_device):
    prim = torch.zeros((8, 1, 4, 6, 8), device=cuda_device)
    hy = torch.ones((1, 4), device=cuda_device)
    ok = torch.zeros((8, 1, 4, 6, 3), device=cuda_device)
    base = (prim, -1, 8, 2, 1, 27.56, 1.4008, hy, hy, weno_matrices(5), 0.0,
            1.0)
    with pytest.raises(ValueError, match="lo"):
        direction_fluxes(*base, (ok[..., :2], ok, 2, 0))
    with pytest.raises(ValueError, match="end modes"):
        direction_fluxes(*base, (ok, ok, 1, 0))
    zs = torch.zeros((8, 1, 3, 6, 8), device=cuda_device)
    with pytest.raises(ValueError, match="z is never split"):
        direction_fluxes(prim, -3, 4, 2, 3, 27.56, 1.4008,
                         torch.ones((1, 5), device=cuda_device),
                         torch.ones((1, 5), device=cuda_device),
                         weno_matrices(5), 0.0, 1.0, (zs, zs, 2, 0))


def _stage_case(shape, dtype, device, rng, sim2d=False):
    """A running tendency, stage bases b0 / b1, a cell density profile and
    an immersed proportion (zeros, ones and values between) of a cell
    block ``shape`` = (nens, nz, ny, nx)."""
    t = (lambda a: torch.as_tensor(a, dtype=dtype, device=device))
    full = (5,) + shape
    imm = rng.uniform(0.0, 1.0, shape)
    imm[rng.random(shape) < 0.3] = 0.0
    imm[rng.random(shape) < 0.2] = 1.0
    return (t(rng.standard_normal(full)), t(rng.standard_normal(full)),
            t(rng.standard_normal(full)),
            t(1 + 0.1 * rng.random(shape[:2])), t(imm))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_direction_fluxes_epilogues_match_plain(dtype, cuda_device):
    """The accumulator and stage-update forms along y and z, whole axis and
    (y) halo strips, with and without b1, gravity, Coriolis, 2-D and the
    immersed blend, at 8 and 17 variables (two tracer groups: the epilogue
    in the first launch only): bit for bit, acc written in place."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import StageUpdate
    rng = np.random.default_rng(21)
    for shape, nvar in (((2, 7, 35, 70), 8), ((1, 67, 5, 40), 8),
                        ((1, 10, 12, 16), 17), ((2, 12, 1, 40), 8)):
        prim = _prim(shape, dtype, cuda_device, rng, nvar)
        acc0, b0, b1, hyc, imm = _stage_case(shape, dtype, cuda_device, rng)
        sim2d = shape[2] == 1
        groups = 2 if nvar > 14 else 1
        forms = [None] + [
            StageUpdate(c0, c1, 0.1, b0, bb, hyc, grav, fcor, im, 0.37,
                        sim2d)
            for (c0, c1, bb) in ((1.0, 0.0, None), (0.75, 0.25, b1))
            for (grav, fcor, im) in ((9.81, 0.0, None), (None, 1e-4, imm),
                                     (9.81, 1e-4, imm))]
        for axis, nid in DIRS[1:]:
            if sim2d and axis == -2:
                continue
            nl = shape[1] + (1 if axis == -3 else 0)
            hr = torch.as_tensor(1 + 0.1 * rng.random((shape[0], nl)),
                                 dtype=dtype, device=cuda_device)
            # the whole axis (y periodic, z walls: the main path's), and
            # both shards of y split in two with walls at the ends
            variants = [(prim, None, 0 if axis == -2 else 2, slice(None))]
            if axis == -2:
                half = shape[2] // 2
                for i in (0, 1):
                    block, strips = _strips_of(prim, axis, 2, nid, i, 2, 3)
                    variants.append((block, strips, 2,
                                     slice(i * half, (i + 1) * half)))
            for p, strips, bc, cut in variants:
                def part(x):
                    return x[..., cut, :].contiguous()
                args = (p, axis, p.shape[axis], bc, nid, 27.56, 1.4008,
                        hr if axis == -3 else hyc, 300 * hr, weno_matrices(5),
                        0.0, 2e-3, strips)
                for rk in forms:
                    if rk is not None:
                        rk = rk._replace(
                            b0=part(rk.b0),
                            b1=None if rk.b1 is None else part(rk.b1),
                            immersed=None if rk.immersed is None
                            else part(rk.immersed))
                    a1, a2 = part(acc0), part(acc0)
                    want = direction_fluxes_plain(*args, acc=a1, rk=rk)
                    n0 = counter("direction_fluxes.launches")
                    got = direction_fluxes(*args, acc=a2, rk=rk)
                    assert counter("direction_fluxes.launches") == n0 + groups
                    assert got[0] is a2
                    where = (dtype, shape, axis, strips is not None,
                             rk and (rk.b1 is not None, rk.grav, rk.fcor))
                    assert torch.equal(want[0], got[0]), where
                    assert torch.equal(want[1], got[1]), where


def test_direction_fluxes_epilogue_rejects_bad_input(cuda_device):
    from miniweatherml_tpu_torch.ops.direction_fluxes import StageUpdate
    prim = torch.zeros((8, 1, 4, 6, 8), device=cuda_device)
    hy = torch.ones((1, 4), device=cuda_device)
    acc = torch.zeros((5, 1, 4, 6, 8), device=cuda_device)
    base = (prim, -2, 6, 0, 2, 27.56, 1.4008, hy, hy, weno_matrices(5), 0.0,
            1.0)
    rk = StageUpdate(1.0, 0.0, 0.1, acc.clone(), None, hy, 9.81, 0.0, None,
                     0.1, False)
    with pytest.raises(ValueError, match="accumulator"):
        direction_fluxes(*base, rk=rk)
    with pytest.raises(ValueError, match="first direction"):
        direction_fluxes(prim, -1, 8, 0, 1, 27.56, 1.4008, hy, hy,
                         weno_matrices(5), 0.0, 1.0, acc=acc)
    with pytest.raises(ValueError, match="acc"):
        direction_fluxes(*base, acc=acc[:, :, :2])
    with pytest.raises(ValueError, match="b0"):
        direction_fluxes(*base, acc=acc, rk=rk._replace(b0=acc[..., :4]))
    with pytest.raises(ValueError, match="immersed"):
        direction_fluxes(*base, acc=acc, rk=rk._replace(immersed=acc))
    with pytest.raises(ValueError, match="b0 or b1"):
        direction_fluxes(*base, acc=acc, rk=rk._replace(b1=acc))


# (nens, nz, ny, nx) at the edges of the y/z kernel's tiling
# (csrc/direction_fluxes.cuh, fluxes_tiled: 16-line tiles, steps of 16
# cells, n + 2 lanes a line in a chunk): axes of 1 and 2 cells; n + 2 one
# below (13, 29), at (14, 30) and one above (15, 31) a multiple of the step;
# the benchmark's z of 100 cells; line counts that leave partial tiles; and
# axes of 300 cells on grids of few blocks, which the launch cuts into
# chunks of 75 cells
TILED_SHAPES = ((1, 1, 1, 17), (2, 2, 2, 16), (1, 13, 14, 9), (1, 15, 29, 5),
                (1, 14, 30, 3), (1, 31, 15, 18), (1, 100, 2, 18),
                (1, 300, 3, 16), (1, 2, 300, 17))
# the limiter algebras of each type: in f32 the approximate-reciprocal
# forms too, held to the plain version run on the card's reciprocal
TILED_FORMS = {torch.float64: ({}, {"opt": True}),
               torch.float32: ({}, {"opt": True},
                               {"opt": True, "fast_weights": True},
                               {"fast_weights": True})}


def _tiled_want(plain, dtype, kw):
    """The plain version's outputs the kernel must equal bit for bit: on
    the card's approximate reciprocal for the f32 fast forms."""
    if dtype == torch.float32 and kw.get("fast_weights"):
        return cs._with_recip(cs._card_recip, plain)
    return plain()


@pytest.mark.parametrize("nvar", [5, 6, 8, 14])
@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_tiled_kernel_edges_match_plain(ord_, nvar, cuda_device):
    """y and z on TILED_SHAPES, every BC, f32 and f64, every algebra (with
    a cutoff in the reference ones): bit for bit with the plain version (the
    fast forms on the card's reciprocal); each y/z call counts one tiled
    launch, an x call none."""
    rng = np.random.default_rng(ord_ * 100 + nvar + 11)
    for dtype, forms in TILED_FORMS.items():
        for shape in TILED_SHAPES:
            prim = _prim(shape, dtype, cuda_device, rng, nvar)
            for axis, nid in DIRS[1:]:
                nl = shape[1] + (1 if axis == -3 else 0)
                hr = torch.as_tensor(1 + 0.1 * rng.random((shape[0], nl)),
                                     dtype=dtype, device=cuda_device)
                for bc in (0, 1, 2):
                    for i, kw in enumerate(forms):
                        cutoff = 0.1 if not kw.get("opt") and bc == 1 else 0.0
                        args = (prim, axis, prim.shape[axis], bc, nid, 27.56,
                                1.4008, hr, 300 * hr, weno_matrices(ord_),
                                cutoff, 2e-3)
                        want = _tiled_want(
                            lambda: direction_fluxes_plain(*args, **kw),
                            dtype, kw)
                        n0 = counter("direction_fluxes.tiled_launches")
                        got = direction_fluxes(*args, **kw)
                        assert counter("direction_fluxes.tiled_launches") \
                            == n0 + 1
                        where = (dtype, shape, axis, bc, kw, cutoff)
                        for a, b in zip(want, got):
                            assert a.shape == b.shape, where
                            assert torch.equal(a, b), where
    prim = _prim(TILED_SHAPES[2], torch.float32, cuda_device, rng, nvar)
    hy = torch.ones((1, 13), device=cuda_device)
    n0 = counter("direction_fluxes.tiled_launches")
    direction_fluxes(prim, -1, 9, 0, 1, 27.56, 1.4008, hy, 300 * hy,
                     weno_matrices(ord_), 0.0, 2e-3)
    assert counter("direction_fluxes.tiled_launches") == n0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_kernel_epilogues_at_edges_match_plain(dtype, cuda_device):
    """The accumulator and stage-update forms (with and without b1,
    gravity, Coriolis and the immersed blend; v = 0 on the 2-D slab, whose
    last direction is z) on shapes at the tiling's edges, y and z, whole
    axis and (y) the halo-strip form of each half: bit for bit with the
    plain version in every algebra of the type (the fast forms on the
    card's reciprocal), acc written in place, one tiled launch a call."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import StageUpdate
    rng = np.random.default_rng(23)
    for shape, nvar, ord_ in (((1, 13, 14, 9), 8, 5), ((1, 15, 30, 5), 14, 7),
                              ((1, 300, 2, 16), 6, 9), ((1, 2, 300, 17), 8, 3),
                              ((2, 31, 1, 18), 8, 5)):
        prim = _prim(shape, dtype, cuda_device, rng, nvar)
        acc0, b0, b1, hyc, imm = _stage_case(shape, dtype, cuda_device, rng)
        sim2d = shape[2] == 1
        forms = [None] + [
            StageUpdate(c0, c1, 0.1, b0, bb, hyc, grav, fcor, im, 0.37,
                        sim2d)
            for (c0, c1, bb) in ((1.0, 0.0, None), (0.75, 0.25, b1))
            for (grav, fcor, im) in ((9.81, 0.0, None), (None, 1e-4, imm),
                                     (9.81, 1e-4, imm))]
        for axis, nid in DIRS[1:]:
            if sim2d and axis == -2:
                continue
            nl = shape[1] + (1 if axis == -3 else 0)
            hr = torch.as_tensor(1 + 0.1 * rng.random((shape[0], nl)),
                                 dtype=dtype, device=cuda_device)
            variants = [(prim, None, 0 if axis == -2 else 2, slice(None))]
            if axis == -2:
                half = shape[2] // 2
                for i in (0, 1):
                    block, strips = _strips_of(prim, axis, 2, nid, i, 2,
                                               (ord_ - 1) // 2 + 1)
                    variants.append((block, strips, 2,
                                     slice(i * half, (i + 1) * half)))
            for p, strips, bc, cut in variants:
                def part(x):
                    return x[..., cut, :].contiguous()
                args = (p, axis, p.shape[axis], bc, nid, 27.56, 1.4008,
                        hr if axis == -3 else hyc, 300 * hr,
                        weno_matrices(ord_), 0.0, 2e-3, strips)
                for rk in forms:
                    if rk is not None:
                        rk = rk._replace(
                            b0=part(rk.b0),
                            b1=None if rk.b1 is None else part(rk.b1),
                            immersed=None if rk.immersed is None
                            else part(rk.immersed))
                    for kw in TILED_FORMS[dtype][1:]:
                        want = _tiled_want(
                            lambda: direction_fluxes_plain(
                                *args, acc=part(acc0), rk=rk, **kw),
                            dtype, kw)
                        a2 = part(acc0)
                        n0 = counter("direction_fluxes.tiled_launches")
                        got = direction_fluxes(*args, acc=a2, rk=rk, **kw)
                        assert counter("direction_fluxes.tiled_launches") \
                            == n0 + 1
                        assert got[0] is a2
                        where = (dtype, shape, axis, strips is not None, kw,
                                 rk and (rk.b1 is not None, rk.grav, rk.fcor))
                        assert torch.equal(want[0], got[0]), where
                        assert torch.equal(want[1], got[1]), where


def test_fct_scale_div_edges_match_plain(cuda_device):
    """Edge multipliers in every form and direction, both types, bit for
    bit."""
    from miniweatherml_tpu_torch.ops.fct import (fct_scale_div,
                                                 fct_scale_div_plain)
    rng = np.random.default_rng(5)
    shape = (3, 2, 6, 20, 36)
    for dtype in (torch.float64, torch.float32):
        t = (lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device))
        mult = t(rng.uniform(0.05, 1.0, shape))
        tr0, tr1, prev = (t(rng.uniform(-0.2, 1.0, shape)) for _ in range(3))
        for axis in (-1, -2, -3):
            fs = list(shape)
            fs[axis] += 1
            F = t(rng.standard_normal(fs))
            es = list(shape)
            es[axis] = 1
            edges = (t(rng.uniform(0.05, 1.0, es)),
                     t(rng.uniform(0.05, 1.0, es)))
            for rk in (None, (0.75, 0.25, 0.1, tr0, tr1, (True, False, True)),
                       (1.0, 0.0, 0.1, tr0, None, (True, True, False))):
                for p in (None, prev):
                    args = (F, mult, None if p is None else p.clone(), axis,
                            shape[axis], 2.0, rk, edges)
                    n0 = counter("fct_scale_div.edge_launches")
                    got = fct_scale_div(*args)
                    assert counter("fct_scale_div.edge_launches") == n0 + 1
                    want = fct_scale_div_plain(
                        F, mult, None if p is None else p.clone(), axis,
                        shape[axis], 2.0, rk, edges)
                    assert torch.equal(got, want), (dtype, axis)


def test_spmd_dycore_step_is_the_undecomposed_step(cuda_device):
    """A 2x2 mesh of one card: one dycore step equals the undecomposed
    step bit for bit, with walls in x and open ends in y."""
    from miniweatherml_tpu_torch.parallel.mesh import (gather_state,
                                                       make_mesh, shard_state)
    from miniweatherml_tpu_torch.parallel.spmd import make_spmd_step
    state, _, dycore = build(config_from_dict(dict(
        sim_time=10.0, nens=1, nx_glob=32, ny_glob=16, nz=10, xlen=40000.0,
        ylen=20000.0, zlen=10000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0, dtype="float64")), cuda_device)
    state = state.set_options(bc_x=2, bc_y=1)
    state = state.replace_fields(vvel=state["vvel"] + 2.0)
    dt = dycore.compute_time_step(state)
    mesh = make_mesh([cuda_device] * 4, y=2, x=2)
    step = make_spmd_step(state, mesh, dycore, sponge_time_scale=None)
    out = gather_state(step(shard_state(state, mesh), dt), cuda_device)
    step.close()
    ref = dycore.time_step(state, dt)
    for name in ref.fields:
        assert torch.equal(ref[name], out[name]), name


# -- tracer groups and the P3 native twin --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_flux_and_fct_tracer_groups_match_plain(dtype, cuda_device):
    """12 tracers through the flux kernel (two launches per direction) and
    the FCT kernels at 12 and 70 tracers, bit for bit against the plain
    versions."""
    from miniweatherml_tpu_torch.ops import fct

    rng = np.random.default_rng(12)
    shape = (1, 10, 12, 16)
    prim = _prim(shape, dtype, cuda_device, rng, nvar=17)
    for axis, nid in DIRS:
        nl = shape[1] + (1 if axis == -3 else 0)
        hr = torch.as_tensor(1 + 0.1 * rng.random((1, nl)), dtype=dtype,
                             device=cuda_device)
        args = (prim, axis, prim.shape[axis], 2, nid, 27.56, 1.4008, hr,
                300 * hr, weno_matrices(5), 0.0, 2e-3)
        n0 = counter("direction_fluxes.launches")
        got = direction_fluxes(*args)
        assert counter("direction_fluxes.launches") == n0 + 2
        for a, b in zip(direction_fluxes_plain(*args), got):
            assert torch.equal(a, b), axis
    for ntr, launches in ((12, 1), (70, 2)):
        flags = tuple(i % 3 != 1 for i in range(ntr))
        tr, Fx, Fy, Fz = _mult_case(ntr, 1, 3, 4, 8, dtype, cuda_device, rng,
                                    False)
        margs = (tr, flags, Fx, Fy, Fz, 0.37, 5.0, 4.0, 2.5)
        n0 = counter("fct_mult.launches")
        mult = fct.fct_mult(*margs)
        assert counter("fct_mult.launches") == n0 + launches
        assert torch.equal(mult, fct.fct_mult_plain(*margs)), ntr
        t_prev = torch.randn(tuple(tr.shape), dtype=dtype, device=cuda_device)
        rk = (0.75, 0.25, 0.1, tr, tr.flip(0).contiguous(), flags)
        for F, axis, n in ((Fx, -1, 8), (Fy, -2, 4), (Fz, -3, 3)):
            want = fct.fct_scale_div_plain(F, mult, t_prev.clone(), axis, n,
                                           0.2, rk)
            n0 = counter("fct_scale_div.launches")
            got = fct.fct_scale_div(F, mult, t_prev.clone(), axis, n, 0.2, rk)
            assert counter("fct_scale_div.launches") == n0 + launches
            assert torch.equal(got, want), (ntr, axis)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_native_backend_returns_fields_on_the_card(dtype, cuda_device):
    """MicrophysicsP3(backend="native") on a CUDA state: the twin's fields
    come back on the card in the state's dtype; in f64 they match the same
    step on the CPU within 1e-7 of each field's scale (the P3 slices' bar:
    the wrapper inputs come from the card's kernel there)."""
    from miniweatherml_tpu_torch.physics.p3 import MicrophysicsP3

    st = _p3_state(dtype, cuda_device)[0]
    micro = MicrophysicsP3(backend="native")
    out = micro.time_step(st, 2.0)
    for name, v in out.fields.items():
        assert v.device == st[name].device and v.dtype == st[name].dtype, name
        assert v.is_contiguous(), name
    assert out.validate() == {}
    if dtype == "float64":
        ref = micro.time_step(_p3_state(dtype, "cpu")[0], 2.0)
        for name in ref.fields:
            assert _rel(ref[name], out[name].cpu()) <= 1e-7, name


def test_native_chain_on_card_validates(cuda_device):
    """Two steps of the 32x32x16 supercell_p3 chain with the native micro
    on the card (seeded layers, so there is ice to sediment)."""
    from miniweatherml_tpu_torch.experiments import supercell_p3

    cfg = config_from_dict(dict(
        sim_time=100.0, nx_glob=32, ny_glob=32, nz=16, xlen=40000.0,
        ylen=40000.0, zlen=16000.0, init_data="supercell", out_freq=-1.0,
        dtype="float32", p3_backend="native"))
    state, mods, dycore = supercell_p3.build(cfg, cuda_device)
    state = supercell_p3.seed_layers(state)
    dt = dycore.compute_time_step(state)
    for _ in range(2):
        for m in mods:
            state = m(state, dt)
    assert state.validate() == {}
    assert torch.isfinite(state["wvel"]).all()
    assert state["ice"].device.type == torch.device(cuda_device).type
    assert float(state["ice"].max()) > 0.0 and float(state["precl"].max()) > 0.0


# -- the dycore's state transforms -------------------------------------------

# (nens, nz, ny, nx): a plane of no whole number of f32 vectors (one value
# at a time), of whole vectors, an ensemble, and a 2-D slab
STATE_SHAPES = ((2, 7, 5, 70), (1, 9, 3, 37), (2, 4, 16, 64), (1, 6, 1, 33))
STATE_NTR = (1, 3, 9, ds.MAX_TRACERS)


def _state_case(shape, ntr, dtype, device, rng, offset=0):
    """A coupler's fields of ``ntr`` tracers (about half of each non-vapor
    tracer zero) and hydrostatic profiles; each field starts ``offset``
    values into its storage."""
    nens, nz = shape[:2]

    def field(a):
        t = torch.as_tensor(np.concatenate([np.zeros(offset), a.ravel()]),
                            dtype=dtype, device=device)
        return t[offset:].view(shape)
    rho_d = 1.0 + 0.1 * rng.random(shape)
    fields = [field(rho_d)] + [field(10 * rng.standard_normal(shape))
                               for _ in range(3)]
    fields.append(field(280 + 20 * rng.random(shape)))
    trs = [field(np.where(rng.random(shape) < 0.5, 0.0,
                          1e-3 * rng.random(shape))) for _ in range(ntr)]
    hyc = torch.as_tensor(1 + 0.1 * rng.random((nens, nz)), dtype=dtype,
                          device=device)
    return fields, trs, hyc, 300 * hyc


def _state_thermo(ntr, rng, masks="mixed"):
    adds = {"all": [True] * ntr, "none": [False] * ntr,
            "mixed": list(rng.random(ntr) < 0.5)}[masks]
    return dict(idWV=int(rng.integers(ntr)), adds_mass=adds, R_d=287.0,
                R_v=461.0, gamma=1003.0 / 716.0,
                C0=(287.0 * 1e5 ** (-287.0 / 1003.0)) ** (1003.0 / 716.0))


def _equal_all(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_contiguous(), (what, i)
        assert torch.equal(g, w), (
            f"{what} output {i}: max diff {(g - w).abs().max().item()}")


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ntr", STATE_NTR)
def test_dycore_state_kernels_match_plain(ntr, dtype, offset, cuda_device):
    """The three transforms at every shape, with all, none and a mix of
    the tracers adding mass, bit for bit against their plain versions on
    the card; 16-byte vectors where the planes and pointers allow
    (offset 0), one value at a time elsewhere (offset 1)."""
    rng = np.random.default_rng(ntr * 10 + offset)
    for shape in STATE_SHAPES:
        fields, trs, hyc, hyt = _state_case(shape, ntr, dtype, cuda_device,
                                            rng, offset)
        for masks in ("all", "none", "mixed"):
            th = _state_thermo(ntr, rng, masks)
            n0 = counter("dycore_state.launches")
            s, tr = ds.coupler_to_dynamics(*fields, trs, hyc, hyt, **th)
            _equal_all((s, tr), ds.coupler_to_dynamics_plain(
                *fields, trs, hyc, hyt, **th), (shape, masks, "to dyn"))
            prim = ds.dedensitize(s, tr, hyc)
            _equal_all((prim,), (ds.dedensitize_plain(s, tr, hyc),),
                       (shape, masks, "prim"))
            back = ds.dynamics_to_coupler(s, tr, hyc, hyt, **th)
            _equal_all(back, ds.dynamics_to_coupler_plain(
                s, tr, hyc, hyt, **th), (shape, masks, "to coupler"))
            assert counter("dycore_state.launches") == n0 + 3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dedensitize_kernel_takes_any_tracer_count(dtype, cuda_device):
    """No tracer, and more than a conversion takes."""
    rng = np.random.default_rng(5)
    for shape in STATE_SHAPES:
        for ntr in (0, ds.MAX_TRACERS + 6):
            s = torch.as_tensor(rng.standard_normal((5,) + shape),
                                dtype=dtype, device=cuda_device)
            tr = torch.as_tensor(rng.random((ntr,) + shape), dtype=dtype,
                                 device=cuda_device)
            hyc = torch.as_tensor(1 + rng.random(shape[:2]), dtype=dtype,
                                  device=cuda_device)
            _equal_all((ds.dedensitize(s, tr, hyc),),
                       (ds.dedensitize_plain(s, tr, hyc),), (shape, ntr))


def _chain_state(chain, dtype, device):
    """A chain's state after one step of its modules on the card, and its
    dycore."""
    from miniweatherml_tpu_torch.experiments import simple_city, supercell_p3
    if chain == "city":
        cfg = config_from_dict(dict(
            sim_time=1.0, nens=2, nx_glob=64, ny_glob=64, nz=12,
            xlen=2000.0, ylen=2000.0, zlen=300.0, init_data="city",
            enable_gravity=False, dtype=dtype))
        state, mods, dycore = simple_city.build_chain(cfg, device)
        state = state.replace_fields(
            vvel=torch.full_like(state["vvel"], 2.0),
            wvel=torch.full_like(state["wvel"], 0.5))
    else:
        cfg = config_from_dict(dict(
            sim_time=100.0, nx_glob=16, ny_glob=8, nz=10, xlen=40000.0,
            ylen=40000.0, zlen=10000.0, init_data="supercell", dtype=dtype))
        if chain == "p3":
            state, mods, dycore = supercell_p3.build(cfg, device)
            state = supercell_p3.seed_mixed_regimes(state)
        else:
            state, mods, dycore = build(cfg, device)
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    return state, dycore, dt


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("chain", ["kessler", "p3", "city"])
def test_dycore_step_through_state_kernels_is_the_plain_step(
        chain, dtype, cuda_device, monkeypatch):
    """A whole Dycore.time_step through the three kernels (5 launches at
    one CFL cycle) equals the same step with the plain transforms, bit for
    bit."""
    from miniweatherml_tpu_torch.dycore import euler

    state, dycore, dt = _chain_state(chain, dtype, cuda_device)
    n0 = counter("dycore_state.launches")
    got = dycore.time_step(state, dt)
    assert counter("dycore_state.launches") == n0 + 5
    for name in ("dedensitize", "coupler_to_dynamics",
                 "dynamics_to_coupler"):
        monkeypatch.setattr(euler, name, getattr(ds, name + "_plain"))
    want = dycore.time_step(state, dt)
    assert counter("dycore_state.launches") == n0 + 5
    for name in want.fields:
        assert torch.equal(got[name], want[name]), name


def test_dycore_state_kernels_reject_bad_input(cuda_device):
    rng = np.random.default_rng(3)
    shape = (1, 4, 3, 8)
    fields, trs, hyc, hyt = _state_case(shape, 3, torch.float32, cuda_device,
                                        rng)
    th = _state_thermo(3, rng)
    s, tr = ds.coupler_to_dynamics(*fields, trs, hyc, hyt, **th)
    with pytest.raises(TypeError):                       # dtype
        ds.dedensitize(s.half(), tr.half(), hyc.half())
    with pytest.raises(TypeError):
        ds.dedensitize(s, tr.double(), hyc)
    with pytest.raises(ValueError):                      # device
        ds.dedensitize(s, tr.cpu(), hyc)
    with pytest.raises(ValueError):
        ds.dynamics_to_coupler(s, tr, hyc.cpu(), hyt, **th)
    with pytest.raises(ValueError):                      # shape
        ds.dedensitize(s[:4], tr, hyc)
    with pytest.raises(ValueError):
        ds.dedensitize(s, tr[..., :4], hyc)
    with pytest.raises(ValueError):
        ds.dynamics_to_coupler(s, tr, hyc[:, :2], hyt, **th)
    def strided(x):
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError):                      # contiguity
        ds.coupler_to_dynamics(strided(fields[0]), *fields[1:], trs, hyc,
                               hyt, **th)
    with pytest.raises(ValueError):
        ds.coupler_to_dynamics(*fields, [strided(trs[0])] + trs[1:], hyc,
                               hyt, **th)
    with pytest.raises(ValueError):                      # tracer count
        ds.coupler_to_dynamics(*fields, trs * 22, hyc, hyt,
                               **_state_thermo(66, rng))
    with pytest.raises(ValueError):                      # vapor index
        ds.dynamics_to_coupler(s, tr, hyc, hyt, **dict(th, idWV=3))
    with pytest.raises(ValueError):                      # pow special case
        ds.dynamics_to_coupler(s, tr, hyc, hyt, **dict(th, gamma=2.0))
    with pytest.raises(ValueError):                      # other devices
        ds.dedensitize(s.to("meta"), tr.to("meta"), hyc.to("meta"))
