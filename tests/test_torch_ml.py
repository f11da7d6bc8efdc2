"""The port's ML-surrogate workflow (``miniweatherml_tpu_torch.ml``) against
the JAX package on the CPU: the MLP and its weight files, the harvest's
activity mask, stratified selection, dataset rows and NetCDF file, the
activity statistics, the optimizer, training, and the harvest -> train ->
deploy loop on the port alone.

Tolerances: weight files, scaling tables, masks, selections and dataset
rows are equal exactly; the MLP forward within rtol 1e-6 in f32 (the
packages' f32 matmuls round differently) and 1e-14 in f64; one
``optax.nadam`` update within rtol 1e-6 in f32; two epochs of training from
the same weights within rtol 1e-5 (16 Adam steps carry those f32
roundings on; they differ by ~1e-7 of scale).
"""

import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments.supercell_example import build as jax_build
from miniweatherml_tpu.ml import mlp as JM
from miniweatherml_tpu.ml import surrogate_data as JD
from miniweatherml_tpu.ml import train as JT
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.ml import mlp as TM
from miniweatherml_tpu_torch.ml import surrogate_data as TD
from miniweatherml_tpu_torch.ml import train as TT
from tests.test_torch_dycore import to_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "inputs", "examples")
NPZ = os.path.join(EX, "supercell_kessler_example_weights.npz")
H5 = os.path.join(EX, "supercell_kessler_singlecell_model_weights.h5")
SCL_IN = os.path.join(EX, "supercell_kessler_input_scaling.txt")
SCL_OUT = os.path.join(EX, "supercell_kessler_output_scaling.txt")
FIELDS = ("temp", "density_dry", "water_vapor", "cloud_liquid",
          "precip_liquid")


def _carry(jmodel, dtype=torch.float32):
    return TM.mlp_from_numpy([(np.asarray(W), np.asarray(b))
                              for W, b in jmodel.weights], "cpu", dtype)


def _equal_weights(pmodel, jmodel):
    assert len(pmodel.weights) == len(jmodel.weights)
    for (pw, pb), (jw, jb) in zip(pmodel.weights, jmodel.weights):
        np.testing.assert_array_equal(pw.detach().numpy(), np.asarray(jw))
        np.testing.assert_array_equal(pb.detach().numpy(), np.asarray(jb))


def test_mlp_forward_matches_jax():
    """The same weights (a JAX init carried across) on the same inputs: f32,
    and f64 inputs through f32 weights (promoted by JAX, cast by the port)."""
    jm = JM.init_mlp((5, 10, 4), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(7, 3, 5))
    pm = _carry(jm)
    want = np.asarray(jm(jnp.asarray(x, jnp.float32)))
    got = pm(torch.as_tensor(x, dtype=torch.float32)).detach().numpy()
    assert got.shape == (7, 3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(jm(jnp.asarray(x, jnp.float64)))
    got = pm.double()(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-16)
    assert float(TM.leaky_relu(torch.tensor(-2.0))) == pytest.approx(-0.2)
    assert float(TM.leaky_relu(torch.tensor(3.0))) == 3.0
    assert pm.describe() == jm.describe()
    pm.validate()


def test_mlp_validate_rejects_mismatch():
    bad = [(np.zeros((5, 10)), np.zeros(10)), (np.zeros((9, 4)), np.zeros(4))]
    with pytest.raises(ValueError, match="10 outputs vs 9 inputs"):
        TM.mlp_from_numpy(bad, "cpu").validate()
    with pytest.raises(ValueError, match="mismatch"):
        TM.mlp_from_numpy([(np.zeros((5, 10)), np.zeros(4))], "cpu").validate()


def test_npz_round_trip_across_packages(tmp_path):
    """A model saved by either package loads in the other, bit for bit."""
    jm = JM.init_mlp((5, 10, 4), jax.random.PRNGKey(3))
    JM.save_mlp(str(tmp_path / "j.npz"), jm)
    pm = TM.load_mlp(str(tmp_path / "j.npz"))
    _equal_weights(pm, jm)
    TM.save_mlp(str(tmp_path / "p.npz"), pm)
    _equal_weights(pm, JM.load_mlp(str(tmp_path / "p.npz")))
    pm64 = TM.load_mlp(str(tmp_path / "p.npz"), dtype=torch.float64)
    assert pm64.W[0].dtype == torch.float64


def test_keras_h5_equals_npz_and_jax():
    """The shipped Keras HDF5 holds the same arrays as the shipped .npz, and
    both packages read it alike."""
    h5 = TM.load_keras_h5(H5)
    npz = TM.load_mlp(NPZ)
    for (a, b), (c, d) in zip(h5.weights, npz.weights):
        assert torch.equal(a, c) and torch.equal(b, d)
    _equal_weights(h5, JM.load_keras_h5(H5))
    assert [tuple(W.shape) for W in h5.W] == [(5, 10), (10, 4)]


def test_load_keras_h5_without_h5py(monkeypatch):
    """Without h5py the HDF5 loader raises, naming the .npz alternative."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="nn_weights"):
        TM.load_keras_h5(H5)


def test_scaling_tables_match_jax(tmp_path):
    for path, n in ((SCL_IN, 5), (SCL_OUT, 4)):
        p = TM.load_scaling(path, n)
        assert p.shape == (n, 2) and p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(),
                                      np.asarray(JM.load_scaling(path, n)))
        assert (p[:, 1] > p[:, 0]).all()
    t = np.random.default_rng(0).normal(size=(5, 2))
    TM.save_scaling(str(tmp_path / "s.txt"), torch.as_tensor(t))
    np.testing.assert_array_equal(
        TM.load_scaling(str(tmp_path / "s.txt"), 5, torch.float64).numpy(), t)


def test_init_mlp_seeded_uniform():
    """RandomUniform(-scale, scale) from the caller's generator: the same
    seed gives the same weights."""
    a = TM.init_mlp((5, 10, 4), torch.Generator().manual_seed(7), scale=0.05)
    b = TM.init_mlp((5, 10, 4), torch.Generator().manual_seed(7), scale=0.05)
    for (wa, ba), (wb, bb) in zip(a.weights, b.weights):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
        assert wa.abs().max() <= 0.05 and wa.abs().max() > 0.03
    assert [tuple(W.shape) for W in a.W] == [(5, 10), (10, 4)]
    a.validate()


def _fields(seed, shape=(2, 6, 3, 5)):
    """Before/after fields with changes on both sides of the 1e-10
    activity tolerance."""
    rng = np.random.default_rng(seed)
    before = {n: rng.uniform(0.0, 1e-3, shape) for n in FIELDS}
    after = {}
    for n, v in before.items():
        step = rng.choice([0.0, 5e-11, 2e-10, 1e-6], size=shape,
                          p=[0.6, 0.2, 0.1, 0.1])
        after[n] = v + step * rng.choice([-1.0, 1.0], size=shape)
    return before, after


def _as(fields, conv):
    return {k: conv(v) for k, v in fields.items()}


def test_is_active_mask_matches_jax():
    before, after = _fields(0)
    want = np.asarray(JD.is_active_mask(_as(before, jnp.asarray),
                                        _as(after, jnp.asarray)))
    got = TD.is_active_mask(_as(before, torch.as_tensor),
                            _as(after, torch.as_tensor))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    assert not TD.is_active_mask(_as(before, torch.as_tensor),
                                 _as(before, torch.as_tensor)).any()


@pytest.mark.parametrize("seed", [0, 11])
def test_select_samples_matches_jax(seed):
    """With the uniforms the JAX package draws for ``seed``, the port picks
    the same cells."""
    before, after = _fields(seed, shape=(1, 10, 8, 16))
    active = np.asarray(JD.is_active_mask(_as(before, jnp.asarray),
                                          _as(after, jnp.asarray)))
    kw = dict(ratio_active=0.3, samples_per_step=300.0)
    want = np.asarray(JD._select_samples(jnp.asarray(active), seed, **kw))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), active.shape))
    got = TD.select_samples(torch.tensor(active), torch.tensor(u), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@functools.lru_cache(maxsize=None)
def _micro_states():
    """(before, after, dt) of the Kessler step on a 16x8x10 f64
    supercell, after one dycore step, as JAX states."""
    cfg = jax_config(dict(
        sim_time=100.0, nens=1, nx_glob=16, ny_glob=8, nz=10, xlen=40000.0,
        ylen=40000.0, zlen=10000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0, dtype="float64"))
    state, mods, dycore = jax_build(cfg)
    dt = float(dycore.compute_time_step(state))
    before = mods[0](state, dt)
    return before, mods[1](before, dt), dt


def test_data_generator_rows_match_jax(tmp_path, monkeypatch):
    """The same selection mask gives the same rows (in np.argwhere's order,
    the k+1 column clamped at the top, rho_d skipped) and metadata; each
    package's NetCDF reads back to the same arrays in both."""
    monkeypatch.chdir(tmp_path)
    jb, ja, dt = _micro_states()
    mask = np.random.default_rng(5).random(jb["temp"].shape) < 0.15
    mask[0, -1, 0, :3] = True  # top level: the k+1 row repeats k
    monkeypatch.setattr(JD, "_select_samples",
                        lambda active, seed, **kw: jnp.asarray(mask))
    monkeypatch.setattr(TD, "select_samples",
                        lambda active, u, **kw: torch.as_tensor(mask))
    jgen = JD.DataGenerator(fname=str(tmp_path / "j.nc"))
    pgen = TD.DataGenerator(fname=str(tmp_path / "p.nc"))
    jgen.init(jb)
    pgen.init(to_port(jb))
    for _ in range(2):
        assert (pgen.generate_samples_stencil(to_port(jb), to_port(ja), dt,
                                              1.0)
                == jgen.generate_samples_stencil(jb, ja, dt, 1.0)
                == mask.sum())
    assert pgen.meta == jgen.meta
    for p, j in ((pgen._inputs, jgen._inputs), (pgen._outputs, jgen._outputs)):
        np.testing.assert_array_equal(np.concatenate(p), np.concatenate(j))
    assert np.concatenate(pgen._inputs).dtype == np.float32
    paths = (pgen.finalize(), jgen.finalize())
    reads = [load(path) for path in paths
             for load in (TD.load_dataset, JD.load_dataset)]
    for inputs, outputs, meta in reads[1:]:
        np.testing.assert_array_equal(inputs, reads[0][0])
        np.testing.assert_array_equal(outputs, reads[0][1])
        assert meta == reads[0][2]
    assert reads[0][0].shape == (2 * mask.sum(), 5, 2)
    with open(tmp_path / "supercell_kessler_metadata.txt") as f:
        assert f.read().startswith("This dataset contains data")


def test_data_generator_draws_from_its_seed(tmp_path, monkeypatch):
    """The port's own selection: uniforms from a generator on the state's
    device seeded seed + step, so a run repeats; a .npz dataset loads."""
    monkeypatch.chdir(tmp_path)
    jb, ja, dt = _micro_states()
    runs = []
    for _ in range(2):
        gen = TD.DataGenerator(samples_per_step=200.0, seed=3)
        gen.init(to_port(jb))
        n = [gen.generate_samples_stencil(to_port(jb), to_port(ja), dt, 1.0)
             for _ in range(2)]
        runs.append((n, np.concatenate(gen._inputs)))
    assert runs[0][0] == runs[1][0] and min(runs[0][0]) > 0
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.savez(tmp_path / "d.npz", inputs=runs[0][1],
             outputs=runs[0][1][:, :4, 0], dx=1.5)
    inputs, outputs, meta = TD.load_dataset(str(tmp_path / "d.npz"))
    np.testing.assert_array_equal(inputs, runs[0][1])
    assert meta == {"dx": 1.5}


def test_statistics_gatherer_matches_jax(capsys):
    """The active ratio over several steps, and the 200 s print."""
    jg, pg = JD.StatisticsGatherer(), TD.StatisticsGatherer()
    for step, etime in enumerate((100.0, 199.0, 250.0, 420.0)):
        before, after = _fields(20 + step)
        jg.gather(_as(before, jnp.asarray), _as(after, jnp.asarray), 1.0,
                  etime)
        jout = capsys.readouterr().out
        pg.gather(_as(before, torch.as_tensor), _as(after, torch.as_tensor),
                  1.0, etime)
        assert capsys.readouterr().out == jout
    assert (pg.numer, pg.denom, pg.num_out) == (jg.numer, jg.denom,
                                                jg.num_out)
    assert pg.ratio_active == jg.ratio_active and 0 < pg.ratio_active < 1
    pg.finalize()
    assert "*** Ratio Active ***" in capsys.readouterr().out


def test_nadam_update_matches_optax():
    """Three optax.nadam(1e-3) steps in f32 against nadam_update."""
    rng = np.random.default_rng(2)
    shapes = ((5, 10), (10,), (10, 4), (4,))
    params = [rng.normal(0, 0.05, s).astype(np.float32) for s in shapes]
    opt = optax.nadam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    jstate = opt.init(jp)
    tp = [torch.tensor(p) for p in params]
    tstate = TT.nadam_init(tp)
    for step in range(3):
        grads = [rng.normal(0, 10.0 ** -step, s).astype(np.float32)
                 for s in shapes]
        updates, jstate = opt.update([jnp.asarray(g) for g in grads], jstate,
                                     jp)
        jp = optax.apply_updates(jp, updates)
        TT.nadam_update(tp, [torch.tensor(g) for g in grads], tstate, 1e-3)
        for a, b in zip(tp, jp):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    assert tstate["count"] == 3


def _dataset(n=2000, seed=4):
    """Stencil rows whose outputs are a smooth function of column 0."""
    rng = np.random.default_rng(seed)
    inputs = rng.uniform(0.0, 1.0, (n, 5, 2)).astype(np.float32)
    inputs[:, 0] = 250.0 + 50.0 * inputs[:, 0]
    x = inputs[:, :, 0]
    outputs = np.stack([x[:, 0] + 0.5 * x[:, 2], x[:, 2] * x[:, 3],
                        np.sin(3 * x[:, 3]), x[:, 4] ** 2], 1)
    return inputs, outputs.astype(np.float32)


def test_minmax_normalize_matches_jax():
    inputs, outputs = _dataset(300)
    x = inputs[:, :, 0]
    t = TT.minmax_table(x)
    np.testing.assert_array_equal(t, JT.minmax_table(x))
    xn = TT.normalize(torch.as_tensor(x), t)
    np.testing.assert_allclose(xn.numpy(),
                               np.asarray(JT.normalize(jnp.asarray(x), t)),
                               rtol=1e-6, atol=1e-7)
    back = TT.denormalize(xn, t)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
    flat = np.ones((4, 2), np.float32)
    assert (TT.minmax_table(flat)[:, 1] == 2.0).all()


def test_train_mlp_matches_jax():
    """Two epochs from the JAX package's own starting weights (its
    init_mlp with PRNGKey(seed), carried across): the same shuffles, loss
    and optimizer give the same history and weights."""
    inputs, outputs = _dataset()
    kw = dict(hidden=10, epochs=2, batch=256, seed=0, verbose=False)
    jm, jsi, jso, jh = JT.train_mlp(inputs, outputs, **kw)
    init = _carry(JM.init_mlp((5, 10, 4), jax.random.PRNGKey(0)))
    pm, psi, pso, ph = TT.train_mlp(inputs, outputs, device="cpu",
                                    init=init, **kw)
    np.testing.assert_array_equal(psi, jsi)
    np.testing.assert_array_equal(pso, jso)
    assert len(ph) == len(jh) == 2 and ph[1]["loss"] < ph[0]["loss"]
    for a, b in zip(ph, jh):
        assert a["epoch"] == b["epoch"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-5)
    for p, j in zip((w for wb in pm.weights for w in wb),
                    (w for wb in jm.weights for w in wb)):
        j = np.asarray(j)
        np.testing.assert_allclose(p.detach().numpy(), j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max())
    # the starting model is copied, not trained in place
    assert torch.equal(init.W[0], _carry(JM.init_mlp(
        (5, 10, 4), jax.random.PRNGKey(0))).W[0])


def test_train_main_writes_artifacts(tmp_path, monkeypatch, capsys):
    """python -m miniweatherml_tpu_torch.ml.train's three artifacts, which
    the surrogate loaders read back."""
    monkeypatch.chdir(tmp_path)
    inputs, outputs = _dataset(600)
    np.savez(tmp_path / "d.npz", inputs=inputs, outputs=outputs, dz=500.0)
    TT.main([str(tmp_path / "d.npz"), "m", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dataset: 600 samples" in out and "epoch 9:" in out
    model = TM.load_mlp("m_weights.npz")
    model.validate()
    assert TM.load_scaling("m_input_scaling.txt", 5).shape == (5, 2)
    assert TM.load_scaling("m_output_scaling.txt", 4).shape == (4, 2)


def test_workflow_end_to_end(tmp_path, monkeypatch):
    """Harvest -> train -> deploy on the port alone, at the size of the JAX
    package's own loop (tests/test_ml.py): a 50x1x20 f32 supercell for 6 s,
    training for 3 epochs, then one online step with the trained model."""
    from miniweatherml_tpu_torch.experiments.generate_micro_data import \
        run_generate_micro_data
    from miniweatherml_tpu_torch.experiments.inference_surrogate import build
    from miniweatherml_tpu_torch.physics.kessler_surrogate import \
        MicrophysicsKesslerSurrogate

    tracked = [os.path.join(REPO, n) for n in (
        "supercell_kessler_data_task_0.nc", "supercell_kessler_metadata.txt")]
    before = [open(p, "rb").read() for p in tracked]
    monkeypatch.chdir(tmp_path)
    cfg = config_from_dict(dict(
        sim_time=6.0, nens=1, nx_glob=50, ny_glob=1, nz=20, xlen=100000.0,
        ylen=100000.0, zlen=20000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0))
    gen = TD.DataGenerator(fname=str(tmp_path / "data.nc"),
                           samples_per_step=400.0)
    _, gen = run_generate_micro_data(cfg, "cpu", quiet=True, generator=gen)
    assert gen.num_samples > 100
    inputs, outputs, meta = TD.load_dataset(str(tmp_path / "data.nc"))
    assert inputs.shape == (gen.num_samples, 5, 2)
    assert outputs.shape == (gen.num_samples, 4)
    assert meta["dz"] == pytest.approx(1000.0)

    model, scl_in, scl_out, hist = TT.train_mlp(
        inputs, outputs, device="cpu", epochs=3, batch=256, verbose=False)
    assert hist[-1]["loss"] < hist[0]["loss"] * 1.5
    model.validate()

    micro = MicrophysicsKesslerSurrogate(model, scl_in, scl_out, online=True,
                                         compare=True)
    state, mods, dycore = build(cfg, "cpu", micro=micro)
    dt = dycore.compute_time_step(state)
    state = mods[1](mods[0](state, dt), dt)
    assert state.validate() == {}
    assert torch.isfinite(state["surrogate_diffs"]).all()
    # the harvest wrote into the working directory, not over the repo's
    # tracked dataset and sidecar
    assert (tmp_path / "supercell_kessler_metadata.txt").exists()
    assert [open(p, "rb").read() for p in tracked] == before


def test_gather_statistics_ratio():
    from miniweatherml_tpu_torch.experiments.gather_statistics import \
        run_gather_statistics
    cfg = config_from_dict(dict(
        sim_time=4.0, nens=1, nx_glob=50, ny_glob=1, nz=20, xlen=100000.0,
        ylen=100000.0, zlen=20000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0))
    state, gatherer = run_gather_statistics(cfg, "cpu", quiet=True)
    assert 0.0 <= gatherer.ratio_active <= 1.0 and gatherer.denom > 0
    assert state.validate() == {}


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (a source search; test_torch_dycore.py imports them all)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|miniweatherml_tpu)\b"
                     r"(?!_torch)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "miniweatherml_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = []
    for path in files:
        with open(path) as f:
            bad += [(path, m.group(0)) for m in pat.finditer(f.read())]
    assert not bad, bad
