"""The benchmark's online ML-surrogate cell, ``surrogate_cb1024``, on the
CPU: its plain reference (``benchmark/reference/micro_surrogate.py``)
against the port's forward pass, the cell end to end at a tiny grid, its
limits against planted faults, and its per-layer metrics."""

import ast
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import compare, harness, readings, work
from benchmark.reference import micro_surrogate as MS
from benchmark.trace import Trace
from miniweatherml_tpu_torch.ml.mlp import load_scaling
from miniweatherml_tpu_torch.physics.kessler_surrogate_cuda import (
    pack_mlp, surrogate_forward)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "inputs", "examples")
CELL = "surrogate_cb1024"
# a tiny grid at the cell's own spacing (800 m x 800 m x 200 m), so the
# CFL step is the cell's
TINY = dict(nx=16, ny=8, nz=100, xlen=16 * 800.0, ylen=8 * 800.0,
            zlen=20000.0)
METRICS = ("surrogate_ms_per_step", "surrogate_roofline",
           "surrogate_glue_ms_per_step", "surrogate_general_launches_per_step")

# The reference multiplies with torch.matmul, the port sums each output in
# order (k ascending, then the bias).  The normalised inputs lie in
# [-0.1, 1.1] and the weights in [-1, 1], so an output's at most 18 terms
# are O(1) and two summation orders differ by at most ~18 eps x their sum,
# under ~2e-5 (f32) and ~4e-14 (f64) of the output table's range.
TOL = {torch.float32: 2e-5, torch.float64: 4e-14}


def _tables(dtype):
    return (load_scaling(os.path.join(EX, "supercell_kessler_input_scaling"
                                      ".txt"), 5, torch.float64).to(dtype),
            load_scaling(os.path.join(EX, "supercell_kessler_output_scaling"
                                      ".txt"), 4, torch.float64).to(dtype))


def _random_model(widths, g):
    return [(torch.rand(a, b, generator=g, dtype=torch.float64) * 2 - 1,
             torch.rand(b, generator=g, dtype=torch.float64) * 2 - 1)
            for a, b in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("hidden", [10, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_forward_equals_the_ports(hidden, dtype):
    """``micro_surrogate.surrogate`` against the port's
    ``surrogate_forward`` (its plain version on the CPU) on seeded random
    5-10-4 and 5-17-4 models, inputs spread over the input table's range
    and a tenth beyond it on either side, so every clamp and both
    LeakyReLU branches are taken."""
    g = torch.Generator().manual_seed(100 + hidden)
    model = [(W.to(dtype), b.to(dtype))
             for W, b in _random_model((5, hidden, 4), g)]
    scl_in, scl_out = _tables(dtype)
    u = torch.rand((5, 2, 20, 8, 12), generator=g, dtype=torch.float64)
    lo, hi = scl_in[:, 0].double(), scl_in[:, 1].double()
    fields = [(lo[i] + (hi[i] - lo[i]) * (1.2 * u[i] - 0.1)).to(dtype)
              for i in range(5)]
    ref = MS.surrogate(fields, model, scl_in, scl_out)
    params, widths = pack_mlp(model, scl_in, scl_out)
    assert widths == (5, hidden, 4)
    got = surrogate_forward(*fields, params, widths)
    rng = scl_out[:, 1] - scl_out[:, 0]
    for j, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        assert (a - b).abs().max().item() <= TOL[dtype] * rng[j].item(), j
    for a in ref[1:]:
        assert a.min().item() == 0.0
    assert (ref[0] < scl_out[0, 0]).any() or (ref[0] > scl_out[0, 1]).any()


def test_reference_reads_the_configured_model_and_leaves_precl():
    """The reference's step reads the configuration's weights and tables
    from the checkout, replaces the four outputs with the prediction and
    keeps every other field, ``precl`` included."""
    cell = harness.Cell(CELL, ROOT, TINY)
    micro = MS.Micro(cell.cfg, ROOT, torch.float32, torch.device("cpu"))
    assert [tuple(W.shape) for W, _ in micro.weights] == [(5, 10), (10, 4)]
    shape = (1, TINY["nz"], TINY["ny"], TINY["nx"])
    g = torch.Generator().manual_seed(7)
    f = {n: (micro.scl_in[i, 0] + torch.rand(shape, generator=g)
             * (micro.scl_in[i, 1] - micro.scl_in[i, 0]))
         for i, n in enumerate(MS.INPUTS)}
    f.update(uvel=torch.ones(shape), precl=torch.full(shape[:1] + shape[2:],
                                                      2.0))
    out = micro.time_step(dict(f), 0.28, cell.grid)
    pred = MS.surrogate([f[n] for n in MS.INPUTS], micro.weights,
                        micro.scl_in, micro.scl_out)
    for n, p in zip(MS.OUTPUTS, pred):
        assert torch.equal(out[n], p)
    for n in ("density_dry", "uvel", "precl"):
        assert out[n] is f[n]


def test_reference_imports_no_jax_and_no_program():
    tree = ast.parse(open(MS.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "os", "numpy", "torch"}, names


def test_the_cell_runs_correct_on_the_cpu():
    res = harness.run(CELL, 4000000007, 0.2, False, time.perf_counter(),
                      device="cpu", grid_overrides=TINY, root=ROOT)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # the NN makes cloud water where the reference does too
    assert 0.0 < res["checks"]["cloud_liquid"]["value"]


def _micro(prog):
    return prog.names.index("micro")


def _skipped(prog):
    """The surrogate's step leaves the state as it was."""
    prog.mods[_micro(prog)] = lambda state, dt: state


def _off(name):
    def fault(prog):
        step = prog.mods[_micro(prog)]

        def altered(state, dt):
            new = step(state, dt)
            return new.replace_fields(**{name: new[name] * 1.001})
        prog.mods[_micro(prog)] = altered
    fault.__name__ = f"_{name}_off"
    return fault


def _kessler_kept(prog):
    """Online off: Kessler's result stays in place of the NN's (on this
    sub-saturated state with no hydrometeors Kessler changes nothing in two
    steps, while the NN changes every cell)."""
    micro = prog.mods[_micro(prog)].__self__
    micro.online, micro.compare = False, True


# Cloud water 0.1% off reads ~1e-3 by construction: the NN makes all of it
# from none, so the reference's change is the field itself.
FAULTS = (_skipped, _off("temp"), _off("water_vapor"), _kessler_kept)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_the_cells_limits_fail_a_planted_fault(fault):
    res = harness.run(CELL, 99, 0.1, False, time.perf_counter(),
                      device="cpu", grid_overrides=TINY, root=ROOT,
                      program_hook=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_bfloat16_control_fails_the_cells_limits():
    """The reference in bfloat16 in the program's place fails every limit
    but the exact ones (dt; precl, which neither side changes)."""
    gaps = readings.control_reading(CELL, 31, torch.device("cpu"), ROOT,
                                    TINY)
    ok, checks = compare.judge(gaps, compare.load_limits(ROOT, CELL))
    assert not ok
    assert {k for k, c in checks.items() if c["value"] > c["limit"]} == {
        "density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor",
        "cloud_liquid", "precip_liquid"}


def test_manifest_entries_of_the_cell():
    m = harness.load_manifest(ROOT)
    cell, entry, cfg, _ = harness.cell_files(m, CELL, ROOT)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "supercell_surrogate_cb1024", "supercell_seeded", 1)
    assert entry["reduced"] == ["sim_time"]
    assert (cfg["nx_glob"], cfg["ny_glob"], cfg["nz"], cfg["nens"]) == (
        1024, 1024, 100, 1)
    assert (cfg["xlen"], cfg["ylen"], cfg["zlen"]) == (819200, 819200,
                                                       20000)
    assert cfg["surrogate_online"] is True and \
        cfg["surrogate_compare"] is False
    assert {"surrogate_online", "nn_weights", "dtype"} <= set(cfg["assumed"])
    mine = [x for x in m["per_layer"] if CELL in x.get("workloads", ())]
    assert [x["name"] for x in mine] == list(METRICS)
    assert all(x["workloads"] == [CELL] and x["moves"] == "mcellups"
               for x in mine)


# -- per-layer metrics ----------------------------------------------------------

MS_NS = 1_000_000


def _trace(nsteps=2, kernel_ms=2.0, nx=512, ny=512, nz=64):
    """``nsteps`` steps in a window, each with a 10 ms flux kernel and a
    surrogate kernel of ``kernel_ms``."""
    ev = [("window", False, 0, 100 * MS_NS * nsteps)]
    for s in range(nsteps):
        t = 100 * MS_NS * s
        ev.append(("void fluxes_x<5, float, 3>()", True, t, t + 10 * MS_NS))
        ev.append(("void surrogate_fixed<float, 10>()", True, t + 20 * MS_NS,
                   t + 20 * MS_NS + int(kernel_ms * MS_NS)))
    cfg = harness.Cell(CELL, ROOT).cfg
    ctx = dict(cfg=cfg, grid=SimpleNamespace(nens=1, nz=nz, ny=ny, nx=nx),
               dtype="float32", ntr=3)
    return Trace(ev, {"dycore", "micro"}, nsteps, [100.0] * nsteps, ctx)


def test_surrogate_kernel_metrics_from_a_canned_trace():
    tr = _trace(kernel_ms=0.25)
    read = {n: harness.load_metric(n, ROOT).read for n in METRICS[:2]}
    assert read["surrogate_ms_per_step"](tr) == pytest.approx(0.25)
    # the bound at 512x512x64 f32 is PR 15's 0.180 ms, bytes
    least = 0.18029262
    assert read["surrogate_roofline"](tr) == pytest.approx(
        100.0 * least / 0.25, rel=1e-6)
    bare = Trace([("window", False, 0, 10)], set(), 1, [1.0], tr.context)
    assert read["surrogate_ms_per_step"](bare) is None
    assert read["surrogate_roofline"](bare) is None


def test_surrogate_work_counts_the_kernels_bytes_and_operations():
    mod = harness.load_metric("surrogate_roofline", ROOT)
    cells = 512 * 512 * 64
    assert mod.widths(os.path.join(EX, "supercell_kessler_example_weights"
                                   ".npz")) == [5, 10, 4]
    nbytes, ops = mod.surrogate_work([5, 10, 4], cells, "float32")
    # 36 B a cell and the 126 packed parameters; 211 operations a cell:
    # 10 normalising, 100 + 80 in the layers, 10 LeakyReLU, 8
    # denormalising, 3 clamps
    assert nbytes == 36 * cells + 4 * 126
    assert ops == 211 * cells
    assert work.bound_s(nbytes, ops, "float32") == pytest.approx(
        1.8029262e-4, rel=1e-6)
    nb64, _ = mod.surrogate_work([5, 17, 4], cells, "float64")
    assert nb64 == 72 * cells + 8 * (4 + 18 + 5 * 17 + 17 + 17 * 4 + 4)
