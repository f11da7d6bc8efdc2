"""The port's spans, counters, section timers and traces
(``utils/profiling.py``) on the CPU, beside the JAX package's; the spans
and device counters of a chain step; the surrogate's per-form launch
counters; and the benchmark's metrics that read them."""

import contextlib
import ctypes
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from miniweatherml_tpu.utils import profiling as JPR
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import (inference_surrogate,
                                                 supercell_example,
                                                 supercell_p3)
from miniweatherml_tpu_torch.physics import kessler as PK
from miniweatherml_tpu_torch.physics import kessler_surrogate_cuda as KSC
from miniweatherml_tpu_torch.physics import p3 as PP
from miniweatherml_tpu_torch.utils import profiling as PR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the benchmark harness's own span names (benchmark/trace.py, the cells'
# "modules"), which no program span may take
HARNESS_SPANS = {"window", "dycore", "micro", "sponge", "nudge"}
CHAINS = ("kessler", "p3")
# the chains whose micro module keeps a span: the online surrogate too
SPAN_CHAINS = CHAINS + ("surrogate",)
MICRO = {"kessler": "kessler.step", "p3": "p3.step",
         "surrogate": "surrogate.step"}
FORMS = ("surrogate_forward.fixed_launches",
         "surrogate_forward.general_launches")
EX = os.path.join(ROOT, "inputs", "examples")
# span -> (calls in one step at one CFL cycle, parent)
DYCORE_SPANS = {"dycore.step": (1, None),
                "dycore.to_dynamics": (1, "dycore.step"),
                "dycore.prim": (3, "dycore.step"),
                "dycore.to_coupler": (1, "dycore.step")}


def test_timer_accumulates_and_reports():
    PR.reset_timers()
    with PR.timer("section_a"):
        x = torch.ones(64, 64) * 2.0
    with PR.timer("section_a", sync_result=x):
        x = x + 1.0
    with PR.timer("section_b", sync_result={"x": x, "n": 3}):
        pass
    totals = PR.timer_totals()
    assert totals["section_a"][1] == 2 and totals["section_b"][1] == 1
    assert totals["section_a"][0] > 0.0
    lines = PR.timer_report().splitlines()
    assert lines[1].split()[0] == "section_a" and lines[1].split()[2] == "2"
    PR.reset_timers()
    assert PR.timer_totals() == {}


def test_report_header_equals_jax():
    PR.reset_timers()
    JPR.reset_timers()
    assert PR.timer_report() == JPR.timer_report()


def test_annotate_and_trace_write_a_file(tmp_path):
    """A span names its region in the profiler's trace (the JAX package's
    ``annotate``), which ``trace`` writes to a file."""
    PR.reset()
    logdir = str(tmp_path / "trace")
    with PR.trace(logdir) as prof:
        with PR.span("weno_recon"):
            y = torch.zeros(8) + 1.0
    assert float(y.sum()) == 8.0
    names = {e.key for e in prof.key_averages()}
    assert "weno_recon" in names
    assert PR.read()["spans"]["weno_recon"]["calls"] == 1
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(logdir, files[0])) > 0
    PR.sync()
    PR.sync(y)
    PR.reset()


# -- the registry ---------------------------------------------------------------

def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_registry_without_a_profiler_counts_on_the_host_only():
    """Without a profiler session a span and a device counter record
    nothing; a host counter always counts; ``reset`` clears them."""
    PR.reset()
    with PR.span("a"):
        PR.count_device("d", torch.tensor(2))
        PR.count("h")
        PR.count("h", 4)
    assert PR.counter("h") == 5 and PR.counter("never") == 0
    assert PR.read() == {"spans": {}, "counters": {"h": {"total": 5,
                                                         "calls": 2}}}
    PR.reset()
    assert PR.read() == {"spans": {}, "counters": {}}


def test_registry_under_a_profiler_keeps_spans_and_device_counts():
    """Under a profiler: calls, host time, parents (per thread), device
    counts resolved at ``read``, which repeats its totals."""
    PR.reset()
    with _profile():
        for k in range(2):
            with PR.span("outer"):
                with PR.span("inner"):
                    PR.count_device("d", torch.tensor(k + 2))
    got = PR.read()
    assert got == PR.read()
    assert set(got["spans"]) == {"outer", "inner"}
    outer, inner = got["spans"]["outer"], got["spans"]["inner"]
    assert (outer["calls"], outer["parent"]) == (2, None)
    assert (inner["calls"], inner["parent"]) == (2, "outer")
    assert outer["host_ms"] >= inner["host_ms"] > 0.0
    assert outer["device_ms"] is None and inner["device_ms"] is None
    assert got["counters"] == {"d": {"total": 5, "calls": 2}}
    PR.reset()


# -- a chain step ------------------------------------------------------------------

def _chain(chain):
    cfg = config_from_dict(dict(
        sim_time=10.0, nx_glob=12, ny_glob=8, nz=16, xlen=40000.0,
        ylen=40000.0, zlen=16000.0, init_data="supercell",
        dtype="float64",
        nn_weights=os.path.join(EX, "supercell_kessler_example_weights.npz"),
        nn_input_scaling=os.path.join(EX,
                                      "supercell_kessler_input_scaling.txt"),
        nn_output_scaling=os.path.join(
            EX, "supercell_kessler_output_scaling.txt"),
        surrogate_online=True, surrogate_compare=False))
    if chain == "surrogate":
        state, mods, dycore = inference_surrogate.build(cfg, "cpu")
    elif chain == "kessler":
        state, mods, dycore = supercell_example.build(cfg, "cpu")
        rain = 0.002 * state["density_dry"]
        rain[:, 8:] = 0.0
        state = state.replace_fields(precip_liquid=rain)
    else:
        state, mods, dycore = supercell_p3.build(cfg, "cpu")
        state = supercell_p3.seed_layers(state)
    return state, mods, dycore.compute_time_step(state)


@pytest.mark.parametrize("chain", SPAN_CHAINS)
def test_chain_step_without_a_profiler_records_no_span(chain):
    state, mods, dt = _chain(chain)
    PR.reset()
    for m in mods:
        state = m(state, dt)
    got = PR.read()
    assert got["spans"] == {}
    assert not {"kessler.subcycles", "p3.sed_substeps", *FORMS} & set(
        got["counters"])


@pytest.mark.parametrize("chain", SPAN_CHAINS)
def test_chain_step_spans_under_a_profiler(chain):
    """One step with each module in a span of the harness's name, as the
    benchmark steps it: every program span with its calls and parent, no
    device time on the CPU, each on the profiler's timeline inside its
    parent (a module span inside the harness's) as a CPU op, none with a
    harness name."""
    state, mods, dt = _chain(chain)
    PR.reset()
    with _profile() as prof:
        for name, m in zip(("dycore", "micro", "sponge", "nudge"), mods):
            with torch.profiler.record_function(name):
                state = m(state, dt)
    spans = PR.read()["spans"]
    want = {**DYCORE_SPANS, MICRO[chain]: (1, None),
            "sponge.step": (1, None), "nudge.step": (1, None)}
    assert {k: (v["calls"], v["parent"]) for k, v in spans.items()} == want
    assert all(v["device_ms"] is None and v["host_ms"] > 0.0
               for v in spans.values())
    assert not HARNESS_SPANS & set(spans)
    harness_of = {"dycore.step": "dycore", MICRO[chain]: "micro",
                  "sponge.step": "sponge", "nudge.step": "nudge"}
    seen = {}
    for e in prof.events():
        if e.name in want:
            seen[e.name] = seen.get(e.name, 0) + 1
            parent = want[e.name][1] or harness_of[e.name]
            assert e.cpu_parent is not None, e.name
            assert e.cpu_parent.name == parent, (e.name, e.cpu_parent.name)
            assert (e.cpu_parent.time_range.start <= e.time_range.start
                    and e.time_range.end <= e.cpu_parent.time_range.end)
    assert seen == {k: v[0] for k, v in want.items()}
    # CPU ops, not user annotations, which the profiler would mirror on a
    # card's timeline as device events
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name() in want}
    assert kinds == {"cpu_op"}
    PR.reset()


@pytest.mark.parametrize("chain", CHAINS)
def test_sub_step_counters_equal_the_plain_paths(chain, monkeypatch):
    """kessler.subcycles and p3.sed_substeps hold the counts the plain
    path reads on the host (Kessler's sub-cycles, P3's sedimentation
    sub-steps), on a long micro step over rain that takes several."""
    state, mods, _ = _chain(chain)
    host = []
    if chain == "kessler":
        real = PK.kessler_step

        def spy(*a):
            host.append(int(a[5]))
            return real(*a)
        monkeypatch.setattr(PK, "kessler_step", spy)
        name = "kessler.subcycles"
    else:
        real = PP.host_ints

        def spy(t):
            host.append(real(t))
            return host[-1]
        monkeypatch.setattr(PP, "host_ints", spy)
        name = "p3.sed_substeps"
    PR.reset()
    with _profile():
        for dt in (10.0, 400.0):
            state = mods[1](state, dt)
    counted = PR.read()["counters"][name]
    assert len(host) == counted["calls"] == 2
    assert counted["total"] == sum(host) and max(host) > 1
    PR.reset()


# -- the surrogate's launches by kernel form ------------------------------------------

class _Entry:
    """An entry point of a stand-in library: a Python callable that, like
    a ctypes function, takes the argument and result types declared on
    it."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class _StandInLibrary:
    """The surrogate's CUDA library as ``_launch`` calls it, on host memory:
    each call writes the plain forward's outputs through the pointers it is
    given, so the chain runs on and its result shows that ``_launch``
    passed the fields and outputs in their order."""

    def __init__(self):
        self.forms = []
        self.surrogate_scratch = _Entry(lambda nlayers, wid, item: 0)
        self.surrogate_forward_f64 = _Entry(self._forward)

    def __getattr__(self, name):
        # the entries the chain never calls fail the test if it does
        if name.startswith("_"):
            raise AttributeError(name)
        return _Entry(lambda *args: pytest.fail(f"{name} called"))

    def _forward(self, ptrs, optrs, params, nparams, nlayers, wid, n, form,
                 scratch, nscratch, stream):
        def view(ptr, count):
            return torch.from_numpy(np.ctypeslib.as_array(
                (ctypes.c_double * count).from_address(ptr)))
        self.forms.append(form)
        widths = tuple(wid[i] for i in range(nlayers + 1))
        outs = KSC.surrogate_forward_plain(
            *(view(ptrs[i], n) for i in range(KSC.NIN)),
            view(params, nparams), widths)
        for i, o in enumerate(outs):
            view(optrs[i], n).copy_(o)
        return 0


@contextlib.contextmanager
def _stand_in(monkeypatch):
    """The surrogate's wrapper on a ``_StandInLibrary`` inside the block,
    with CPU tensors taken for CUDA ones."""
    lib = _StandInLibrary()
    monkeypatch.setattr(KSC, "on_cuda", lambda t: True)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    with KSC.LIBRARY.use(lib):
        yield lib


@pytest.mark.parametrize("profiled", [False, True])
def test_the_fixed_form_counts_once_a_step_on_the_online_chain(
        profiled, monkeypatch):
    """Two steps of the online chain through ``_launch``: the shipped
    5-10-4 model takes the fixed form once a step.  Under a profiler
    session ``surrogate_forward.fixed_launches`` counts each launch and
    ``.general_launches`` stays absent; without one neither is kept (one
    flag check), while ``surrogate_forward.launches`` counts either way.
    The chain's state equals the plain path's."""
    state, mods, dt = _chain("surrogate")
    plain = state
    for _ in range(2):
        for m in mods:
            plain = m(plain, dt)
    PR.reset()
    with _stand_in(monkeypatch) as lib, \
            _profile() if profiled else contextlib.nullcontext():
        for _ in range(2):
            for m in mods:
                state = m(state, dt)
    counters = PR.read()["counters"]
    assert lib.forms == [KSC._FORMS["fixed"]] * 2
    assert counters["surrogate_forward.launches"]["total"] == 2
    if profiled:
        assert counters[FORMS[0]] == {"total": 2, "calls": 2}
        assert FORMS[1] not in counters
    else:
        assert not set(FORMS) & set(counters)
    for name in ("temp", "water_vapor", "cloud_liquid", "precip_liquid",
                 "wvel"):
        assert torch.equal(state[name], plain[name]), name
    PR.reset()


def test_a_model_of_other_widths_counts_the_general_form(monkeypatch):
    """A 5-17-4 model takes the general form, and under a profiler session
    counts under ``surrogate_forward.general_launches``."""
    state, mods, dt = _chain("surrogate")
    micro = mods[1].__self__
    g = torch.Generator().manual_seed(3)
    micro.model = type(micro.model)(
        [(torch.rand(a, b, generator=g) * 0.2 - 0.1,
          torch.rand(b, generator=g) * 0.2 - 0.1)
         for a, b in ((5, 17), (17, 4))])
    micro._cast = None
    PR.reset()
    with _stand_in(monkeypatch) as lib, _profile():
        mods[1](state, dt)
    counters = PR.read()["counters"]
    assert lib.forms == [KSC._FORMS["general"]]
    assert counters[FORMS[1]]["total"] == 1 and FORMS[0] not in counters
    PR.reset()


# -- the benchmark's metrics that read the registry ----------------------------------

# metric -> (registry entries, per-step value); a stand-in trace of 4 steps
# whose Kessler, P3 and surrogate kernels ran 2 ms, 8 ms and 4 ms
MS = {"dycore.step": 400.0, "dycore.to_dynamics": 20.0, "dycore.prim": 36.0,
      "dycore.to_coupler": 28.0, "kessler.step": 10.0, "sponge.step": 12.0,
      "nudge.step": 8.0, "surrogate.step": 6.0}
METRICS = {
    "dycore_convert_ms_per_step": 12.0,
    "dycore_prim_ms_per_step": 9.0,
    "micro_glue_ms_per_step": 2.0,
    "sponge_nudge_ms_per_step": 5.0,
    "host_issue_ms_per_step": 2 * (400.0 + 10.0 + 12.0 + 8.0) / 4,
    "kessler_subcycles_per_step": 1.5,
    "p3_sed_substeps_per_step": 1.0,
    "surrogate_glue_ms_per_step": (6.0 - 4.0) / 4,
    "surrogate_general_launches_per_step": 0.5,
}


def _stand_in_trace():
    secs = {"kessler": 0.002, "p3": 0.008, "surrogate": 0.004}
    return SimpleNamespace(steps=4, family_seconds=lambda fam: secs[fam])


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_reads_none_from_an_empty_registry(metric):
    PR.reset()
    assert harness.load_metric(metric, ROOT).read(_stand_in_trace()) is None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_reads_a_registry_filled_by_hand(metric):
    """Device ms from each span's events, host ms twice the device's, the
    micro span less its kernels' time, device counts over the steps."""
    PR.reset()
    for name, ms in MS.items():
        parent = "dycore.step" if name.startswith("dycore.") and \
            name != "dycore.step" else None
        PR._spans[name] = [4, int(2e6 * ms), ms, parent]
    PR.count("kessler.subcycles", 6)
    PR.count("p3.sed_substeps", 4.0)
    PR.count(FORMS[0], 2)
    PR.count(FORMS[1], 2)
    got = harness.load_metric(metric, ROOT).read(_stand_in_trace())
    assert got == pytest.approx(METRICS[metric])
    PR.reset()


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_reads_none_from_a_program_without_the_registry(metric,
                                                                 monkeypatch):
    """An older program, whose profiling module has no ``read``: None, and
    no error."""
    monkeypatch.delattr(PR, "read")
    assert harness.load_metric(metric, ROOT).read(_stand_in_trace()) is None
