"""A canned profile gives the expected per-layer numbers."""

from types import SimpleNamespace

import pytest

from benchmark import harness, work
from benchmark.trace import Trace

MS = 1_000_000  # ns


def _canned():
    """Two steps in a 100 ms window: per step a 20 ms flux kernel, a 5 ms
    FCT kernel, a 1 ms Kessler kernel and two 2 ms glue kernels; 10 ms of
    the window idle, 6 ms of it inside the "micro" span."""
    ev = [("window", False, 0, 100 * MS)]
    t = 0
    for _ in range(2):
        ev.append(("dycore", False, t, t + 30 * MS))
        ev.append(("void fluxes_x<5, float, 3>(float const*)", True, t,
                   t + 20 * MS))
        ev.append(("void fct_scale_div_kernel<float>()", True, t + 20 * MS,
                   t + 25 * MS))
        ev.append(("void at::native::elementwise_kernel<128>()", True,
                   t + 25 * MS, t + 27 * MS))
        ev.append(("void at::native::reduce_kernel<512>()", True,
                   t + 27 * MS, t + 29 * MS))
        ev.append(("micro", False, t + 29 * MS, t + 40 * MS))
        ev.append(("void kessler_kernel<float>()", True, t + 32 * MS,
                   t + 33 * MS))
        ev.append(("sponge", False, t + 40 * MS, t + 45 * MS))
        ev.append(("Memcpy DtoD (Device -> Device)", True, t + 40 * MS,
                   t + 45 * MS))
        ev.append(("nudge", False, t + 45 * MS, t + 50 * MS))
        ev.append(("void at::native::elementwise_kernel<4>()", True,
                   t + 45 * MS, t + 49 * MS))
        t += 50 * MS
    grid = SimpleNamespace(nens=1, nz=64, ny=512, nx=512)
    ctx = dict(cfg={"dycore": {"ord": 5}}, grid=grid, dtype="float32",
               ntr=3)
    return Trace(ev, {"dycore", "micro", "sponge", "nudge"}, 2,
                 [48.0, 50.0], ctx)


def metric(name, tr, root):
    return harness.load_metric(name, root).read(tr)


def test_families_and_idle(root):
    tr = _canned()
    assert metric("flux_ms_per_step", tr, root) == pytest.approx(20.0)
    assert metric("fct_ms_per_step", tr, root) == pytest.approx(5.0)
    assert metric("kessler_ms_per_step", tr, root) == pytest.approx(1.0)
    assert metric("p3_ms_per_step", tr, root) is None
    # glue: two kernels of 2 ms, a copy of 5 ms and one of 4 ms a step
    assert metric("glue_ms_per_step", tr, root) == pytest.approx(13.0)
    assert metric("glue_launches_per_step", tr, root) == pytest.approx(4.0)
    # busy 20+5+2+2+1+5+4 = 39 ms a step of 50
    assert tr.busy_s == pytest.approx(0.078)
    assert metric("device_idle_pct", tr, root) == pytest.approx(22.0)
    assert metric("step_ms_p95", tr, root) == pytest.approx(49.9)


def test_rooflines_and_mfu(root):
    tr = _canned()
    least, ops = work.flux_step(8, (1, 64, 512, 512), 5, "float32")
    assert metric("flux_roofline", tr, root) == pytest.approx(
        100.0 * least / 0.020)
    fct = work.fct_step(3, (1, 64, 512, 512), "float32")
    assert metric("fct_roofline", tr, root) == pytest.approx(
        100.0 * fct / 0.005)
    k = work.kessler_step_ops((1, 64, 512, 512))
    assert metric("step_mfu", tr, root) == pytest.approx(
        100.0 * (ops + k) * 2 / 0.1 / 67e12)


def test_breakdown_names_the_host_span_of_each_gap():
    tr = _canned()
    gaps = dict((round(s * 1e3, 6), n) for n, s in tr.idle_gaps())
    # 29-32 ms and 33-40 ms lie in "micro", 49-50 ms in "nudge"
    assert gaps[7.0] == "micro" and gaps[3.0] == "micro"
    assert gaps[1.0] == "nudge"
    top = tr.top_ops(3)
    assert top[0][0].startswith("void fluxes_x") and \
        top[0][1] == pytest.approx(0.040)


def test_a_layer_that_did_not_run_reads_nothing(root):
    tr = _canned()
    tr.device_ops = [e for e in tr.device_ops if "fluxes" not in e[0]]
    assert metric("flux_roofline", tr, root) is None
    assert metric("flux_ms_per_step", tr, root) is None
    assert metric("step_mfu", tr, root) is None


class _Event:
    """A profiler event of either binding: with or without
    ``activity_type``."""

    def __init__(self, name, on_dev, kind=None):
        self._n, self._d, self._k = name, on_dev, kind
        if kind is not None:
            self.activity_type = lambda: self._k

    def name(self):
        return self._n

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)


@pytest.mark.parametrize("typed", [True, False])
def test_event_kinds_in_both_bindings(typed):
    from benchmark.trace import _kind
    spans = {"window", "dycore"}
    cases = [("void fluxes_x<5>()", True, "kernel", "device"),
             ("Memcpy DtoD (Device -> Device)", True, "gpu_memcpy", "device"),
             ("dycore", True, "gpu_user_annotation", None),
             ("dycore", False, "user_annotation", "span"),
             ("window", False, "user_annotation", "span"),
             ("aten::add", False, "cpu_op", None),
             ("cudaLaunchKernel", False, "cuda_runtime", None)]
    for name, on_dev, kind, want in cases:
        e = _Event(name, on_dev, kind if typed else None)
        assert _kind(e, spans) == want, (name, typed)
