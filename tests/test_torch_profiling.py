"""The port's section timers, region names and traces
(``utils/profiling.py``) on the CPU, beside the JAX package's."""

import os

import torch

from miniweatherml_tpu.utils import profiling as JPR
from miniweatherml_tpu_torch.utils import profiling as PR


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
    logdir = str(tmp_path / "trace")
    with PR.trace(logdir) as prof:
        with PR.annotate("weno_recon"):
            y = torch.zeros(8) + 1.0
    assert float(y.sum()) == 8.0
    names = {e.key for e in prof.key_averages()}
    assert "weno_recon" in names
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(logdir, files[0])) > 0
    PR.sync()
    PR.sync(y)
