"""The harness end to end at a tiny CPU size, the command's refusals, and
the modules a run loads."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

from conftest import CELLS, size


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_reaches_its_line_without_card_metrics(root, cell, trace):
    res = harness.run(cell, 4000000001, 0.2, trace, time.perf_counter(),
                      device="cpu", grid_overrides=size(cell), root=root)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert res["device"]["memory_peak_bytes"] is None
    assert "busy_s" not in res["device"] and "breakdown" not in res
    assert list(res)[-1] == "checks"
    json.dumps(res)


def _cli(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_the_command_refuses_without_a_card(root):
    p = _cli(root, "--workload", "kessler_cb1024", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_refuses_without_the_program(root, tmp_path):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path, "--workload", "kessler_cb1024", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax(root):
    """A whole CPU run in a fresh process: no loaded module's top-level
    name is jax, jaxlib, flax or the JAX package's (compared whole: the
    port's name begins with the JAX package's)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run\n"
        "harness.run('p3_cb1024_layers', 7, 0.1, True, time.perf_counter(),"
        " device='cpu', grid_overrides=%r, root=%r)\n"
        "bad = run.forbidden_modules(list(sys.modules))\n"
        "assert 'miniweatherml_tpu_torch' in sys.modules\n"
        "print('BAD', bad)\n" % (root, dict(
            nx=12, ny=8, nz=20, xlen=9600.0, ylen=6400.0, zlen=20000.0),
            root))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "BAD []"


def test_forbidden_names_are_compared_whole():
    from benchmark.run import forbidden_modules
    assert forbidden_modules(["miniweatherml_tpu_torch.ops", "jaxtyping",
                              "flax_x", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "miniweatherml_tpu.ops",
                              "flax"]) == ["flax", "jax.numpy",
                                           "miniweatherml_tpu.ops"]


@pytest.mark.cuda
def test_a_cell_on_the_card(card, root):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "kessler_cb1024", "--seed", "5", "--seconds", "2",
                        "--trace", "1"], cwd=root, capture_output=True,
                       text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["busy_s"] > 0
