"""The manifest against the benchmark's contract, and every name it gives
found by name among the benchmark's files."""

import json
import os
import re
import shutil

import pytest
import torch

from benchmark import harness

from conftest import CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture
def manifest(root):
    return harness.load_manifest(root)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_and_limits(manifest, root):
    assert set(manifest) == KEYS
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 * 1024
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in manifest["paths"])
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    chips4 = 0
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        chips4 += w["chips"] == 4
        assert _line(w["why"])
    assert chips4 <= max(1, len(manifest["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in manifest[k]]
    for group in (names, [w["name"] for w in manifest["workloads"]],
                  [c["name"] for c in manifest["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(manifest, root, cell):
    c, entry, cfg, traffic = harness.cell_files(manifest, cell, root)
    assert cfg["nx_glob"] * cfg["ny_glob"] * cfg["nz"] > 0
    assert isinstance(traffic, dict)
    limits = json.load(open(os.path.join(root, "benchmark", "limits",
                                         cell + ".json")))["limits"]
    assert set(limits) == {"dt", *cfg["compare"]}
    for m in harness.metric_names(manifest, cell, "per_layer"):
        assert callable(harness.load_metric(m["name"], root).read)
    for m in harness.metric_names(manifest, cell, "end_to_end"):
        assert callable(harness.load_metric(m["name"], root,
                                            "end_to_end").read)
    every = {m["name"] for m in manifest["configs"]}
    assert c["config"] in every


def test_a_new_cell_is_new_files_and_entries(manifest, root, tmp_path, tiny):
    """A throwaway cell, a traffic mix of a kind the committed mixes do not
    use (sparse white-noise cloud set per dry density over a cooled
    layer), an end-to-end and a per-layer metric and the cell's limits,
    added as files and entries in a copy of the checkout, are found by name
    and run; no file the harness already has changes."""
    m = json.loads(json.dumps(manifest))
    m["workloads"].append({"name": "throwaway", "config":
                           "supercell_kessler_cb1024", "traffic": "drizzle",
                           "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "steps_done", "unit": "steps",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["throwaway"]})
    m["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "driver", "moves": "mcellups",
                           "workloads": ["throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    # the new files go to a copy of the benchmark's directory
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    (b / "traffic" / "drizzle.json").write_text(json.dumps({"inputs": [
        {"field": "cloud_liquid", "mode": "set", "form": "uniform",
         "range": [0.0, 1.0e-4], "keep_fraction": 0.3,
         "levels": [0.1, 0.4], "per_density_dry": True},
        {"field": "temp", "mode": "add", "form": "layer", "peak": -2.0,
         "z_m": 3000.0, "width_m": 1500.0}]}))
    (b / "end_to_end" / "steps_done.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    (b / "metrics" / "steps_seen.py").write_text(
        "def read(trace):\n    return float(trace.steps)\n")
    lim = json.load(open(b / "limits" / "kessler_cb1024.json"))
    lim["limits"] = {k: (0.0 if k == "dt" else 0.05) for k in lim["limits"]}
    (b / "limits" / "throwaway.json").write_text(json.dumps(lim))
    before = {p: open(os.path.join(root, "benchmark", p)).read()
              for p in ("harness.py", "inputs.py", "run.py", "compare.py",
                        "reference/chain.py")}
    c, _, cfg, traffic = harness.cell_files(m, "throwaway", str(tmp_path))
    assert traffic["inputs"][0]["keep_fraction"] == 0.3
    for kind, name, arg in (("end_to_end", "steps_done", "run"),
                            ("metrics", "steps_seen", "trace")):
        mod = harness.load_metric(name, str(tmp_path), kind)
        assert mod.read(type(arg, (), {"steps": 3})()) == 3.0
    assert [x["name"] for x in harness.metric_names(m, "throwaway",
                                                    "per_layer")][-1] \
        == "steps_seen"
    cell = harness.Cell("throwaway", str(tmp_path), tiny)
    ins = cell.inputs(11, "cpu")
    cloud = ins[0].value
    assert 0.0 < (cloud > 0).double().mean().item() < 0.5
    assert ins[1].value.min().item() < -1.5
    res = harness.run("throwaway", 11, 0.1, False, 0.0, device="cpu",
                      grid_overrides=tiny, root=str(tmp_path))
    assert res["correct"] is True, res["checks"]
    assert before == {p: open(os.path.join(root, "benchmark", p)).read()
                      for p in before}


BUILDING = """\"\"\"The single box building (dynamics...h:1549-1652) in the
city's gravity-off background.\"\"\"

import numpy as np
import torch

from .init_city import TRACERS, constants, initial_dynamics  # noqa: F401


def immersed_proportion(grid, cfg, root, dtype, device):
    i, j = np.arange(grid.nx), np.arange(grid.ny)
    k = np.arange(grid.nz)[:, None, None]
    r = 0.05 * grid.ny
    box = (np.abs(i[None, :] - 0.3 * grid.nx) <= r) & \\
        (np.abs(j[:, None] - 0.5 * grid.ny) <= r)
    inside = box[None] & (k <= 0.2 * grid.nz)
    return torch.as_tensor(inside.astype(np.float64), dtype=dtype,
                           device=device)
"""


def _tree(path):
    out = {}
    for dirpath, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


def test_a_new_chain_is_new_files_and_entries(manifest, root, tmp_path):
    """A throwaway configuration of another chain (the single building,
    ``init_data: building``, through the city's entry, with its reference
    initial state a new file and the top sponge at other settings) runs
    correct from new files and entries in a copy of the checkout; no file
    the harness already has changes."""
    before = _tree(os.path.join(root, "benchmark"))
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "building_small", "source": "a test",
                         "file": "benchmark/configs/building_small.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "building", "config": "building_small",
                           "traffic": "city_turbulent_inflow", "chips": 1,
                           "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "simple_city_400x400x60.json"))
    cfg.update(init_data="building", nx_glob=48, ny_glob=32, nz=12, nens=1,
               xlen=1500, ylen=1000, zlen=300)
    cfg["reference"] = {"init": "building",
                        "steps": ["hsponge", "dycore", "sponge", "averager"],
                        "hsponge": {"cells": 10, "time_scale": 1.0,
                                    "walls": ["x1", "x2"]},
                        "sponge": {"time_scale": 1.0, "layers": 10}}
    (b / "configs" / "building_small.json").write_text(json.dumps(cfg))
    (b / "reference" / "init_building.py").write_text(BUILDING)
    lim = json.load(open(b / "limits" / "city_400x400x60.json"))
    lim["limits"] = {k: (0.0 if v == 0.0 else 0.05)
                     for k, v in lim["limits"].items()}
    (b / "limits" / "building.json").write_text(json.dumps(lim))
    from benchmark.reference.chain import ReferenceChain
    cell = harness.Cell("building", str(tmp_path))
    chain = ReferenceChain(cell.cfg, cell.grid, cell.root, torch.float32,
                           torch.device("cpu"))
    assert chain.init.__file__ == str(b / "reference" / "init_building.py")
    res = harness.run("building", 12, 0.1, False, 0.0, device="cpu",
                      root=str(tmp_path))
    assert res["correct"] is True, res["checks"]
    assert 0.0 < res["checks"]["wvel"]["value"] < 0.05
    assert before == _tree(os.path.join(root, "benchmark"))
