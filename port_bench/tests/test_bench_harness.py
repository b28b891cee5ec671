"""The harness finds every piece by name, runs each traffic at tiny
shapes on the CPU, refuses to measure without a card, and neither it nor
the reference loads JAX, the JAX package or (the reference) the port."""

from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from port_bench import run
from port_bench.entries import entry_class
from port_bench.tests.tiny import CELLS, VARIANTS, tiny_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_every_piece_is_found_by_name():
    spec = run.load_spec()
    assert spec["paths"] == [os.path.basename(BENCH)]
    names = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        cell = run.Cell(spec, w["name"])
        assert w["config"] in names and cell.config["name"] == w["config"]
        assert entry_class(cell.traffic["entry"]).unit in ("step", "view")
        assert cell.limits, f"{w['name']} has no limits file"
        assert cell.end_to_end() and cell.per_layer()
        for m in cell.end_to_end() + cell.per_layer():
            assert callable(run.metric_reader(cell.bench, m["name"]))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("name", CELLS + VARIANTS)
def test_traffic_runs_tiny_on_the_cpu(name):
    cell = tiny_cell(name)
    res = run.run_cell(cell, 2 ** 31 + 77, 0.2, False, "cpu")
    assert "device" not in res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end()}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in res["metrics"].values())
    assert res["correct"], res["checks"]


def test_a_metric_without_a_reader_stops_the_run():
    cell = tiny_cell(CELLS[0])
    cell.spec = dict(cell.spec, end_to_end=cell.spec["end_to_end"] + [
        {"name": "export_s", "unit": "s", "better": "lower", "bound": 0.1,
         "source": "host_clock"}])
    with pytest.raises(RuntimeError, match="no reader for the metric 'export_s'"):
        run.run_cell(cell, 1, 0.1, False, "cpu")


def test_an_end_to_end_metric_that_reads_nothing_stops_the_run():
    # A training metric's reader finds nothing in a render cell.
    spec = run.load_spec()
    entry = {n: run.Cell(spec, n).traffic["entry"] for n in CELLS}
    render = tiny_cell(next(n for n in CELLS if entry[n] == "render"))
    other = next(m for m in spec["end_to_end"] if m.get("workloads")
                 and all(entry[n] == "train" for n in m["workloads"]))
    render.spec = dict(render.spec, end_to_end=[dict(other, workloads=None)])
    with pytest.raises(RuntimeError, match="read nothing"):
        run.run_cell(render, 1, 0.1, False, "cpu")


def test_a_traced_run_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        run.run_cell(tiny_cell(CELLS[0]), 1, 0.1, True, "cpu")


def test_the_command_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 1
    assert capsys.readouterr().out == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jaxish", "s_volsdf_tpu_torch", "s_volsdf_tpu_torch.ops",
                 "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "s_volsdf_tpu.models", sys)
    assert run.forbidden_modules() == ["s_volsdf_tpu.models"]


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("from port_bench.tests.tiny import tiny_cell\n"
            "from port_bench import run\n"
            "run.run_cell(tiny_cell('volsdf_dtu.eval_render'), 3, 0.1, False, 'cpu')")
    held = _modules_after(code)
    assert not held & set(run.FORBIDDEN)
    assert "s_volsdf_tpu_torch" in held


def test_the_reference_imports_nothing_of_the_program():
    held = _modules_after("import port_bench.reference.volsdf")
    assert not held & (set(run.FORBIDDEN) | {"s_volsdf_tpu_torch"})
    for root, _, files in os.walk(os.path.join(BENCH, "reference")):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names]
                             if isinstance(node, ast.Import) else
                             [node.module or ""]
                             if isinstance(node, ast.ImportFrom) else [])
                    for n in names:
                        assert n.split(".")[0] not in (
                            set(run.FORBIDDEN) | {"s_volsdf_tpu_torch"}), (f, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name,
         "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
