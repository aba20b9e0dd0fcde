"""The benchmark's files against its contract, and a tiny run of every cell
on the CPU: the result line's keys, no JAX in the process, a reference
that imports nothing of the program."""

from __future__ import annotations

import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from enm_bench.harness import spec
from enm_bench.tests import tiny

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
FORBIDDEN = ("jax", "jaxlib", "flax", "springcraft_tpu")


def test_benchmark_keys_names_and_units():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS \
        + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]] \
            + [w["config"] for w in BENCH["workloads"]] \
            + [k for c in BENCH["configs"] for k in c["reduced"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_finds_its_files_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for name in CELLS:
        cell = spec.load_cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert cell.limits and cell.chips == 1
    for c in BENCH["configs"]:
        assert c["file"].startswith("enm_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_result_line(name):
    cell = tiny.cell(name)
    result, _ = tiny.run(cell, requests=2)
    assert list(result)[:5] == RESULT_KEYS and list(result)[-1] == "checks"
    assert set(result) == set(RESULT_KEYS) | {"checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run(name):
    cell = tiny.cell(name)
    result, _ = tiny.run(cell, trace=True, requests=3)
    assert set(result) == set(RESULT_KEYS) | {"checks", "breakdown"}
    assert list(result)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert result["correct"] is True


def test_no_jax_after_runs():
    """Every cell run in a fresh process leaves no module whose top-level
    name is JAX's or the JAX package's in ``sys.modules``."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from enm_bench.tests import tiny\n"
        f"for name in {CELLS!r}:\n"
        "    tiny.run(tiny.cell(name), requests=1)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=900)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "springcraft_tpu_torch" in modules
    assert not [m for m in modules if m.split(".", 1)[0] in FORBIDDEN]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((spec.BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN + (
                "springcraft_tpu_torch", "enm_bench"), (path, name)
    modules = ", ".join(f"enm_bench.reference.{p.stem}" for p in files)
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"import {modules}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = out.stdout
    for name in FORBIDDEN + ("springcraft_tpu_torch",):
        assert f"'{name}'" not in loaded


def _run_script(cwd):
    return subprocess.run(
        [sys.executable, "enm_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card(card_absent):
    out = _run_script(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "enm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_script(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs none")


def test_paths_hold_only_the_benchmark():
    for path in BENCH["paths"]:
        assert (ROOT / path).is_dir()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    for name in CELLS:
        traffic = spec.load_cell(name).traffic
        assert (spec.BENCH / "routes" / f"{traffic['route']}.py").is_file()
        assert (spec.BENCH / "reference"
                / f"{traffic['reference']}.py").is_file()
    assert pathlib.Path(spec.BENCH / "run.py").is_file()
