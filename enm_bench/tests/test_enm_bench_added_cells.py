"""A later cell is files and ``BENCHMARK.json`` entries: a configuration
file alone (an sdENM ensemble under the traces mix), and a traffic mix
that names another entry point and another reference module (the
spectral ensemble that ``PERF.md`` works through), each run at a tiny
size on the CPU without an edit to the harness."""

from __future__ import annotations

import copy
import json
import shutil
import sys
import types

import torch

from enm_bench.harness import spec
from enm_bench.reference import ensemble
from enm_bench.reference.springs import hessian_xyz
from enm_bench.tests import tiny

TRACES = "ens300-inv13.traces"


def _tmp_root(tmp_path):
    """A copy of the benchmark's data under `tmp_path`, as a checkout
    holds it."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / spec.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.py"))
    return tmp_path


def test_new_configuration_is_one_file(tmp_path):
    """An sdENM ensemble: a configuration file, a limits file and the
    ``BENCHMARK.json`` entries.  The reference gets the residue names,
    chains and residue IDs that the tabulated family needs."""
    root = _tmp_root(tmp_path)
    folder = root / spec.BENCH.name
    config = json.loads((folder / "configs" / "anm-ens300-inv13.json")
                        .read_text())
    config.update(name="anm-ens300-sdenm", force_field={"family": "sd_enm"})
    (folder / "configs" / "anm-ens300-sdenm.json").write_text(
        json.dumps(config))
    cell = "ens300-sdenm.traces"
    shutil.copy(folder / "limits" / f"{TRACES}.json",
                folder / "limits" / f"{cell}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="anm-ens300-sdenm",
                                 file="enm_bench/configs/anm-ens300-sdenm.json"))
    bench["workloads"].append({"name": cell, "config": "anm-ens300-sdenm",
                               "traffic": "traces", "chips": 1, "why": "-"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if TRACES in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = tiny.cell(cell, root)
    assert c.config["force_field"]["family"] == "sd_enm"
    result, readings = tiny.run(c, requests=2)
    assert result["correct"] is True, readings
    assert set(result["metrics"]) == {"solves_per_s", "call_p95_ms",
                                      "setup_s"}


def _with_traffic(monkeypatch, module, **traffic):
    name = f"enm_bench.reference.{module.__name__}"
    monkeypatch.setitem(sys.modules, name, module)
    c = tiny.cell(TRACES)
    c.traffic.update(reference=module.__name__, **traffic)
    return c


def test_traffic_names_its_reference(monkeypatch):
    """The route judges by the module that the traffic names: one whose
    MSF is 1e-3 off makes the run not correct."""
    def observables(coords, network, keys, options):
        out = ensemble.observables(coords, network, keys, options)
        out["msf"] = out["msf"] * (1 + 1e-3)
        return out

    module = types.SimpleNamespace(__name__="msf_off",
                                   observables=observables)
    result, readings = tiny.run(_with_traffic(monkeypatch, module),
                                requests=2)
    assert result["correct"] is False
    assert readings["msf"] > 5e-4 and readings["dcc"] < 5e-5, readings


def test_spectral_cell_as_described(monkeypatch):
    """``ensemble_anm_spectral`` under the same configuration: the engine
    options it does not take (``prep``) stay out of its call, and its
    eigenvalues are judged by a reference module of their own."""
    def observables(coords, network, keys, options):
        out = ensemble.observables(
            coords, network, [k for k in keys if k != "eig_values"], options)
        h = hessian_xyz(coords, network)
        out["eig_values"] = torch.linalg.eigvalsh(h)
        return out

    module = types.SimpleNamespace(__name__="spectral_example",
                                   observables=observables)
    c = _with_traffic(monkeypatch, module, entry="ensemble_anm_spectral",
                      options={"with_dcc": True},
                      compare=["eig_values", "msf", "dcc"])
    c.limits = {"eig_values": 1e-4, "msf": 3e-4, "dcc": 5e-5}
    result, readings = tiny.run(copy.deepcopy(c), requests=2)
    assert result["correct"] is True, readings
