"""
The benchmark's files, found by the names in ``BENCHMARK.json``: a cell's
configuration (the ``file`` of its ``configs`` entry), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), the
end-to-end and per-layer metrics it reports, and each per-layer metric's
reader (``metrics/<metric>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _read_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _read_json(pathlib.Path(root) / "BENCHMARK.json")


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell `name` of ``BENCHMARK.json`` with everything it reads."""
    root = pathlib.Path(root)
    folder = root / BENCH.name
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    entry = by_name[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in moved)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_read_json(root / config_entry["file"]),
        traffic=_read_json(folder / "traffic" / f"{entry['traffic']}.json"),
        limits=_read_json(folder / "limits" / f"{name}.json"),
        end_to_end=end_to_end, per_layer=per_layer)


def load_reader(metric):
    """The ``read`` function of the per-layer metric `metric`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "enm_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
