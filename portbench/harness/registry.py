"""Finds a cell's files by the names ``BENCHMARK.json`` gives them; nothing
lists configurations, traffic mixes or metrics in code.

  the cell           ``BENCHMARK.json`` ``workloads[name]``
  its configuration  the ``file`` of ``configs[config]``
  its traffic mix    ``portbench/traffic/<traffic>.json``
  its limits         ``portbench/limits/<cell>.json``
  a per-layer metric ``portbench/metrics/<metric>.py``, for the cells its
                     ``workloads`` key lists (every cell without one)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workloads entry
    config: dict           # the configuration file's contents
    traffic: dict          # the traffic file's contents
    limits: dict           # {number: limit} of the comparison
    end_to_end: List[dict]
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    bdir = os.path.join(root, os.path.relpath(BENCH_DIR, ROOT))
    limits_path = os.path.join(bdir, "limits", f"{name}.json")
    return Cell(
        name=name, entry=entry,
        config=_read_json(os.path.join(root, cfg_entry["file"])),
        traffic=_read_json(os.path.join(bdir, "traffic", f"{entry['traffic']}.json")),
        limits=_read_json(limits_path) if os.path.exists(limits_path) else {},
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def load_metric(name: str, root: str = ROOT):
    """The reader module of per-layer metric ``name``: it defines ``LAYER``,
    ``UNIT``, ``MOVES``, ``SOURCE`` and ``read(run) -> float | None``."""
    bdir = os.path.join(root, os.path.relpath(BENCH_DIR, ROOT))
    path = os.path.join(bdir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(cell: Cell, root: str = ROOT) -> Dict[str, object]:
    return {m["name"]: load_metric(m["name"], root) for m in cell.per_layer}
