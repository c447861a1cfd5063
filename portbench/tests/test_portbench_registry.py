"""The harness finds every configuration, cell and metric by name, and one
added as files and BENCHMARK.json entries alone is found too."""

import json
import os
import re

import pytest

from portbench.harness import registry

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return registry.load_benchmark()


def test_every_cell_resolves():
    b = bench()
    for w in b["workloads"]:
        cell = registry.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["batch"] > 0
        assert cell.limits, f"{w['name']} has no limits file"
        readers = registry.metric_readers(cell)
        assert readers, w["name"]
        for m in cell.end_to_end:
            assert m["name"] in ("images_per_s", "peak_mem_gib", "setup_s")


@pytest.mark.parametrize("metric", [m["name"] for m in registry.load_benchmark()["per_layer"]])
def test_metric_entry_matches_its_reader(metric):
    entry = {m["name"]: m for m in bench()["per_layer"]}[metric]
    mod = registry.load_metric(metric)
    assert (entry["layer"], entry["unit"], entry["moves"], entry["source"]) == (
        mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE)
    assert callable(mod.read)


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    assert len(json.dumps(b)) < 64 * 1024


def test_added_cell_and_metric_are_found(tmp_path):
    """A new traffic mix, cell, limits file and metric reader, added as
    files beside a copy of the tree and entries in its BENCHMARK.json, are
    found with no other file edited."""
    from portbench.tests import tiny

    root = tiny.make_tree(str(tmp_path), limits={"rms_levels": 1.0})
    with open(os.path.join(root, "portbench", "traffic", "tiny_b4.json"), "w") as f:
        json.dump(dict(tiny.TINY_TRAFFIC, batch=4), f)
    with open(os.path.join(root, "portbench", "limits", "tiny_b4cell.json"), "w") as f:
        json.dump({"rms_levels": 2.0}, f)
    with open(os.path.join(root, "portbench", "metrics", "new_metric.py"), "w") as f:
        f.write('LAYER = "device"\nUNIT = "%"\nMOVES = "images_per_s"\n'
                'SOURCE = "device_trace"\n\n\ndef read(run):\n    return 42.0\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": "tiny_b4cell", "config": "tiny", "traffic": "tiny_b4",
                           "chips": 1, "why": "an added cell"})
    b["per_layer"].append({"name": "new_metric", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "images_per_s", "workloads": ["tiny_b4cell"]})
    with open(path, "w") as f:
        json.dump(b, f)
    cell = registry.find_cell("tiny_b4cell", root=root)
    assert cell.traffic["batch"] == 4 and cell.limits == {"rms_levels": 2.0}
    readers = registry.metric_readers(cell, root=root)
    assert readers["new_metric"].read(None) == 42.0
    other = registry.find_cell("tiny_tiny_guided", root=root)
    assert "new_metric" not in registry.metric_readers(other, root=root)
