"""BENCHMARK.json against the contract's rules for names, units and keys, and
the registry finding every file it names."""

import json
import re

import pytest

from conftest import REPO
from portbench.lib import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_limits():
    assert set(B) == KEYS["top"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert B["paths"] == ["portbench"]
    assert B["command"] == ["python3", "portbench/run.py"]
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keys_names_units(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        extra = set(e) - KEYS[kind] - ({"workloads"} if kind in ("end_to_end", "per_layer")
                                        else set())
        assert not extra and KEYS[kind] <= set(e), (e["name"], set(e))
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in B["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        reported = [m for m in B["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert len(reported) >= 2, w["name"]
        layer = [m for m in B["per_layer"] if w["name"] in m.get("workloads", cells)]
        assert layer, w["name"]
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]].get("workloads", cells)
    assert {c["name"] for c in B["configs"]} == {w["config"] for w in B["workloads"]}


def test_layers_named_in_perf_md():
    perf = (REPO / "PERF.md").read_text()
    for m in B["per_layer"]:
        assert m["layer"] in perf, m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_registry_finds_every_file(cell):
    w = bench.find_cell(B, cell)
    cfg = bench.load_config(B, w["config"], REPO)
    assert cfg["name"] == w["config"] and cfg["reduced"] == next(
        c["reduced"] for c in B["configs"] if c["name"] == w["config"])
    traffic = bench.load_json("traffic", w["traffic"], REPO)
    assert bench.load_loop(traffic) is not None
    limits = bench.load_json("limits", cell, REPO)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in bench.cell_metrics(B, cell, "per_layer"):
        assert callable(bench.load_reader(m["name"], REPO))


def test_config_files_hold_the_port_presets():
    """Every number of a configuration's ``model`` block is the port's preset
    with the file's overrides, so the program runs what the file states."""
    import dataclasses

    from medsam2_tpu_torch.configs import get_config

    for c in B["configs"]:
        doc = json.loads((REPO / c["file"]).read_text())
        have = json.loads(json.dumps(dataclasses.asdict(
            get_config(doc["preset"], **doc["overrides"]))))
        assert have == doc["model"], c["name"]
