"""The eight readers of the program's spans: on a copy of the TINY cell listed
in their ``workloads`` they return numbers, the seven host times adding up
to the spans-only unit's ``propagate`` time per slice; without the program's
tracing module, as on a parent commit, or without a run's loop to drive,
they return None and the run still prints its result."""

import json

import pytest

from conftest import TINY_CELL
from portbench.lib import bench, spans

HOST = ["loop_host_ms", "encoder_host_ms", "memattn_host_ms", "heads_host_ms",
        "memenc_host_ms", "bank_host_ms", "sync_ms"]
NEW = [f"{m}.vol3d" for m in HOST + ["syncs_per_slice"]]


def _list_tiny(root):
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def _run(root):
    args = bench.parse(["--workload", TINY_CELL, "--seed", "2147483659", "--seconds", "1",
                        "--trace", "1", "--root", str(root)])
    return bench.run(args, 0.0, device="cpu")


def test_span_readers_read_the_tiny_cell(tiny_root, capsys):
    _list_tiny(tiny_root)
    res = _run(tiny_root)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    assert set(got) == set(NEW)
    assert all(v >= 0 for v in got.values())
    assert res["metrics"]["syncs_per_slice.vol3d"]["unit"] == "syncs/slice"
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    lines = [ln for ln in capsys.readouterr().err.splitlines() if '"spans"' in ln]
    assert len(lines) == 1 and lines[0].startswith("portbench: ")
    diag = json.loads(lines[0][len("portbench: "):])["spans"]
    # the seven host times are the whole of the propagate roots' time
    total = sum(got[f"{m}.vol3d"] for m in HOST)
    assert total == pytest.approx(diag["total_ms"]["propagate"], rel=1e-6)
    # one propagate root per call of the unit, two prompt-free volumes of T slices
    assert diag["count"]["propagate"] == 1
    assert got["syncs_per_slice.vol3d"] == pytest.approx(diag["count"]["sync"] / diag["work"])
    assert diag["profiled"]["sync_calls"] == {}          # no card: no runtime call


def test_span_readers_stay_silent_without_the_program_spans(tiny_root, monkeypatch):
    _list_tiny(tiny_root)
    monkeypatch.setattr(spans, "_tracing", lambda: None)
    res = _run(tiny_root)
    assert res["correct"] is True
    assert not set(res["metrics"]) & set(NEW)
    for name in NEW:
        # no run's loop on the stack either
        assert bench.load_reader(name, tiny_root)({"device": "cpu"}) is None


def test_innermost_span_of_nested_ranges():
    ranges = [(0, 100, "propagate"), (10, 50, "track_step"), (20, 30, "sync"),
              (60, 90, "track_step")]
    assert spans._innermost(ranges, [25, 5, 40, 95, 120, 60]) == [
        "sync", "propagate", "track_step", "propagate", None, "track_step"]
