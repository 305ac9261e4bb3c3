"""The reader of ``heads_graph_share``: replays of the SAM heads' CUDA graph
(``sam_heads.graph`` markers) over the heads' calls (``sam_heads`` spans) in
the spans-only unit, in %. On the CPU the heads never replay a graph, so the
TINY cell reads nothing, as a program without the graph does, and the run
still prints its result."""

import json

from conftest import TINY_CELL
from portbench.lib import bench

NAME = "heads_graph_share.vol3d"


def _ctx(totals):
    return {"spans": {"work": 128, "totals": totals}}


def test_share_is_replays_over_heads_calls(tiny_root):
    read = bench.load_reader(NAME, tiny_root)
    one = {"total_ns": 1, "self_ns": 1}
    got = read(_ctx({"sam_heads": {"count": 32, **one}, "sam_heads.graph": {"count": 31, **one}}))
    assert got == 100.0 * 31 / 32
    assert read(_ctx({"sam_heads": {"count": 32, **one}})) is None
    assert read(_ctx({})) is None
    assert read({"spans": None}) is None


def test_tiny_cpu_cell_reads_nothing_and_runs_whole(tiny_root):
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append(TINY_CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    args = bench.parse(["--workload", TINY_CELL, "--seed", "2147483659", "--seconds", "1",
                        "--trace", "1", "--root", str(tiny_root)])
    res = bench.run(args, 0.0, device="cpu")
    assert res["correct"] is True
    assert NAME not in res["metrics"]
    assert "heads_host_ms.vol3d" not in res["metrics"]       # not listed for the TINY cell
