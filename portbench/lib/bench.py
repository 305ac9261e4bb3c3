"""One run of one cell: set up, warm, measure, trace, check, print.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- the workload's ``config`` names a configuration whose ``file`` the
  configuration entry gives (``portbench/configs/<name>.json``);
- its ``traffic`` names ``portbench/traffic/<traffic>.json``, whose
  ``loop`` names a module of ``portbench/loops/``;
- ``portbench/limits/<workload>.json`` holds the limits of the numbers that
  decide ``correct``;
- each per-layer metric is read by ``portbench/layer_metrics/<base>.py``,
  ``<base>`` being the metric's name up to its first dot.

So a later cell, configuration, traffic mix or per-layer metric is a new
file and a new entry, and this module does not change.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "medsam2_tpu")
NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this length


class RunError(RuntimeError):
    """A run that must end without a result."""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise RunError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise RunError(f"no configuration {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / "portbench" / kind / f"{name}.json"
    if not path.exists():
        raise RunError(f"no {kind} file {path.relative_to(root)}")
    with open(path) as f:
        return json.load(f)


def load_loop(traffic: dict):
    return importlib.import_module(f"portbench.loops.{traffic['loop']}").Loop


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(ctx)`` of ``portbench/layer_metrics/<base>.py``."""
    base = metric.split(".")[0]
    path = root / "portbench" / "layer_metrics" / f"{base}.py"
    if not path.exists():
        raise RunError(f"no reader {path.relative_to(root)} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(f"portbench.layer_metrics.{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that this cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: the port's own name only begins with the latter."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def guard_imports(stage: str):
    found = forbidden_modules()
    if found:
        raise RunError(f"{stage}: the process has loaded {', '.join(found)}")


def reference_imports(root: Path = ROOT) -> List[str]:
    """Top-level names that the reference's sources import, of the program
    or of JAX (an AST scan of ``portbench/reference``)."""
    import ast

    bad = set()
    for path in sorted((root / "portbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in FORBIDDEN or top == "medsam2_tpu_torch":
                    bad.add(f"{path.name}: {n}")
    return sorted(bad)


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


def build_port_model(cfg_doc: dict, device):
    """The port's SAM 2 at the configuration's preset, held to every number
    of the file's ``model`` block, its parameters allocated on ``device``
    without an initialisation (the loop draws the weights)."""
    import torch

    from medsam2_tpu_torch.configs import get_config
    from medsam2_tpu_torch.core.sam2_model import SAM2Model

    cfg = get_config(cfg_doc["preset"], **cfg_doc.get("overrides", {}))
    have = json.loads(json.dumps(dataclasses.asdict(cfg)))
    if have != cfg_doc["model"]:
        diff = sorted(k for k in set(have) | set(cfg_doc["model"])
                      if have.get(k) != cfg_doc["model"].get(k))
        raise RunError(f"the port's {cfg_doc['preset']} differs from "
                       f"{cfg_doc['name']} at {diff}")
    with torch.device("meta"):
        model = SAM2Model(cfg, device="meta")
    return model.to_empty(device=device).eval(), cfg


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    units: int = 0
    work: int = 0
    seconds: float = 0.0
    unit_s: List[float] = dataclasses.field(default_factory=list)
    unit_cpu_s: List[float] = dataclasses.field(default_factory=list)


def measure(loop, seconds: float) -> Window:
    """Units back to back until ``seconds`` have passed; each ends in a
    synchronise, and the window is all of their time. Each unit's host-clock
    time and the CPU time the window's thread spent in it are kept for the
    record: the loops are host-bound, and the two show how far."""
    w = Window()
    t0 = time.perf_counter()
    while True:
        u0, c0 = time.perf_counter(), time.thread_time()
        w.work += loop.run_unit()
        u1, c1 = time.perf_counter(), time.thread_time()
        w.units += 1
        w.unit_s.append(u1 - u0)
        w.unit_cpu_s.append(c1 - c0)
        if u1 - t0 >= seconds:
            break
    w.seconds = time.perf_counter() - t0
    return w


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak)}


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run(args, t_start: float, device=None, patch: Callable = None) -> dict:
    """One run; returns the result object. ``device`` None requires the
    cards the cell asks for; the CPU tests pass ``"cpu"`` and a TINY
    configuration through ``root``. ``patch(loop)`` lets a test break the
    timed path underneath."""
    import torch

    root = Path(args.root)
    bench = load_benchmark(root)
    cell = find_cell(bench, args.workload)
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    bad = reference_imports(root)
    if bad:
        raise RunError(f"the reference imports the program or JAX: {bad}")

    cfg_doc = load_config(bench, cell["config"], root)
    traffic = load_json("traffic", cell["traffic"], root)
    limits = load_json("limits", cell["name"], root)
    Loop = load_loop(traffic)
    loop = Loop(cfg_doc, traffic, args.seed, device)
    loop.setup(build_port_model)
    if patch is not None:
        patch(loop)
    loop.warm()
    setup_s = time.perf_counter() - t_start
    guard_imports("after set-up")

    window = measure(loop, float(args.seconds))
    guard_imports("after the window")
    counts = loop.counts()
    ctx = {"cell": cell, "traffic": traffic, "config": cfg_doc, "window": window,
           "counts": counts, "device": device}

    metrics = {}
    breakdown = None
    dev = device_info(device, chips)
    if args.trace:
        from portbench.lib.trace import traced

        out = {}
        with traced(loop.layer_modules(), out, device):
            work = loop.run_unit(keep=False)
        summ = out["summary"]
        summ.work = work
        ctx["trace"] = summ
        ctx["device_name"] = dev["kind"]
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            value = load_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summ.busy_s
        dev["window_s"] = summ.window_s
        breakdown = {"device_ops": [[n[:NAME_CHARS], s] for n, s in summ.device_ops],
                     "idle_gaps": [[n[:NAME_CHARS], s] for n, s in summ.idle_gaps]}
    else:
        rate = {"value": window.work / window.seconds}
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == traffic["rate_metric"]:
                metrics[m["name"]] = dict(rate, unit=m["unit"])
    dev = {**dev, **device_info(device, chips)}
    loop.release()
    checks = loop.check(limits)
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks)
    guard_imports("before the result")
    result = {"correct": bool(correct), "attempted": window.units, "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    diag = {"units": window.units, "work": window.work, "window_s": window.seconds,
            "unit_s": [round(u, 4) for u in window.unit_s],
            "unit_cpu_s": [round(u, 4) for u in window.unit_cpu_s],
            "unit_s_median": statistics.median(window.unit_s),
            "setup_s": setup_s, "power": power_limit() if device.type == "cuda" else None}
    if args.trace:
        diag["traced"] = {"busy_s": summ.busy_s, "window_s": summ.window_s,
                          "kernels": summ.kernels, "parse_s": out.get("parse_s")}
        diag["layer_device_s"] = summ.layer_device_s
    for k in ("per_slice", "per_slice_gap"):
        if hasattr(loop, k):
            diag[k + "_max"] = [float(x) for x in getattr(loop, k).max(dim=0).values]
    print("portbench: " + json.dumps(diag), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell of the port.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        result = run(args, t_start)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0
