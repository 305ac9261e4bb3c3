"""The program's own spans in the traced run (``--trace 1``).

Three more units of work run after the hooked one, each ``keep=False``:

- an untraced unit, timed: it settles the host after the hooked unit and
  its trace's parse (the first unit after them read 4-23 % over the
  window's median call on an H100 host), and is the spans-only unit's
  control at the same place;
- the spans-only unit, with the port's tracing on
  (``medsam2_tpu_torch.utils.tracing.collect``) and no profiler, so its host
  times are not stretched by one: each span name's count, total and self
  time, and the slices the unit finished;
- the profiled unit, with tracing on under ``torch.profiler``, so that each
  span is a ``medsam2.<span>`` range on the device trace's own timeline:
  device time and kernel launches by the innermost program span open when
  the host launched them (matched by correlation id), device idle by the
  innermost program span open at each gap's start, and each synchronising
  runtime call (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, a
  synchronous ``cudaMemcpy``) by the span it lies in.

They run once per run, for the first per-layer reader that asks
(:func:`program_spans`), and what they give is kept in ``ctx["spans"]``; the by-span tables go
to a ``portbench:`` diagnostics line on standard error. The harness hands a
reader ``ctx`` alone: the loop whose unit runs here is the one of the run
that owns ``ctx``, found on the call stack. A program without
``medsam2_tpu_torch.utils.tracing`` gives ``None``, and so do the readers.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from portbench.lib.trace import DEVICE_CATS, _events, _merge

TRACING = "medsam2_tpu_torch.utils.tracing"
WINDOW_NAME = "portbench.spans_window"
RANGE_PREFIX = "medsam2."
OUTSIDE = "(outside the program)"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def _tracing():
    if importlib.util.find_spec(TRACING) is None:
        return None
    return importlib.import_module(TRACING)


def _loop_of(ctx: dict):
    """The loop of the run whose locals hold ``ctx``."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_locals.get("ctx") is ctx and hasattr(f.f_locals.get("loop"), "run_unit"):
            return f.f_locals["loop"]
        f = f.f_back
    return None


def program_spans(ctx: dict) -> Optional[dict]:
    """``{"work", "unit_s", "control_s", "totals", "profiled"}`` of the run,
    made on the first call; ``totals`` maps each span name to its
    ``count``, ``total_ns`` and ``self_ns`` in the spans-only unit."""
    if "spans" in ctx:
        return ctx["spans"]
    ctx["spans"] = None
    tracing = _tracing()
    loop = _loop_of(ctx)
    if tracing is None or loop is None:
        return None
    t0 = time.perf_counter()
    loop.run_unit(keep=False)
    control_s = time.perf_counter() - t0
    with tracing.collect() as rec:
        t0 = time.perf_counter()
        work = loop.run_unit(keep=False)
        unit_s = time.perf_counter() - t0
    spans = {"work": work, "unit_s": unit_s, "control_s": control_s, "totals": rec.totals(),
             "profiled": profiled_unit(loop, tracing, ctx["device"])}
    ctx["spans"] = spans
    print("portbench: " + json.dumps({"spans": diagnostics(spans)}), file=sys.stderr)
    return spans


def profiled_unit(loop, tracing, device) -> dict:
    """One unit under ``torch.profiler`` with the program's spans on,
    reduced by :func:`by_span`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tracing.collect():
        with profile(activities=acts) as prof:
            with torch.autograd.profiler.record_function(WINDOW_NAME):
                work = loop.run_unit(keep=False)
    out = by_span(_events(prof))
    out["work"] = work
    return out


def _innermost(ranges: List[tuple], times: List[float]) -> List[Optional[str]]:
    """For each time, the name of the innermost of the nested ``ranges``
    (start, end, name) open at it, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[Optional[str]] = [None] * len(times)
    stack: list = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def by_span(events: list) -> dict:
    """Device seconds and kernel launches by the innermost program span that
    launched them, device idle seconds by the innermost program span open at
    each gap's start (``OUTSIDE`` where none is), and the synchronising
    runtime calls by the span they lie in, over the profiled window."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_NAME]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW_NAME} range")
    w0, tid = window[0]["ts"], window[0]["tid"]
    w1 = w0 + window[0]["dur"]
    ranges, launch_ts, syncs = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e["tid"] == tid and e["name"].startswith(RANGE_PREFIX):
            ranges.append((e["ts"], e["ts"] + e["dur"], e["name"][len(RANGE_PREFIX):]))
        elif cat.startswith("cuda_"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
            if e["name"] in SYNC_CALLS and w0 <= e["ts"] <= w1:
                syncs.append(e["ts"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, t_end = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t_end < s:
            continue
        ops.append((s, t_end, e["cat"] == "kernel",
                    launch_ts.get((e.get("args") or {}).get("correlation"))))
    device_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    launched = [op for op in ops if op[3] is not None]
    for op, name in zip(launched, _innermost(ranges, [op[3] for op in launched])):
        device_s[name or OUTSIDE] += (op[1] - op[0]) * 1e-6
        launches[name or OUTSIDE] += op[2]
    merged = _merge([(s, e) for s, e, _, _ in ops])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    idle_s: Dict[str, float] = defaultdict(float)
    for (g0, g1), name in zip(gaps, _innermost(ranges, [g0 for g0, _ in gaps])):
        idle_s[name or OUTSIDE] += (g1 - g0) * 1e-6
    sync_in: Dict[str, int] = defaultdict(int)
    for name in _innermost(ranges, syncs):
        sync_in[name or OUTSIDE] += 1
    idle = sum(idle_s.values())
    below = sum(v for k, v in idle_s.items() if k not in ("propagate", OUTSIDE))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(e - s for s, e in merged) * 1e-6,
            "kernels": sum(op[2] for op in ops), "device_s": dict(device_s),
            "launches": dict(launches), "idle_s": dict(idle_s),
            "idle_below_propagate": below / idle if idle > 0 else None,
            "sync_calls": dict(sync_in)}


def diagnostics(spans: dict) -> dict:
    """The by-span tables, in ms per slice where a rate, for the
    diagnostics line."""
    work = max(spans["work"], 1)
    totals = spans["totals"]
    p = spans["profiled"]

    def per_slice(d):
        return {k: round(1e3 * v / work, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    return {
        "unit_s": spans["unit_s"], "control_s": spans["control_s"], "work": spans["work"],
        "self_ms": per_slice({k: t["self_ns"] * 1e-9 for k, t in totals.items()}),
        "total_ms": per_slice({k: t["total_ns"] * 1e-9 for k, t in totals.items()}),
        "count": {k: t["count"] for k, t in totals.items()},
        "profiled": {"window_s": p["window_s"], "busy_s": p["busy_s"], "kernels": p["kernels"],
                     "device_ms": per_slice(p["device_s"]), "idle_ms": per_slice(p["idle_s"]),
                     "launches": p["launches"],
                     "idle_below_propagate": p["idle_below_propagate"],
                     "sync_calls": p["sync_calls"]},
    }
