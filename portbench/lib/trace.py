"""The traced sub-window: one unit of work under ``torch.profiler``, with
ranges around each hooked layer, reduced to what the per-layer readers and
the ``breakdown`` need. The device's work in the unit is as untraced; the
unit's length is not: the profiler's recording stretches it (by 27 % with
the device's activity alone, by 46-63 % with the host's operations and the
hooks, on an H100 host), so an idle share is taken against the untraced
window's time, not this one.

Layer ranges come from forward pre- and post-hooks that the benchmark
registers on the modules a loop names; each opens a ``record_function``
range ``portbench.layer.<name>``. A device operation belongs to a layer when
the host call that launched it (matched by the trace's correlation id) lies
inside one of that layer's ranges.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

LAYER_PREFIX = "portbench.layer."
WINDOW_NAME = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    """Device operations of the traced window, in seconds."""

    window_s: float                       # the traced window's length
    busy_s: float                         # union of device operations in it
    kernels: int                          # kernel launches in it
    device_ops: List[Tuple[str, float]]   # (name, seconds), longest first
    idle_gaps: List[Tuple[str, float]]    # (what the host was doing, seconds)
    layer_device_s: Dict[str, float] = field(default_factory=dict)
    work: int = 0


class LayerHooks:
    """Forward pre/post hooks that bracket each named module's calls with a
    profiler range. Use as a context manager; the hooks are removed on exit."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles = []
        self.stack: Dict[str, list] = defaultdict(list)

    def __enter__(self):
        for name, mod in self.modules.items():
            def pre(_m, _a, name=name):
                rf = torch.autograd.profiler.record_function(LAYER_PREFIX + name)
                rf.__enter__()
                self.stack[name].append(rf)

            def post(_m, _a, _o, name=name):
                self.stack[name].pop().__exit__(None, None, None)

            self.handles.append(mod.register_forward_pre_hook(pre))
            self.handles.append(mod.register_forward_hook(post))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(events: list, top: int = 10) -> TraceSummary:
    """Reduce the chrome-trace events of one traced window."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_NAME
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no portbench.window range")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    main_tid = window[0]["tid"]
    runtime = {}
    host_ops = []
    layer_ranges: Dict[str, list] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat.startswith("cuda_"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = e["ts"]
        elif cat in ("cpu_op", "user_annotation") and e["tid"] == main_tid:
            host_ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
            if cat == "user_annotation" and e["name"].startswith(LAYER_PREFIX):
                layer_ranges[e["name"][len(LAYER_PREFIX):]].append((e["ts"], e["ts"] + e["dur"]))
    for k in layer_ranges:
        layer_ranges[k].sort()
    layer_starts = {k: [s for s, _ in v] for k, v in layer_ranges.items()}

    dev = []
    by_name: Dict[str, float] = defaultdict(float)
    layer_s: Dict[str, float] = defaultdict(float)
    kernels = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = e["ts"], e["dur"]
        if s + d < w0 or s > w1:
            continue
        s, t_end = max(s, w0), min(s + d, w1)
        dev.append((s, t_end))
        sec = (t_end - s) * 1e-6
        by_name[e["name"]] += sec
        if e["cat"] == "kernel":
            kernels += 1
        lts = runtime.get((e.get("args") or {}).get("correlation"))
        if lts is None:
            continue
        for name, ranges in layer_ranges.items():
            if _covers(ranges, layer_starts[name], lts):
                layer_s[name] += sec
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) * 1e-6

    # idle gaps, labelled by the innermost host range open at the gap's start
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    host_ops.sort()
    stack: list = []
    j = 0
    for i in range(0, len(edges) - 1, 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        while j < len(host_ops) and host_ops[j][0] <= g0:
            while stack and stack[-1][1] < host_ops[j][0]:
                stack.pop()
            stack.append(host_ops[j])
            j += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        label = stack[-1][2] if stack else WINDOW_NAME
        gaps["host (python)" if label == WINDOW_NAME else label] += (g1 - g0) * 1e-6
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy, kernels=kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        layer_device_s=dict(layer_s))


def _covers(ranges, starts, ts) -> bool:
    """Whether one of the sorted ``ranges`` holds ``ts``: the ranges of one
    layer do not nest on one thread, so the last one to start before ``ts``
    decides."""
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ranges[i][1] >= ts


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


@contextlib.contextmanager
def traced(modules: Dict[str, torch.nn.Module], out: dict, device):
    """Profile the body; on exit ``out["summary"]`` holds its
    :class:`TraceSummary`. The body runs inside the ``portbench.window``
    range and must end in a device synchronise."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with LayerHooks(modules):
        with profile(activities=acts) as prof:
            with torch.autograd.profiler.record_function(WINDOW_NAME):
                yield
    t0 = time.perf_counter()
    out["summary"] = summarise(_events(prof))
    out["parse_s"] = time.perf_counter() - t0
