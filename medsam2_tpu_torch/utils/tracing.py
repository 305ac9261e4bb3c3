"""Program spans: where the port's host time goes, stage by stage.

Tracing is off unless a caller turns it on. ``span(name)`` then returns one
shared no-op context after a single check of a module global: it reads no
clock, makes no object and no ``torch`` call, and never synchronises.
:func:`collect` turns it on for its body, on the thread that enters it::

    with tracing.collect() as rec:
        propagate_volumes_batched(...)
    rec.spans         # every span closed in the body, in closing order
    rec.self_ns()     # {span id: duration less its children's}

A span records its name, its start and end (``time.perf_counter_ns``), its
own id, its parent's (the span open below it), the call it belongs to (one
id per span opened with ``new_call=True``, the ``propagate`` root of a
volume call) and the frame index, inherited from the parent where the span
gives none. Spans are kept in memory and handed back in the recorder. While
a ``torch.profiler`` records, each span also opens a ``record_function``
range ``medsam2.<name>``, so the program's stages lie on the device trace's
own timeline; that trace is the only way spans reach a file.

A span named as the innermost open span opens nothing: a stage that a model
method and its caller both mark is one span (``image_encoder`` is marked in
``SAM2Model.forward_image`` and around the whole encode of a frame in the
video predictor, ``memory_encoder`` in ``SAM2Model.encode_new_memory`` and
around it and the frame's roped-key cache at its call sites).

Span names of the 3D propagation path: ``propagate``, ``prompt_step``,
``track_step`` (session loop), ``image_encoder``, ``memory_attention``,
``sam_heads``, ``memory_encoder``, ``bank.read``, ``bank.write`` and
``sync``, each host-blocking transfer (:func:`upload`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

RANGE_PREFIX = "medsam2."

_OFF = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None     # the active recorder; None: tracing off


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    call: Optional[int]
    frame: Optional[int]
    start_ns: int
    end_ns: int

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Recorder:
    """The spans closed while :func:`collect` was active."""

    def __init__(self):
        self.spans: List[Span] = []
        self.thread = threading.get_ident()
        self._open: List[_Open] = []
        self._ids = 0
        self._calls = 0

    def self_ns(self) -> Dict[int, int]:
        """Each span's duration less its children's (which lie inside it, one
        after another, on one thread)."""
        own = {s.id: s.duration_ns for s in self.spans}
        for s in self.spans:
            if s.parent in own:
                own[s.parent] -= s.duration_ns
        return own

    def totals(self) -> Dict[str, Dict[str, int]]:
        """By span name: ``count``, summed ``total_ns`` and ``self_ns``."""
        own = self.self_ns()
        out: Dict[str, Dict[str, int]] = {}
        for s in self.spans:
            t = out.setdefault(s.name, {"count": 0, "total_ns": 0, "self_ns": 0})
            t["count"] += 1
            t["total_ns"] += s.duration_ns
            t["self_ns"] += own[s.id]
        return out


class _Open:
    """One open span of the active recorder."""

    __slots__ = ("rec", "name", "frame", "new_call", "id", "parent", "call", "start", "range")

    def __init__(self, rec: Recorder, name: str, frame: Optional[int], new_call: bool):
        self.rec, self.name, self.frame, self.new_call = rec, name, frame, new_call

    def __enter__(self):
        rec = self.rec
        top = rec._open[-1] if rec._open else None
        rec._ids += 1
        self.id = rec._ids
        self.parent = top.id if top is not None else None
        if self.new_call:
            rec._calls += 1
            self.call = rec._calls
        else:
            self.call = top.call if top is not None else None
        if self.frame is None and top is not None:
            self.frame = top.frame
        rec._open.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        rec._open.pop()
        rec.spans.append(Span(self.name, self.id, self.parent, self.call, self.frame,
                              self.start, end))
        return False


def span(name: str, frame: Optional[int] = None, new_call: bool = False):
    """A context that records one span while :func:`collect` is active on
    this thread, and does nothing otherwise. ``frame``: the frame index the
    span and its children belong to; ``new_call``: the span opens a new
    call id (a root)."""
    rec = _recorder
    if rec is None:
        return _OFF
    if threading.get_ident() != rec.thread or (rec._open and rec._open[-1].name == name):
        return _OFF
    return _Open(rec, name, frame, new_call)


@contextlib.contextmanager
def collect() -> Iterator[Recorder]:
    """Turn tracing on for the body, on the calling thread; yields the
    :class:`Recorder` that holds the spans."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("tracing.collect() is already active")
    rec = Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None


def upload(host: np.ndarray, device) -> torch.Tensor:
    """``host`` on ``device`` inside a ``sync`` span: a blocking copy from
    pageable memory, which on a card waits for the stream to drain."""
    with span("sync"):
        return torch.from_numpy(host).to(device)
