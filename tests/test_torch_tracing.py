"""The port's program spans (``medsam2_tpu_torch/utils/tracing.py``) on the
CPU at TINY, the port alone: ``propagate_volumes_batched(fold=True)`` with
tracing off makes no span object and reads no clock, and gives the same
logits as a traced call; traced, each call is one ``propagate`` tree of
prompt and tracked steps, each step holding one span of each of its stages,
with self times that add up to the root's duration and one ``sync`` span per
host-array upload of the bank's readout. The ``-profile`` trace of the 3D
exporter and of both ``train_2d`` loops holds the spans' ``medsam2.`` ranges."""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from medsam2_tpu_torch.api import video_predictor as TV
from medsam2_tpu_torch.configs import FpnNeckConfig, HieraConfig, SAM2Config
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.state import memory_bank as TB
from medsam2_tpu_torch.utils import tracing
from medsam2_tpu_torch.utils.logging_utils import Profiler

torch.set_num_threads(2)

# tests/test_predictors.py's TINY, from the port's own configs
TINY = SAM2Config(
    trunk=HieraConfig(embed_dim=8, stages=(1, 1, 1, 1), window_spec=(2, 2, 2, 2),
                      global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(3, 3)),
    neck=FpnNeckConfig(backbone_channel_list=(64, 32, 16, 8)),
    image_size=64,
    compute_dtype="float32",
)
V, T, PROMPTS = 2, 6, (0, 3)
STAGES = ("image_encoder", "sam_heads", "memory_encoder")
# host arrays uploaded by the bank's readout of one tracked step: read_ptrs'
# three, plus kv_storage_layout's targets (storage order) or read_bank's ring
# slots and targets and read_kcache's ring slots (read order over the cache)
BANK_UPLOADS = {"1": 4, "0": 6}


@pytest.fixture(scope="module")
def model():
    return SAM2Model(TINY, seed=0, device="cpu")


def _inputs():
    video = np.zeros((T, 64, 64, 3), np.float32)
    for t in range(T):
        video[t, 20:36, 8 + 4 * t:24 + 4 * t] = 1.0
    videos = np.stack([video, video[::-1].copy()])
    rng = np.random.default_rng(0)
    coords = (16.0 + 32.0 * rng.random((V, len(PROMPTS), 1, 1, 2))).astype(np.float32)
    return videos, coords, np.ones((V, len(PROMPTS), 1, 1), np.int32)


def _propagate(model):
    spec = TB.BankSpec.from_config(TINY, max_cond_frames=len(PROMPTS))
    videos, coords, labels = _inputs()
    return TV.propagate_volumes_batched(model, spec, videos, coords, labels,
                                        prompt_frames=PROMPTS, fold=True)


def _descendants(spans, root):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out, todo = [], [root.id]
    while todo:
        for s in kids.get(todo.pop(), []):
            out.append(s)
            todo.append(s.id)
    return out


def test_tracing_off_records_nothing_and_changes_nothing(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was made or a clock read with tracing off")

    with monkeypatch.context() as m:
        m.setattr(tracing, "_Open", refuse)
        m.setattr(tracing.time, "perf_counter_ns", refuse)
        off = _propagate(model)
        assert tracing.span("propagate", new_call=True) is tracing.span("sync")
    with tracing.collect() as rec:
        on = _propagate(model)
    assert rec.spans
    assert torch.equal(off, on)
    assert tracing._recorder is None


@pytest.mark.parametrize("kv", ["1", "0"])
def test_spans_form_one_tree_per_call(model, monkeypatch, kv):
    monkeypatch.setenv("MEDSAM2_KV_STORAGE", kv)
    with tracing.collect() as rec:
        _propagate(model)
        _propagate(model)
    spans = rec.spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    assert [(r.name, r.call) for r in roots] == [("propagate", 1), ("propagate", 2)]
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.call == p.call
    own = rec.self_ns()
    assert min(own.values()) >= 0
    for root in roots:
        tree = [root] + _descendants(spans, root)
        assert {s.call for s in tree} == {root.call}
        assert sum(own[s.id] for s in tree) == root.duration_ns
        # the steps, and the upload of the roped-key cache's temporal rows
        assert Counter(s.name for s in tree if s.parent == root.id) == {
            "prompt_step": len(PROMPTS), "track_step": T - len(PROMPTS), "sync": 1}
        steps = [s for s in tree if s.parent == root.id and s.name != "sync"]
        assert sorted(s.frame for s in steps if s.name == "prompt_step") == list(PROMPTS)
        assert sorted(s.frame for s in steps if s.name == "track_step") == [
            f for f in range(T) if f not in PROMPTS]
        for step in steps:
            below = _descendants(spans, step)
            assert {s.frame for s in below} <= {step.frame}
            names = Counter(s.name for s in below)
            assert all(names[n] == 1 for n in STAGES), (step.name, names)
            assert names["bank.write"] == 1
            if step.name == "track_step":
                assert names["memory_attention"] == 1
                read = next(s for s in below if s.name == "memory_attention")
                under_read = Counter(s.name for s in _descendants(spans, read)
                                     if by_id[s.parent].name == "bank.read")
                assert under_read == {"sync": BANK_UPLOADS[kv]}
                # and the prompt encoder's point scale, inside the heads
                assert names["sync"] == BANK_UPLOADS[kv] + 1
            else:
                assert names["memory_attention"] == 0
                assert names["sync"] == 2
    totals = rec.totals()
    assert totals["propagate"]["count"] == 2
    assert sum(t["self_ns"] for t in totals.values()) == sum(r.duration_ns for r in roots)


def test_collect_is_one_thread_and_not_nested():
    with tracing.collect() as rec:
        with pytest.raises(RuntimeError, match="already active"):
            with tracing.collect():
                pass
        other = threading.Thread(target=lambda: tracing.span("sync").__enter__())
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        with tracing.span("bank.read", frame=4):
            with tracing.span("bank.read"):
                tracing.upload(np.arange(3), "cpu")
    assert [(s.name, s.frame) for s in rec.spans] == [("sync", 4), ("bank.read", 4)]
    assert rec.spans[0].parent == rec.spans[1].id


def _ranges(path):
    events = json.load(open(path))["traceEvents"]
    return Counter(e["name"] for e in events if e.get("ph") == "X"
                   and e.get("name", "").startswith(tracing.RANGE_PREFIX))


@pytest.mark.parametrize("num_steps", [1, 2])
def test_profiler_records_num_steps_with_program_ranges(model, tmp_path, num_steps):
    prof = Profiler(str(tmp_path), num_steps=num_steps)
    prof.start()
    for _ in range(3):
        _propagate(model)
        prof.step()
    prof.close()
    assert tracing._recorder is None
    ranges = _ranges(tmp_path / "trace.json")
    assert ranges["medsam2.propagate"] == num_steps
    assert ranges["medsam2.track_step"] == num_steps * (T - len(PROMPTS))
    assert ranges["medsam2.memory_attention"] == num_steps * (T - len(PROMPTS))


@pytest.mark.parametrize("net", ["sam2", "prompter"])
def test_train_2d_profile_traces_program_ranges(tmp_path, monkeypatch, net):
    """``-profile`` in both ``train_2d`` loops (REFUGE and nuclei): the
    trace of the steps holds the model's spans."""
    import medsam2_tpu_torch.cli.train_2d as t2

    monkeypatch.setattr(t2, "get_config", lambda name, **kw: TINY)
    t2.main(["-net", net, "-dataset", "synthetic", "-image_size", "64", "-out_size", "64",
             "-b", "2", "-epochs", "1", "-steps_per_epoch", "2", "-val_freq", "1",
             "-val_max_samples", "1", "-max_cells", "4", "-device", "cpu", "-profile",
             "-logdir", str(tmp_path)])
    trace = next(tmp_path.glob("*/Log/trace.json"))
    ranges = _ranges(trace)
    for name in ("image_encoder", "sam_heads", "memory_encoder"):
        assert ranges[tracing.RANGE_PREFIX + name] >= 2, (name, ranges)
