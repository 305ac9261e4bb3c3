"""The SAM heads replayed as a CUDA graph against the eager heads, on the card.

Marked ``cuda``: each test skips when no CUDA device is present. On a GPU
host run them without the JAX-configuring conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_heads_graph_cuda.py

The heads run at Hiera-S's widths in bf16 (hidden 256, a 64 x 64 image
embedding, skip features at 256^2 x 32 and 128^2 x 64) for B = 1 and 4, with
the object-score head's bias raised so that every row takes the
object-present branch and its masks are the decoder's own. The graph runs the
eager code's kernels on the same inputs, so its outputs are held to the eager
heads' bit for bit.
"""

import numpy as np
import pytest
import torch
from torch import nn

from medsam2_tpu_torch.api import video_predictor as TV
from medsam2_tpu_torch.configs import get_config
from medsam2_tpu_torch.core import sam2_model as SM
from medsam2_tpu_torch.state import memory_bank as TB
from medsam2_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _present(model):
    with torch.no_grad():
        model.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.add_(10.0)
    return model


@pytest.fixture(scope="module")
def model(dev):
    return _present(SM.SAM2Model(get_config("sam2_hiera_s"), seed=0, device=dev))


def _features(B, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    return r(B, 64, 64, 256), [r(B, 256, 256, 32), r(B, 128, 128, 64)]


def _eager(model, feats, skips):
    return model._sam_heads(feats, None, None, skips, True, True)


def _graphed(model, feats, skips):
    with tracing.collect() as rec:
        out = model.forward_sam_heads(feats, high_res_features=skips, multimask_output=True,
                                      eval_dynamic_multimask=True)
    return out, sum(s.name == "sam_heads.graph" for s in rec.spans)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("B", [1, 4])
@torch.no_grad()
def test_graphed_heads_equal_the_eager_heads(model, dev, B):
    model._heads_graphs.clear()
    replays = []
    for call in range(4):
        feats, skips = _features(B, 10 * B + call, dev)
        got, marked = _graphed(model, feats, skips)
        replays.append(marked)
        want = _eager(model, feats, skips)
        assert _equal(got, want), call
        assert got.high_res_masks.shape == (B, 1, 1024, 1024)
        assert (got.object_score_logits > 0).all()
    # first call eager, the second captures and replays, then replays
    assert replays == [0, 1, 1, 1]
    assert len(model._heads_graphs) == 1
    graph = next(iter(model._heads_graphs.values()))
    assert isinstance(graph, SM._HeadsGraph)
    for out in got:
        assert all(out.data_ptr() != t.data_ptr() for t in graph.outputs)


@torch.no_grad()
def test_a_replay_leaves_the_last_outputs_alone(model, dev):
    model._heads_graphs.clear()
    for call in range(2):
        _graphed(model, *_features(4, 100 + call, dev))
    first, marked = _graphed(model, *_features(4, 200, dev))
    kept = [t.clone() for t in first]
    second, marked2 = _graphed(model, *_features(4, 201, dev))
    assert marked == marked2 == 1
    assert _equal(first, kept)
    assert not torch.equal(first.low_res_masks, second.low_res_masks)


@torch.no_grad()
def test_replaced_weights_capture_again_and_loaded_weights_do_not(dev):
    model = _present(SM.SAM2Model(get_config("sam2_hiera_s"), seed=1, device=dev))
    feats, skips = _features(4, 300, dev)
    for _ in range(2):
        _graphed(model, feats, skips)
    (key, graph), = model._heads_graphs.items()
    # weights loaded in place keep their addresses, so the graph replays them
    w = model.sam_mask_decoder.iou_token.weight
    w.mul_(-1.0)
    got, marked = _graphed(model, feats, skips)
    assert marked == 1 and list(model._heads_graphs.items()) == [(key, graph)]
    assert _equal(got, _eager(model, feats, skips))
    # a parameter replaced by a new tensor is a new signature: eager, then a new capture
    dec = model.sam_mask_decoder
    dec.mask_tokens.weight = nn.Parameter(dec.mask_tokens.weight * 0.5, requires_grad=False)
    got, marked = _graphed(model, feats, skips)
    assert marked == 0 and _equal(got, _eager(model, feats, skips))
    got, marked = _graphed(model, feats, skips)
    assert marked == 1 and _equal(got, _eager(model, feats, skips))
    assert len(model._heads_graphs) == 2
    new = model._heads_graphs[next(reversed(model._heads_graphs))]
    assert new is not graph and isinstance(new, SM._HeadsGraph)


def test_folded_propagation_is_the_same_with_the_graph(dev, monkeypatch):
    cfg = get_config("sam2_hiera_s", image_size=256)
    model = _present(SM.SAM2Model(cfg, seed=2, device=dev))
    spec = TB.BankSpec.from_config(cfg, max_cond_frames=1)
    V, T, S = 2, 6, 256
    rng = np.random.default_rng(5)
    videos = torch.from_numpy(rng.standard_normal((V, T, S, S, 3)).astype(np.float32)).to(dev)
    coords = torch.tensor([[[[60.0, 70.0], [150.0, 160.0]]]] * V, device=dev)
    labels = torch.tensor([[[2, 3]]] * V, dtype=torch.int32, device=dev)
    with tracing.collect() as rec:
        graphed = TV.propagate_volumes_batched(model, spec, videos, coords, labels, fold=True)
    totals = rec.totals()
    # T - 1 tracked steps: the first eager, the second captures, all but the first replay
    assert totals["sam_heads.graph"]["count"] == T - 2
    monkeypatch.setattr(SM, "_graphable", lambda *a: False)
    eager = TV.propagate_volumes_batched(model, spec, videos, coords, labels, fold=True)
    assert graphed.shape == (V, T, 1, 1, S // 4, S // 4)
    assert torch.equal(graphed, eager)
