"""The SAM heads' dispatch between the CUDA graph and the eager code, and the
prompt encoder's cached point scale, on the CPU at TINY. The graph itself is
held to the eager heads on the card by ``tests/test_torch_heads_graph_cuda.py``.

- ``PositionEmbeddingRandom.points`` scales by a per-(size, device) constant
  instead of uploading ``[1/W, 1/H]`` at each call: the same fp32 multiply,
  so the encodings are bit for bit the old ones, with no ``sync`` span.
- Only the memory-conditioned tracked form with gradients off, tensors on a
  card and whole linears takes the graph: every other call (the CPU,
  gradients on, points, a mask, a model sliced over a model axis) runs the
  eager heads and leaves the model's graph cache empty.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from medsam2_tpu_torch.configs import FpnNeckConfig, HieraConfig, SAM2Config
from medsam2_tpu_torch.core import pos_enc
from medsam2_tpu_torch.core import sam2_model as SM
from medsam2_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = SAM2Config(
    trunk=HieraConfig(embed_dim=8, stages=(1, 1, 1, 1), window_spec=(2, 2, 2, 2),
                      global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(3, 3)),
    neck=FpnNeckConfig(backbone_channel_list=(64, 32, 16, 8)),
    image_size=64,
    compute_dtype="float32",
)


@pytest.fixture(scope="module")
def model():
    return SM.SAM2Model(TINY, seed=0, device="cpu")


def _features(model, B, seed=0):
    """(image embedding [B, s, s, C], skip features) at TINY's shapes."""
    g = torch.Generator().manual_seed(seed)
    cfg = model.cfg
    s, C = cfg.sam_image_embedding_size, cfg.hidden_dim
    return (torch.randn(B, s, s, C, generator=g),
            [torch.randn(B, 4 * s, 4 * s, C // 8, generator=g),
             torch.randn(B, 2 * s, 2 * s, C // 4, generator=g)])


@pytest.mark.parametrize("size", [(1024, 1024), (64, 48), (37, 512)])
def test_cached_point_scale_is_the_old_upload_bit_for_bit(size):
    pe = pos_enc.PositionEmbeddingRandom(16, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    coords = torch.rand(3, 5, 2, generator=g) * torch.tensor([size[1], size[0]]) + 0.5
    old_scale = torch.from_numpy(np.array([1.0 / size[1], 1.0 / size[0]], np.float32))
    want = pe.encode(coords * old_scale)
    with tracing.collect() as rec:
        got = pe.points(coords, size)
        again = pe.points(coords, size)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert rec.spans == []                          # no upload, no sync span
    dev = coords.device
    scale = pos_enc._point_scale_on(size[0], size[1], dev)
    assert scale is pos_enc._point_scale_on(size[0], size[1], dev)
    assert scale.dtype == torch.float32 and torch.equal(scale, old_scale)


def test_graph_predicate_takes_only_the_tracked_form_on_a_card(model):
    card = SimpleNamespace(is_cuda=True)
    host = SimpleNamespace(is_cuda=False)
    skips = [card, card]
    points = {"point_coords": card, "point_labels": card}
    sharded = SimpleNamespace(_mesh=object())     # as parallel.mesh.shard_model leaves it
    with torch.no_grad():
        assert SM._graphable(model, card, skips, None, None)
        assert SM._graphable(model, card, None, None, None)
        assert not SM._graphable(model, card, skips, points, None)
        assert not SM._graphable(model, card, skips, None, card)
        assert not SM._graphable(model, host, skips, None, None)
        assert not SM._graphable(model, card, [card, host], None, None)
        assert not SM._graphable(sharded, card, skips, None, None)
    with torch.enable_grad():
        assert not SM._graphable(model, card, skips, None, None)


def _refuse_graph(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the heads took the graph path")

    monkeypatch.setattr(SM.SAM2Model, "_heads_graphed", refuse)
    monkeypatch.setattr(SM, "_HeadsGraph", refuse)


@pytest.mark.parametrize("case", ["cpu_tracked", "grad", "points", "mask"])
def test_heads_stay_eager_off_the_tracked_card_form(model, monkeypatch, case):
    _refuse_graph(monkeypatch)
    B = 2
    feats, skips = _features(model, B)
    kw = dict(high_res_features=skips, multimask_output=True, eval_dynamic_multimask=True)
    if case == "points":
        kw["point_inputs"] = {"point_coords": torch.full((B, 1, 2), 20.0),
                              "point_labels": torch.ones(B, 1, dtype=torch.int32)}
    if case == "mask":
        ms = 4 * model.cfg.sam_image_embedding_size
        kw["mask_inputs"] = torch.randn(B, ms, ms, 1, generator=torch.Generator().manual_seed(1))
    want = model._sam_heads(feats, kw.get("point_inputs"), kw.get("mask_inputs"), skips,
                            True, True)
    with torch.set_grad_enabled(case == "grad"):
        for _ in range(3):                  # past the call a card's graph would capture on
            with tracing.collect() as rec:
                got = model.forward_sam_heads(feats, **kw)
            assert [s.name for s in rec.spans] == ["sam_heads"]
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert len(model._heads_graphs) == 0
