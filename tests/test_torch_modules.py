"""The port's modules against the JAX package's, on CPU at the TINY config.

The same weights (``sam2_init`` -> numpy -> ``state_dict_from_jax`` ->
``load_reference_state_dict``) and the same numpy inputs go through both.
Tolerances are the README's: image encoder, FPN levels and position
encodings <= 1e-4; SAM heads (low-res multimasks, IoUs, object pointer, object
score) <= 1e-3; memory encoder <= 1e-3; storage-order memory attention <= 1e-3;
the bank after ``write_bank``, roped-key cache included, <= 1e-4. Primitive
layers hold 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.core import layers as JL
from medsam2_tpu.core import memory as JM
from medsam2_tpu.core import sam2_model as JS
from medsam2_tpu.core.hiera import _get_pos_embed
from medsam2_tpu.core.image_encoder import image_encoder_apply
from medsam2_tpu.state import memory_bank as JB
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.core import layers as TL
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.state import memory_bank as TB
from tests.test_predictors import TINY

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    params = JS.sam2_init(jax.random.PRNGKey(0), TINY)
    model = SAM2Model(TINY, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), TINY))
    return params, model


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.asarray(a).dtype).copy())


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,size,aa", [
    ("bilinear", (40, 28), False), ("bilinear", (7, 9), False),
    ("bilinear", (6, 5), True), ("nearest", (32, 40), False)])
def test_interpolate_matches_jax(method, size, aa):
    x = np.random.default_rng(0).standard_normal((2, 16, 20, 3)).astype(np.float32)
    want = JL.interpolate(jnp.asarray(x), size, method=method, antialias=aa)
    _close(TL.interpolate(_t(x), size, method=method, antialias=aa), want, 1e-5)


def test_bicubic_gelu_layer_norm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 7, 7, 8)).astype(np.float32)
    _close(TL.bicubic_resize(_t(x), 16, 12), JL.bicubic_resize_np(x[0], 16, 12)[None], 1e-5)
    _close(TL.gelu(_t(x)), JL.gelu(jnp.asarray(x)), 1e-6)
    w = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = JL.layer_norm_apply({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                               jnp.asarray(x), eps=1e-6)
    _close(TL.layer_norm(_t(x), _t(w), _t(b), eps=1e-6), want, 1e-5)


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------


def test_image_encoder_levels_and_pos_match_jax(models):
    params, model = models
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: image_encoder_apply(p, TINY, a))(params["image_encoder"],
                                                                 jnp.asarray(x))
    with torch.no_grad():
        got = model.image_encoder(_t(x))
    assert len(got["backbone_fpn"]) == len(want["backbone_fpn"])
    for g, w in zip(got["backbone_fpn"], want["backbone_fpn"]):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-4)
    for g, w in zip(got["vision_pos_enc"], want["vision_pos_enc"]):
        _close(g, w, 1e-4)
    _close(got["vision_features"], want["vision_features"], 1e-4)
    trunk = params["image_encoder"]["trunk"]
    _close(model.image_encoder.trunk.get_pos_embed(16, 16), _get_pos_embed(trunk, 16, 16), 1e-5)
    fwd = jax.jit(lambda p, a: JS.forward_image(p, TINY, a))(params, jnp.asarray(x))
    with torch.no_grad():
        tfwd = model.forward_image(_t(x))
    for g, w in zip(tfwd["backbone_fpn"], fwd["backbone_fpn"]):
        _close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# SAM heads
# ---------------------------------------------------------------------------


def _heads_inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, 4, 4, 256)).astype(np.float32)
    hr = [rng.standard_normal((B, 16, 16, 32)).astype(np.float32),
          rng.standard_normal((B, 8, 8, 64)).astype(np.float32)]
    coords = (rng.random((B, 2, 2)) * 64).astype(np.float32)
    labels = np.array([[1, 0], [1, -1]][:B], np.int32)
    return feats, hr, coords, labels


@pytest.mark.parametrize("multimask", [True, False], ids=["multi", "single"])
def test_forward_sam_heads_match_jax(models, multimask):
    params, model = models
    feats, hr, coords, labels = _heads_inputs(3)
    fn = jax.jit(lambda p, f, h0, h1, c, l: JS.forward_sam_heads(
        p, TINY, f, point_inputs={"point_coords": c, "point_labels": l},
        high_res_features=[h0, h1], multimask_output=multimask,
        eval_dynamic_multimask=True))
    want = fn(params, *[jnp.asarray(a) for a in (feats, *hr, coords, labels)])
    with torch.no_grad():
        got = model.forward_sam_heads(
            _t(feats), point_inputs={"point_coords": _t(coords), "point_labels": _t(labels)},
            high_res_features=[_t(hr[0]), _t(hr[1])], multimask_output=multimask,
            eval_dynamic_multimask=True)
    _close(got.low_res_multimasks, want.low_res_multimasks, 1e-3)
    _close(got.ious, want.ious, 1e-3)
    _close(got.low_res_masks, want.low_res_masks, 1e-3)
    _close(got.high_res_masks, want.high_res_masks, 1e-3)
    _close(got.obj_ptr, want.obj_ptr, 1e-3)
    _close(got.object_score_logits, want.object_score_logits, 1e-3)


def test_use_mask_as_output_matches_jax(models):
    """The path an object without a prompt on a conditioning frame takes."""
    params, model = models
    feats, hr, _, _ = _heads_inputs(4)
    mask = np.zeros((2, 64, 64, 1), np.float32)
    mask[1, 10:30, 20:50] = 1.0
    want = jax.jit(lambda p, f, h0, h1, m: JS.use_mask_as_output(p, TINY, f, [h0, h1], m))(
        params, *[jnp.asarray(a) for a in (feats, *hr, mask)])
    with torch.no_grad():
        got = model.use_mask_as_output(_t(feats), [_t(hr[0]), _t(hr[1])], _t(mask))
    _close(got.low_res_masks, want.low_res_masks, 1e-3)
    _close(got.obj_ptr, want.obj_ptr, 1e-3)
    _close(got.object_score_logits, want.object_score_logits, 1e-3)


# ---------------------------------------------------------------------------
# memory encoder, bank, storage-order memory attention
# ---------------------------------------------------------------------------


def test_memory_encoder_matches_jax(models):
    params, model = models
    rng = np.random.default_rng(5)
    pix = rng.standard_normal((2, 4, 4, 256)).astype(np.float32)
    logits = (rng.standard_normal((2, 1, 64, 64)) * 4).astype(np.float32)
    want_f, want_p = jax.jit(lambda p, a, m: JS.encode_new_memory(p, TINY, a, m, True))(
        params, jnp.asarray(pix), jnp.asarray(logits))
    with torch.no_grad():
        got_f, got_p = model.encode_new_memory(_t(pix), _t(logits), True)
    _close(got_f, want_f, 1e-3)
    _close(got_p, want_p, 1e-4)


# (frame, is_cond): two cond slots, then enough non-cond frames to wrap the
# 7-slot ring (frame 8 overwrites frame 1's slot)
WRITES = [(0, True), (1, False), (2, False), (3, False), (4, False), (5, True),
          (6, False), (7, False), (8, False), (9, False)]


def test_bank_writes_and_storage_memory_attention_match_jax(models):
    params, model = models
    rng = np.random.default_rng(6)
    B, P, D, C = 2, 16, 64, 256
    jspec = JB.BankSpec.from_config(TINY, max_cond_frames=2)
    tspec = TB.BankSpec.from_config(TINY, max_cond_frames=2)
    assert (jspec.noncond_ring, jspec.ptr_ring) == (tspec.noncond_ring, tspec.ptr_ring)
    kshape = JS.kcache_shape(TINY)
    jbank = JB.init_bank(jspec, B, kcache_shape=kshape, kcache_dtype=jnp.float32)
    tbank = TB.init_bank(tspec, B, "cpu", kcache_shape=kshape, kcache_dtype=torch.float32)
    jkc = jax.jit(lambda p, f: JM.precompute_memory_kcache(
        p, TINY.memory_attention, f, (4, 4), dtype=jnp.float32))
    jwrite = {c: jax.jit(lambda b, f, fe, pt, kc, c=c: JB.write_bank(
        jspec, b, f, fe, pt, is_cond=c, kcache=kc)) for c in (True, False)}
    for frame, is_cond in WRITES:
        feats = rng.standard_normal((B, P, D)).astype(np.float32)
        ptr = rng.standard_normal((B, C)).astype(np.float32)
        kc = jkc(params["memory_attention"], jnp.asarray(feats))
        jbank = jwrite[is_cond](jbank, frame, jnp.asarray(feats), jnp.asarray(ptr), kc)
        with torch.no_grad():
            tkc = model.memory_kcache(_t(feats), torch.float32)
        _close(tkc, kc, 1e-4)
        TB.write_bank(tspec, tbank, frame, _t(feats), _t(ptr), is_cond, kcache=tkc)
    assert sorted(tbank) == sorted(jbank)
    for k in jbank:
        assert tuple(tbank[k].shape) == jbank[k].shape, k
        _close(tbank[k], jbank[k], 1e-4)

    pos_k = jax.jit(lambda p: JS.make_pos_kcache(p, TINY, jspec))(params)
    with torch.no_grad():
        tpos_k = model.make_pos_kcache(tspec)
    _close(tpos_k, pos_k, 1e-4)
    rows, valid = jax.jit(lambda b: JB.kv_storage_layout(jspec, b, 10))(jbank)
    trows, tvalid = TB.kv_storage_layout(tspec, tbank, 10)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(rows))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))

    curr = rng.standard_normal((B, 4, 4, C)).astype(np.float32)
    pos = rng.standard_normal((B, 4, 4, C)).astype(np.float32)
    want = jax.jit(lambda p, b, x, q, pk: JS.prepare_memory_conditioned_features(
        p, TINY, jspec, b, 10, False, x, q, num_frames=12, is_eval=True,
        pos_kcache=pk, kv_storage=True))(params, jbank, jnp.asarray(curr),
                                         jnp.asarray(pos), pos_k)
    with torch.no_grad():
        got = model.prepare_memory_conditioned_features(
            tspec, tbank, 10, False, _t(curr), _t(pos), num_frames=12, is_eval=True,
            pos_kcache=tpos_k)
    _close(got, want, 1e-3)
