"""The REFUGE 2D training slice, JAX package against the PyTorch port, on the
CPU at TINY (``tests/test_predictors.py``, image size 64, loss at 64 px),
memory-attention dropout 0 in both configs.

- ``forward_2d`` with an empty and a non-empty bank, ``is_eval`` off and on,
  single- and multimask: prediction logits and IoUs to 1e-3, and the bank it
  writes.
- Two ``make_train_step_2d`` steps (the empty bank, then the bank the first
  step wrote, with the JAX package's draws injected through ``indices``):
  losses to rtol 1e-5; every clipped gradient AdamW applies to 1e-4 of its
  leaf's largest |gradient| (the JAX gradients from ``jax.value_and_grad`` of
  the step's loss, its ``min(1, clip / |g|)`` scale applied; the decoder's
  attention key biases, zero in exact arithmetic, to 1e-6 of the largest
  gradient); the parameters after AdamW (to 2 lr a step per element: Adam
  steps every element by about lr, so an element whose gradient is at
  round-off can step the other way; and most elements to 1e-7); the bank.
- One AdamW step against ``optax.adamw`` on the same gradients.

Weights are made once (``sam2_init`` -> numpy -> the port)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu.state import similarity_bank as JSB
from medsam2_tpu.train import losses as JL
from medsam2_tpu.train import recipe_2d as JR
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.data.refuge import pack_refuge_batch
from medsam2_tpu_torch.data.synthetic import synthetic_fundus
from medsam2_tpu_torch.state import similarity_bank as TSB
from medsam2_tpu_torch.train import recipe_2d as TR
from tests.test_predictors import TINY

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py

CFG = dataclasses.replace(TINY, memory_attention=dataclasses.replace(TINY.memory_attention,
                                                                     dropout=0.0))
RCFG = dict(memory_bank_size=8, out_size=64)
TOL = dict(atol=1e-3, rtol=1e-3)
B = 2


def _port(params):
    model = SAM2Model(CFG, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), CFG))
    return model


@pytest.fixture(scope="module")
def params():
    return sam2_init(jax.random.PRNGKey(0), CFG)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return pack_refuge_batch([synthetic_fundus(rng, 64) for _ in range(B)], 64, 64)


def _bank_np(seed, K=8, filled=3):
    """A bank with ``filled`` valid slots of random memories."""
    rng = np.random.default_rng(seed)
    P = CFG.sam_image_embedding_size ** 2
    bank = {"feats": np.zeros((K, P, CFG.mem_dim), np.float32), "iou": np.zeros(K, np.float32),
            "embeds": np.zeros((K, P * CFG.hidden_dim), np.float32), "valid": np.zeros(K, bool)}
    bank["feats"][:filled] = rng.standard_normal((filled, P, CFG.mem_dim))
    bank["embeds"][:filled] = rng.standard_normal((filled, P * CFG.hidden_dim))
    bank["iou"][:filled] = rng.uniform(0.3, 0.9, filled)
    bank["valid"][:filled] = True
    return bank


def _same_bank(tb, jb, tol=1e-4):
    np.testing.assert_array_equal(tb["valid"].numpy(), np.asarray(jb["valid"]))
    for key in ("feats", "iou", "embeds"):
        want = np.asarray(jb[key], np.float32)
        got = tb[key].float().numpy()
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0), key


def _inject(monkeypatch, forced):
    """The JAX recipe's draws forced to ``forced`` (its read goes through
    the module attribute)."""
    orig = JSB.read_similarity_bank
    monkeypatch.setattr(JSB, "read_similarity_bank",
                        lambda bank, cur, key, n, indices=None: orig(
                            bank, cur, key, n, indices=jnp.asarray(forced)))


INDICES = np.array([[2, 0], [1, 1]])


@pytest.mark.parametrize("nonempty,is_eval,multimask", [
    (False, False, False), (True, False, False), (True, True, False), (True, False, True)],
    ids=["empty", "bank", "bank_eval", "bank_multimask"])
def test_forward_2d_matches_jax(params, monkeypatch, nonempty, is_eval, multimask):
    _inject(monkeypatch, INDICES)
    model = _port(params)
    batch = _batch(1)
    bank = _bank_np(2)
    rcfg_j, rcfg_t = JR.Recipe2DConfig(**RCFG), TR.Recipe2DConfig(**RCFG)
    jpred, jiou, jbank, _ = JR.forward_2d(
        params, CFG, rcfg_j, *(jnp.asarray(batch[k]) for k in ("images", "coords", "labels")),
        jax.tree_util.tree_map(jnp.asarray, bank), jax.random.PRNGKey(3), nonempty,
        multimask_output=multimask, is_eval=is_eval)
    with torch.no_grad():
        tpred, tiou, tbank, _ = TR.forward_2d(
            model, rcfg_t, *(torch.from_numpy(batch[k]) for k in ("images", "coords", "labels")),
            {k: torch.from_numpy(v) for k, v in bank.items()}, None, nonempty,
            multimask_output=multimask, is_eval=is_eval, indices=torch.from_numpy(INDICES))
    assert tuple(tpred.shape) == jpred.shape == (B, 64, 64)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), **TOL)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), **TOL)
    _same_bank(tbank, jbank)
    assert int(tbank["valid"].sum()) == 3 + B


def _jax_loss(params, rcfg, batch, bank, key, nonempty):
    """``make_train_step_2d``'s ``loss_fn`` (``recipe_2d.py:143-157``), so
    that the test sees the gradients the JAX step clips."""
    key, dk = jax.random.split(key)
    pred, iou_pred, bank, _ = JR.forward_2d(params, CFG, rcfg, batch["images"],
                                            batch["coords"], batch["labels"], bank, key,
                                            nonempty, dropout_key=dk)
    gt = batch["gt_masks"]
    bce = JL.bce_with_logits(pred, gt, rcfg.pos_weight).mean()
    dsc = JL.dice_loss(pred, gt).mean()
    actual_iou = JL.iou_between((pred > 0).astype(jnp.float32), gt)
    iou_l = jnp.mean((iou_pred - jax.lax.stop_gradient(actual_iou)) ** 2)
    return bce + dsc + rcfg.iou_loss_weight * iou_l


def test_two_train_steps_match_jax(params, monkeypatch):
    _inject(monkeypatch, INDICES)
    rcfg_j, rcfg_t = JR.Recipe2DConfig(**RCFG), TR.Recipe2DConfig(**RCFG)
    tx = JR.make_optimizer_2d(rcfg_j)
    jstep = jax.jit(JR.make_train_step_2d(CFG, rcfg_j, tx), static_argnames=("bank_nonempty",))
    jgrad = jax.jit(jax.value_and_grad(lambda p, b, bank, k, ne: _jax_loss(p, rcfg_j, b, bank, k,
                                                                          ne)),
                    static_argnums=(4,))
    model = _port(params)
    opt = TR.make_optimizer_2d(model, rcfg_t)
    step = TR.make_train_step_2d(model, rcfg_t, opt)
    jbank = JSB.init_similarity_bank(8, CFG.sam_image_embedding_size ** 2, CFG.mem_dim,
                                     CFG.sam_image_embedding_size ** 2 * CFG.hidden_dim)
    tbank = TR.init_bank(model, 8)
    jp, jopt = params, tx.init(params)
    for i, nonempty in enumerate((False, True)):
        batch = _batch(10 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        key = jax.random.PRNGKey(20 + i)
        jloss, jg = jgrad(jp, jb, jbank, key, nonempty)
        jp, jopt, jbank, jm = jstep(jp, jopt, jb, jbank, key, bank_nonempty=nonempty)
        np.testing.assert_allclose(float(jloss), float(jm["loss"]), rtol=1e-6)
        tbank, tm = step(batch, tbank, None, nonempty, indices=torch.from_numpy(INDICES))
        for name in ("loss", "bce", "dice", "iou_mse"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {name}")
        gnorm = float(optax.global_norm(jg))
        scale = min(1.0, rcfg_j.clip_grad / max(gnorm, 1e-9))
        _check_grads(model, state_dict_from_jax(
            jax.tree_util.tree_map(lambda g: np.asarray(g) * scale, jg), CFG), i)
        _check_params(model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp), CFG),
                      i + 1, rcfg_t.lr)
        _same_bank(tbank, jbank)
    assert int(tbank["valid"].sum()) == 2 * B


def _check_grads(model, ref, step):
    named = TR.named_trainables(model)
    assert {n for n, _ in named} == set(ref)          # one set of leaves in both
    largest = max(float(np.abs(v).max()) for v in ref.values())
    reached = 0
    for name, p in named:
        want = ref[name].reshape(p.shape)
        got = p.grad.numpy()
        if name.startswith("sam_mask_decoder.") and name.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax is invariant to the shift a
            # key bias adds to every logit): round-off on both sides
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * largest, name
        elif not np.abs(want).max():
            assert not np.abs(got).max(), f"step {step} {name}: not reached in JAX"
        else:
            err = float(np.abs(got - want).max() / np.abs(want).max())
            assert err <= 1e-4, f"step {step} {name}: {err:.2e}"
            reached += 1
    # step 0 (empty bank): no memory attention; step 1 reaches it
    prefixes = {n.split(".")[0] for n, p in named if np.abs(ref[n]).max()}
    assert "image_encoder" in prefixes and "sam_mask_decoder" in prefixes
    assert ("memory_attention" in prefixes) == (step == 1)
    assert "memory_encoder" not in prefixes and reached > 50


def _check_params(model, ref, steps, lr):
    for name, p in TR.named_trainables(model):
        want = ref[name].reshape(p.shape)
        diff = np.abs(p.detach().numpy() - want)
        assert diff.max() <= 2 * lr * steps + 1e-6, name
        assert np.median(diff) <= 1e-7, name


def test_adamw_step_matches_optax():
    """``make_optimizer_2d``'s AdamW against ``optax.adamw`` on the same
    gradients, three steps: decay of the old weights, bias correction and
    eps after the square root are the same update."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    rcfg = TR.Recipe2DConfig()
    tx = optax.adamw(rcfg.lr, weight_decay=rcfg.weight_decay)
    jw = jnp.asarray(w)
    state = tx.init(jw)
    tw = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt = torch.optim.AdamW([tw], lr=rcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=rcfg.weight_decay)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        tw.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm_is_the_jax_rule():
    gs = [torch.full((3,), 2.0), torch.full((4,), -1.0)]
    norm = float(np.sqrt(3 * 4 + 4))
    TR.clip_by_global_norm(gs, 0.1)
    np.testing.assert_allclose(gs[0].numpy(), 2.0 * 0.1 / norm, rtol=1e-6)
    small = [torch.full((2,), 1e-3)]
    TR.clip_by_global_norm(small, 0.1)                 # under the clip: unscaled
    assert torch.equal(small[0], torch.full((2,), 1e-3))
    zero = [torch.zeros(3)]
    TR.clip_by_global_norm(zero, 0.1)                  # |g| = 0: max(|g|, 1e-9), no nan
    assert torch.equal(zero[0], torch.zeros(3))


def test_bank_positions_tile_the_sine_grid():
    model = SAM2Model(CFG, seed=0, device="cpu")
    pos = TR._bank_memory_pos(model, 3, torch.float32)
    P = CFG.sam_image_embedding_size ** 2
    want = np.asarray(JR._bank_memory_pos(CFG, 3))
    assert tuple(pos.shape) == want.shape == (3 * P, CFG.mem_dim)
    np.testing.assert_allclose(pos.numpy(), want, rtol=1e-6, atol=1e-6)
    assert TR._bank_memory_pos(model, 3, torch.float32) is pos           # cached
    assert TSB.init_similarity_bank(2, P, 4, 8, "cpu")["valid"].dtype == torch.bool
