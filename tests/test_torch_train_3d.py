"""The 3D training slice, JAX package against the PyTorch port, on CPU at TINY.

- The read-order memory readout (``prepare_memory_conditioned_features``
  without the roped-key cache) and ``track_step`` over a bank written with
  the same memories, to the README's memory-attention tolerance (1e-3), with
  and without the temporal encoding of object pointers.
- One ``make_train_step`` on ``tests/test_train_3d.py``'s TINY recipe: both
  losses to 1e-5 relative and every trainable gradient to 1e-4 of its
  max|grad| (the JAX gradients come from the two vjp pulls of
  ``recipe_3d.make_train_step`` and cross into reference keys through
  ``state_dict_from_jax``); frozen tensors unchanged, both groups updated.
  The same over the bank's roped-key cache (``use_kcache=True``), which
  also equals the port's step without the cache; ``MEDSAM2_TRAIN_KCACHE``
  switches it as in JAX.
- Dropout: its rate, and that a step without a generator is deterministic.
- The ``train_3d`` CLI on synthetic data with ``-device cpu``, then a resume
  from its checkpoint.

Weights and inputs are made once (``sam2_init`` -> numpy -> the port)."""

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.core import sam2_model as JS
from medsam2_tpu.state import memory_bank as JB
from medsam2_tpu.train import recipe_3d as JR
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.core.memory import dropout
from medsam2_tpu_torch.core.sam2_model import TRAINABLE_GROUPS, SAM2Model
from medsam2_tpu_torch.state import memory_bank as TB
from medsam2_tpu_torch.train import recipe_3d as TR
from tests.test_predictors import TINY
from tests.test_train_3d import synth_batch

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py

RCFG = dict(video_length=4, prompt_freq=2, num_objects=2, lr_sam=1e-4, lr_mem=1e-8,
            max_cond_frames=2)
TINY_TPOS = dataclasses.replace(TINY, add_tpos_enc_to_obj_ptrs=True,
                                proj_tpos_enc_in_obj_ptrs=True)


def _port(params, cfg):
    model = SAM2Model(cfg, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


@pytest.fixture(scope="module")
def models():
    params = JS.sam2_init(jax.random.PRNGKey(0), TINY)
    return params, _port(params, TINY)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# read-order readout and track_step
# ---------------------------------------------------------------------------

# (frame, is_cond): two cond slots, then non-cond frames that wrap the ring
WRITES = [(0, True), (1, False), (2, False), (3, False), (4, False), (5, True),
          (6, False), (7, False), (8, False), (9, False)]


@pytest.mark.parametrize("cfg", [TINY, TINY_TPOS], ids=["tiny", "obj_ptr_tpos"])
def test_read_order_readout_and_track_step_match_jax(cfg):
    params = JS.sam2_init(jax.random.PRNGKey(0), cfg)
    model = _port(params, cfg)
    rng = np.random.default_rng(6)
    B, P, D, C = 2, 16, 64, 256
    jspec = JB.BankSpec.from_config(cfg, max_cond_frames=2)
    tspec = TB.BankSpec.from_config(cfg, max_cond_frames=2)
    jbank = JB.init_bank(jspec, B)
    tbank = TB.init_bank(tspec, B, "cpu")
    for frame, is_cond in WRITES:
        feats = rng.standard_normal((B, P, D)).astype(np.float32)
        ptr = rng.standard_normal((B, C)).astype(np.float32)
        jbank = JB.write_bank(jspec, jbank, frame, jnp.asarray(feats), jnp.asarray(ptr),
                              is_cond=is_cond)
        with torch.no_grad():
            TB.write_bank(tspec, tbank, frame, _t(feats), _t(ptr), is_cond)
    spatial = np.asarray(JS.sine_pos_embed(4, 4, D)).reshape(-1, D)
    jread = JB.read_bank(jspec, jbank, 10, params["maskmem_tpos_enc"], jnp.asarray(spatial),
                         obj_ptrs_in_past_only=True, num_frames=12)
    tread = TB.read_bank(tspec, tbank, 10, _t(params["maskmem_tpos_enc"]), _t(spatial),
                         obj_ptrs_in_past_only=True, num_frames=12)
    for got, want in zip(tread[:3] + (tread[4],), jread[:3] + (jread[4],)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert tread[3] == jread[3]

    curr = rng.standard_normal((B, 4, 4, C)).astype(np.float32)
    pos = rng.standard_normal((B, 4, 4, C)).astype(np.float32)
    want = JS.prepare_memory_conditioned_features(
        params, cfg, jspec, jbank, 10, False, jnp.asarray(curr), jnp.asarray(pos),
        num_frames=12, is_eval=True)
    with torch.no_grad():
        got = model.prepare_memory_conditioned_features(
            tspec, tbank, 10, False, _t(curr), _t(pos), num_frames=12, is_eval=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)

    # one tracked frame on top of the bank (training mode: no binarisation)
    feats = [rng.standard_normal((B, 16, 16, 32)).astype(np.float32),
             rng.standard_normal((B, 8, 8, 64)).astype(np.float32), curr]
    jout, jbank2 = JS.track_step(params, cfg, jspec, jbank, 10, False,
                                 [jnp.asarray(f) for f in feats],
                                 [jnp.asarray(pos)] * 3, multimask_output=True,
                                 num_frames=12, is_eval=False)
    tout, tbank2 = model.track_step(tspec, tbank, 10, False, [_t(f) for f in feats],
                                    [_t(pos)] * 3, multimask_output=True, num_frames=12,
                                    is_eval=False)
    for key in ("pred_masks", "obj_ptr", "object_score_logits"):
        np.testing.assert_allclose(tout[key].detach().numpy(), np.asarray(jout[key]),
                                   atol=1e-3, rtol=0, err_msg=key)
    for key in jbank2:
        np.testing.assert_allclose(tbank2[key].detach().numpy(), np.asarray(jbank2[key]),
                                   atol=1e-3, rtol=0, err_msg=key)


def test_no_mem_token_branch_matches_jax():
    """An initial conditioning frame without ``directly_add_no_mem_embed``
    attends to the single no-mem token (``sam2_model.py:329-337``); the
    token is d_model wide, so this config's memory attention takes d_model
    keys."""
    ma = dataclasses.replace(TINY.memory_attention, kv_in_dim=TINY.memory_attention.d_model)
    cfg = dataclasses.replace(TINY, directly_add_no_mem_embed=False, memory_attention=ma)
    params = JS.sam2_init(jax.random.PRNGKey(2), cfg)
    model = _port(params, cfg)
    rng = np.random.default_rng(7)
    curr, pos = (rng.standard_normal((2, 4, 4, 256)).astype(np.float32) for _ in range(2))
    spec = JB.BankSpec.from_config(cfg, max_cond_frames=2)
    want = JS.prepare_memory_conditioned_features(
        params, cfg, spec, JB.init_bank(spec, 2), 0, True, jnp.asarray(curr), jnp.asarray(pos))
    tspec = TB.BankSpec.from_config(cfg, max_cond_frames=2)
    with torch.no_grad():
        got = model.prepare_memory_conditioned_features(
            tspec, TB.init_bank(tspec, 2, "cpu"), 0, True, _t(curr), _t(pos),
            num_frames=2 ** 30, is_eval=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_grad_mode_bank_write_is_out_of_place(models):
    _, model = models
    spec = TB.BankSpec.from_config(TINY, max_cond_frames=2)
    bank = TB.init_bank(spec, 1, "cpu")
    feats = torch.ones(1, 16, 64, requires_grad=True)
    new = TB.write_bank(spec, bank, 3, feats * 2, torch.zeros(1, 256), is_cond=False)
    assert new is not bank and bank["noncond_feats"].abs().max() == 0
    new["noncond_feats"].sum().backward()
    assert feats.grad.sum().item() == 2 * 16 * 64
    with torch.no_grad():
        same = TB.write_bank(spec, bank, 3, feats, torch.zeros(1, 256), is_cond=False)
    assert same is bank and bank["noncond_feats"].abs().max() == 1


# ---------------------------------------------------------------------------
# one train step against the JAX package
# ---------------------------------------------------------------------------


def _jax_losses_and_grads(params, batch, rcfg):
    """The JAX train step's losses and the gradients its optimizers see."""
    spec = JB.BankSpec.from_config(TINY, max_cond_frames=rcfg.max_cond_frames)
    trainable = {m for mods in TRAINABLE_GROUPS.values() for m in mods}

    def losses_fn(p):
        p = {k: (v if k in trainable else jax.lax.stop_gradient(v)) for k, v in p.items()}
        per = jax.vmap(lambda b: JR.volume_losses(p, TINY, spec, rcfg, b))(batch)
        return jnp.mean(per[0]), jnp.mean(per[1])

    @jax.jit
    def run(p):
        (pl_, npl), vjp = jax.vjp(losses_fn, p)
        g_np = vjp((jnp.zeros_like(pl_), jnp.ones_like(npl)))[0]
        g_tot = vjp((jnp.ones_like(pl_), jnp.ones_like(npl)))[0]
        return pl_, npl, {k: g_tot[k] if k == "sam_mask_decoder" else g_np[k] for k in p}

    return run(params)


def test_train_step_losses_and_gradients_match_jax(models):
    params, _ = models
    _step_matches_jax(params, RCFG)


def test_kcache_train_step_matches_jax(models):
    """One step over the bank's roped-key cache (``use_kcache=True``) against
    the JAX step with the cache: the same losses and gradients, to the same
    tolerances as the step without it."""
    params, _ = models
    _step_matches_jax(params, dict(RCFG, use_kcache=True))


def _step_matches_jax(params, rcfg_kw):
    """One port ``make_train_step`` against the JAX step on the same weights
    and batch: both losses to 1e-5 relative, every trainable gradient to 1e-4
    of its max|grad|, frozen tensors unchanged, both groups updated."""
    model = _port(params, TINY)
    rcfg = JR.Recipe3DConfig(**rcfg_kw)
    batch = synth_batch()
    want_p, want_np, jgrads = _jax_losses_and_grads(params, batch, rcfg)
    ref_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), TINY)

    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opts = TR.make_optimizers(model, TR.Recipe3DConfig(**rcfg_kw))
    step = TR.make_train_step(model, TR.Recipe3DConfig(**rcfg_kw), opts)
    metrics = step({k: np.array(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["prompt_loss"]), float(want_p), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["non_prompt_loss"]), float(want_np), rtol=1e-5)

    groups = {name: g for g, mods in TRAINABLE_GROUPS.items() for name in mods}
    largest = max(float(np.abs(ref_grads[n]).max()) for n, p in model.named_parameters()
                  if p.requires_grad)
    n_checked = 0
    for name, p in model.named_parameters():
        if name.split(".")[0] not in groups:
            assert p.grad is None and not p.requires_grad, name
            continue
        want = ref_grads[name].reshape(p.shape)
        got = p.grad.numpy()
        if name.startswith("sam_mask_decoder.") and name.endswith("k_proj.bias"):
            # zero in exact arithmetic (the decoder's attention has no RoPE,
            # and softmax is invariant to the shift q.b a key bias adds to
            # every logit): both sides hold round-off, 1e-10 of the largest
            # gradient's 1e-2, and relative error says nothing
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * largest, name
        elif not np.abs(want).max():
            # a leaf the losses do not reach (mask_downsample: no object of
            # this batch takes the empty-mask prompt)
            assert not np.abs(got).max(), name
        else:
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max()) / scale
            assert err <= 1e-4, f"{name}: {err:.2e} of max|grad| {scale:.2e}"
        n_checked += 1
    assert n_checked == sum(len(v) for v in model.set_trainable_groups().values())

    after = model.state_dict()

    def changed(prefix):
        return any(not torch.equal(before[k], after[k]) for k in before if k.startswith(prefix))

    assert changed("sam_mask_decoder.") and changed("memory_attention.")
    assert changed("memory_encoder.") and changed("obj_ptr_proj.")
    for k in before:
        if k.split(".")[0] not in groups:
            assert torch.equal(before[k], after[k]), f"frozen {k} changed"


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_rate_and_deterministic_without_generator(models):
    params, _ = models
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert abs((y == 0).float().mean().item() - 0.1) < 5e-3
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert dropout(x, 0.1, None) is x

    losses = []
    for gen in (None, None, torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)):
        model = _port(params, TINY)
        opts = TR.make_optimizers(model, TR.Recipe3DConfig(**RCFG))
        step = TR.make_train_step(model, TR.Recipe3DConfig(**RCFG), opts)
        batch = {k: np.array(v) for k, v in synth_batch().items()}
        losses.append(float(step(batch, gen)["non_prompt_loss"]))
    assert losses[0] == losses[1]              # no generator: no dropout, same step
    assert losses[2] == losses[3] != losses[0]  # one seed: the same masks


def test_full_remat_matches_enc_saved(models):
    """``remat="full"`` (each tracked frame recomputed in the backward by
    ``torch.utils.checkpoint``) gives the same step, dropout masks included:
    each frame's generator is made from its seed inside the recomputed code."""
    params, _ = models
    grads, losses = [], []
    for remat in ("enc_saved", "full"):
        model = _port(params, TINY)
        rcfg = TR.Recipe3DConfig(remat=remat, **RCFG)
        step = TR.make_train_step(model, rcfg, TR.make_optimizers(model, rcfg))
        batch = {k: np.array(v) for k, v in synth_batch().items()}
        losses.append(float(step(batch, torch.Generator().manual_seed(3))["loss"]))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad})
    assert losses[0] == losses[1]
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-9, msg=name)


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SAM2Model(TINY)


def test_kcache_training_matches_no_cache(models):
    """``tests/test_train_3d.py:169`` on the port: the cache is a pure
    lowering, so the losses and the gradients of every trainable group
    equal those of the per-frame projection (fp32), with either remat
    policy."""
    params, _ = models
    model = _port(params, TINY)
    batch = {k: torch.from_numpy(np.array(v[0])) for k, v in synth_batch().items()
             if k != "prompt_use_mask"}
    batch["prompt_use_mask"] = np.zeros((2, 2), bool)
    spec = TB.BankSpec.from_config(TINY, max_cond_frames=RCFG["max_cond_frames"])
    names = [n for g in model.set_trainable_groups().values() for n, _ in g]
    params_t = dict(model.named_parameters())
    out = {}
    for cached, remat in ((True, "enc_saved"), (True, "full"), (False, "enc_saved")):
        rcfg = TR.Recipe3DConfig(use_kcache=cached, remat=remat, **RCFG)
        pl_, npl = TR.volume_losses(model, spec, rcfg, batch)
        grads = torch.autograd.grad(pl_ + npl, [params_t[n] for n in names], allow_unused=True)
        out[cached, remat] = ((pl_ + npl).item(), grads)
    loss, want = out[False, "enc_saved"]
    for key in ((True, "enc_saved"), (True, "full")):
        np.testing.assert_allclose(out[key][0], loss, rtol=1e-5)
        for name, g, w in zip(names, out[key][1], want):
            if w is None:
                assert g is None, name
                continue
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=2e-3,
                                       err_msg=f"{key} {name}")


def test_train_kcache_env_switch(monkeypatch):
    """``MEDSAM2_TRAIN_KCACHE=1`` turns the cache on when ``use_kcache`` is
    None, as the JAX package reads it; an explicit value wins; off by
    default. With it on, the step's bank is made with the cache."""
    monkeypatch.delenv("MEDSAM2_TRAIN_KCACHE", raising=False)
    assert not TR.Recipe3DConfig().kcache_enabled()
    monkeypatch.setenv("MEDSAM2_TRAIN_KCACHE", "1")
    for use in (None, True, False):
        assert (TR.Recipe3DConfig(use_kcache=use).kcache_enabled()
                == JR.Recipe3DConfig(use_kcache=use).kcache_enabled() == (use is not False))
    shapes = []
    init_bank = TB.init_bank

    def spy(*a, **k):
        shapes.append(k.get("kcache_shape", (0, 0)))
        return init_bank(*a, **k)

    monkeypatch.setattr(TR.mb, "init_bank", spy)
    model = SAM2Model(TINY, seed=0, device="cpu")
    step = TR.make_train_step(model, TR.Recipe3DConfig(**RCFG),
                              TR.make_optimizers(model, TR.Recipe3DConfig(**RCFG)))
    metrics = step({k: np.array(v) for k, v in synth_batch().items()})
    assert np.isfinite(float(metrics["loss"]))
    assert shapes == [(TINY.memory_attention.num_layers, TINY.memory_attention.d_model)]


# ---------------------------------------------------------------------------
# the CLI, with resume
# ---------------------------------------------------------------------------


def test_train_3d_cli_flags():
    """The reference ``train_3d.py`` command parses; a flag no ported CLI
    reads (the JAX CLI's ``-encoder``) is refused, and the 3D CLI refuses
    the 2D nuclei net."""
    from medsam2_tpu_torch.cli.cfg import parse_args

    args = parse_args("-net sam2 -exp_name BTCV -sam_config sam2_hiera_s -image_size 1024 "
                      "-video_length 8 -prompt bbox -prompt_freq 2 -dataset btcv "
                      "-data_path ./data/btcv -sam_ckpt checkpoints/sam2_hiera_small.pt".split())
    assert (args.device, args.prompt, args.video_length) == ("cuda", "bbox", 8)
    for bad in (["-encoder", "vit_b"], ["-net", "pvt"]):
        with pytest.raises(SystemExit):
            parse_args(bad)
    import medsam2_tpu_torch.cli.train_3d as t3

    with pytest.raises(ValueError, match="3D recipe trains sam2"):
        t3.main(["-net", "prompter", "-device", "cpu"])


def test_train_3d_cli_synthetic_and_resume(tmp_path, monkeypatch):
    import medsam2_tpu_torch.cli.train_3d as t3
    from medsam2_tpu_torch.checkpoint.store import latest_step, restore_checkpoint

    monkeypatch.setattr(t3, "get_config", lambda name, **kw: TINY)
    base = ["-dataset", "synthetic", "-image_size", "64", "-video_length", "4",
            "-prompt_freq", "2", "-prompt", "bbox", "-max_objects", "2",
            "-steps_per_epoch", "2", "-val_freq", "1", "-b", "1", "-print_freq", "1",
            "-sam_config", "sam2_hiera_t", "-device", "cpu"]
    model = t3.main(base + ["-logdir", str(tmp_path / "a"), "-epochs", "1", "-profile",
                            "--model-ema"])
    ckpt_dir = glob.glob(str(tmp_path / "a" / "*" / "Model"))[0]
    assert latest_step(ckpt_dir) == 0
    assert glob.glob(str(tmp_path / "a" / "*" / "Log" / "trace.json"))   # -profile
    jl = glob.glob(str(tmp_path / "a" / "*" / "Log" / "scalars.jsonl"))
    assert jl and any("train/" in ln for ln in open(jl[0]))
    assert any("val/dice" in ln for ln in open(jl[0]))

    saved = restore_checkpoint(ckpt_dir, SAM2Model(TINY, seed=5, device="cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    assert set(saved["optimizers"]) == {"sam", "mem"} and saved["epoch"] == 0
    assert saved["optimizers"]["sam"]["state"], "Adam state was not saved"
    ema = saved["ema_params"]                                           # --model-ema
    assert set(ema) == {n for n, _ in model.named_parameters()}
    assert not torch.equal(ema["sam_mask_decoder.iou_token.weight"],
                           model.state_dict()["sam_mask_decoder.iou_token.weight"])

    resumed = t3.main(base + ["-logdir", str(tmp_path / "b"), "-epochs", "2",
                              "-resume", ckpt_dir])
    ckpt_b = glob.glob(str(tmp_path / "b" / "*" / "Model"))[0]
    assert latest_step(ckpt_b) == 1            # epoch 0 came from the checkpoint
    # the resumed run started from the saved weights and kept training them
    moved = [k for k, v in resumed.state_dict().items() if not torch.equal(v, model.state_dict()[k])]
    assert moved and all(k.split(".")[0] in ("sam_mask_decoder", "obj_ptr_proj",
                                             "memory_encoder", "memory_attention",
                                             "mask_downsample") for k in moved)
