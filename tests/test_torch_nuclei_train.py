"""The nuclei training slice, JAX package against the PyTorch port, on the CPU
at TINY (``tests/test_predictors.py``, 64 px, loss at 64 px) with a resnet18
prompter, memory-attention dropout 0 and head dropout 0. Weights are made
once by the JAX init and carried over by ``state_dict_from_jax`` /
``prompter_state_dict_from_jax``.

- ``augment_nuclei`` equal, tiles smaller than the crop, 1-px tiles, empty
  and sparse maps (crop retries) included; the augmented MoNuSeg reader is
  in ``tests/test_torch_nuclei_data.py``;
- ``hungarian_match_host`` equal, -1 padding included;
- ``criterion_losses`` to 1e-6 rel on padded inputs (the two focal terms to
  1e-6 of a float64 evaluation and 5e-6 of JAX's, whose fp32 sum is off by
  up to 1.9e-6);
- the sampler's gradient outside [-1, 1] (zero under both rules) and
  inside, to 1e-5;
- the prompter's training forward at rate 0 against ``prompter_apply(...,
  dropout_key=...)`` to 1e-5 of each output's max|value|, ``mask_bn_stats``
  included, and its gradients against ``jax.grad`` to 1e-4 of each leaf's
  max|grad|; the dropout rate and scale on their own;
- ``forward_nuclei`` on a non-empty bank with the JAX package's draws
  injected: cell logits and IoUs to 1e-4 abs, the prompt points to 1e-5,
  the bank; then, in the same test,
- two steps against JAX ``matcher_mode="precompute"`` (its float64 cost, the
  port's) with the draws injected, on noise images under synthetic cells
  (a head MLP's ReLU inputs asserted farther than 1e-6 from the kink):
  each loss to rtol 1e-5, the clipped gradients (``test_torch_recipe_2d.py``'s
  rule, 1e-4 of each leaf's max|grad|; leaves that are zero in exact
  arithmetic to 1e-6 of the largest gradient), the
  parameters after AdamW, the BN running statistics and the bank; the JAX
  gradients are the ones its AdamW received, recorded by a transformation
  chained in front of it;
- the CLI for ``-net prompter -dataset synthetic`` and ``-dataset monuseg``
  on a directory the test writes, ``-device cpu``, ``get_config`` patched to
  TINY, and the best-Dice / best-AJI checkpoints of both modules."""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medsam2_tpu_torch.cli.train_2d as t2
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu.data import augment as JA
from medsam2_tpu.prompter import criterion as JC
from medsam2_tpu.prompter import dpa_p2pnet as JD
from medsam2_tpu.prompter import matcher as JMA
from medsam2_tpu.state import similarity_bank as JSB
from medsam2_tpu.train import recipe_nuclei as JN
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  prompter_state_dict_from_jax,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.checkpoint.store import restore_checkpoint
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.data import augment as TA
from medsam2_tpu_torch.data.monuseg import pack_nuclei_batch
from medsam2_tpu_torch.data.synthetic import synthetic_nuclei
from medsam2_tpu_torch.prompter import criterion as TC
from medsam2_tpu_torch.prompter import dpa_p2pnet as TD
from medsam2_tpu_torch.prompter import matcher as TMA
from medsam2_tpu_torch.train import recipe_2d as TR2
from medsam2_tpu_torch.train import recipe_nuclei as TN
from tests.test_predictors import TINY
from tests.test_torch_nuclei_data import _write_monuseg
from tests.test_torch_video_session import no_persistent_cache_writes  # noqa: F401

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py

CFG = dataclasses.replace(TINY, memory_attention=dataclasses.replace(TINY.memory_attention,
                                                                     dropout=0.0))
B, M, S, K = 2, 6, 64, 8
RCFG = dict(memory_bank_size=K, max_cells=M, out_size=S)
JCFG = JN.NucleiRecipeConfig(prompter=JD.PrompterConfig(backbone="resnet18", dropout=0.0), **RCFG)
TCFG = TN.NucleiRecipeConfig(prompter=TD.PrompterConfig(backbone="resnet18", dropout=0.0), **RCFG)
INDICES = np.array([[2, 0], [1, 1]])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def prompter_params():
    """The JAX prompter's params as numpy (``prompter_init`` under one jit,
    faster than eager here), the mask head's BN with random affine and
    running statistics."""
    p = _np(jax.jit(lambda k: JD.prompter_init(k, JCFG.prompter))(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    p["mask_head"]["bn"] = {
        "w": rng.uniform(0.5, 1.5, 256).astype(np.float32),
        "b": rng.normal(0, 0.2, 256).astype(np.float32),
        "mean": rng.normal(0, 0.2, 256).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, 256).astype(np.float32)}
    return p


@pytest.fixture(scope="module")
def params(prompter_params):
    """The JAX joint params as numpy (``init_joint_params``' two halves)."""
    return {"sam2": _np(jax.jit(lambda k: sam2_init(k, CFG))(jax.random.PRNGKey(0))),
            "prompter": prompter_params}


@pytest.fixture(scope="module")
def inject():
    """The JAX package's bank reads draw ``INDICES`` (its read goes through
    the module attribute), for the module's tests."""
    orig = JSB.read_similarity_bank
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSB, "read_similarity_bank",
                   lambda bank, cur, key, n, indices=None: orig(bank, cur, key, n,
                                                                indices=jnp.asarray(INDICES)))
        yield


def _port_prompter(p):
    prompter = TD.Prompter(TCFG.prompter, seed=2, device="cpu")
    load_reference_state_dict(prompter, prompter_state_dict_from_jax(p, TCFG.prompter))
    return prompter


def _port(params):
    model = SAM2Model(CFG, seed=1, device="cpu")
    load_reference_state_dict(model, state_dict_from_jax(params["sam2"], CFG))
    return model, _port_prompter(params["prompter"])


def _batch(seed, textured=False):
    """Two synthetic 64-px images packed into 6 cell slots: the first has
    more cells than slots, the second fewer (padding). ``textured`` swaps the
    images for unit-normal noise under the same cells (see
    ``test_two_train_steps_match_jax``)."""
    rng = np.random.default_rng(seed)
    batch = pack_nuclei_batch([synthetic_nuclei(rng, S, 8), synthetic_nuclei(rng, S, 3)], S, S,
                              M)
    assert batch["gt_valid"][0].all() and 0 < batch["gt_valid"][1].sum() < M
    if textured:
        batch["images"] = rng.standard_normal(batch["images"].shape).astype(np.float32)
    return batch


def _bank_np(seed, filled=3):
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


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


# a head MLP's hidden pre-activation this close to 0 may fall on the other
# side of the ReLU in the two packages (they agree to ~1e-7), and the
# gradients then take the other subgradient: one such element at -2.2e-7
# moved deform_layer.l1's gradient by 19 % of its max. The gradient tests
# assert that every one stays farther from 0.
KINK = 1e-6


class _HeadMargin:
    """Records the smallest |pre-activation| of the prompter's head MLPs'
    hidden layers over the forwards run while it is open."""

    def __init__(self, prompter):
        self.prompter, self.least = prompter, float("inf")

    def _hook(self, module, inputs, out):
        self.least = min(self.least, out.detach().abs().min().item())

    def __enter__(self):
        self.handles = [head.l1.register_forward_hook(self._hook) for head in
                        (self.prompter.deform_layer, self.prompter.reg_head,
                         self.prompter.cls_head)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        assert exc[0] is not None or self.least > KINK, (
            f"a head ReLU input at {self.least:.1e}, within {KINK:.0e} of its kink")


# ---------------------------------------------------------------------------
# augmentation, matcher, criterion
# ---------------------------------------------------------------------------

def _tile(seed, H, W, cells):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    inst = np.zeros((H, W), np.int32)
    yy, xx = np.ogrid[:H, :W]
    for pid in range(1, cells + 1):
        cy, cx, r = rng.integers(0, H), rng.integers(0, W), int(rng.integers(2, 6))
        inst[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = pid
    return img, inst


@pytest.mark.parametrize("H,W,cells,crop", [
    (300, 280, 20, 128),      # larger than the crop
    (100, 120, 6, 256),       # smaller: reflect padding in chunks
    (1, 50, 0, 64),           # a 1-px dim: edge padding; an empty map
    (400, 400, 1, 128),       # one cell: crops retried for it
], ids=["large", "small", "one_px_empty", "sparse"])
def test_augment_nuclei_matches_jax(H, W, cells, crop):
    img, inst = _tile(H + W, H, W, cells)
    if cells == 1:
        inst[:] = 0
        inst[200:230, 200:230] = 1
    cfg_j = JA.NucleiAugmentConfig(crop_size=crop)
    cfg_t = TA.NucleiAugmentConfig(crop_size=crop)
    for seed in range(6):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        wi, wm = JA.augment_nuclei(img, inst, cfg_j, rj)
        gi, gm = TA.augment_nuclei(img, inst, cfg_t, rt)
        assert gi.shape == (crop, crop, 3) and gm.shape == (crop, crop)
        assert gi.dtype == np.float32 and gm.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert rt.random() == rj.random()          # the same number of draws
    if cells == 1:                                 # the retries found the cell
        hits = sum(TA.augment_nuclei(img, inst, cfg_t, np.random.default_rng(s))[1].max() > 0
                   for s in range(6))
        assert hits >= 1


@pytest.mark.parametrize("seed,valid", [(0, "prefix"), (1, "scattered"), (2, "none")])
def test_hungarian_match_host_matches_jax(seed, valid):
    rng = np.random.default_rng(seed)
    Bm, N, Mm = 3, 16, 7
    coords = rng.uniform(0, 64, (Bm, N, 2)).astype(np.float32)
    logits = rng.standard_normal((Bm, N, 2)).astype(np.float32)
    gt = rng.uniform(0, 64, (Bm, Mm, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (Bm, Mm)).astype(np.int32)
    if valid == "prefix":
        gv = np.arange(Mm)[None] < np.array([[7], [3], [0]])
    elif valid == "scattered":
        gv = rng.random((Bm, Mm)) < 0.5
    else:
        gv = np.zeros((Bm, Mm), bool)
    mcfg_j, mcfg_t = JMA.MatcherConfig(), TMA.MatcherConfig()
    want = JMA.hungarian_match_host(mcfg_j, coords, logits, gt, labels, gv)
    got = TMA.hungarian_match_host(mcfg_t, coords, logits, gt, labels, gv)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[~gv] == -1).all() and (got[gv] >= 0).all()
    for b in range(Bm):
        assert len(set(got[b][gv[b]])) == gv[b].sum()        # one prediction a slot


def _focal64(logits, target):
    """``binary_focal_loss`` in float64 numpy."""
    x, t = np.asarray(logits, np.float64), np.asarray(target, np.float64)
    ce = t * np.logaddexp(0, -x) + (1 - t) * np.logaddexp(0, x)
    return float(np.mean((1 - np.exp(-ce)) ** 2 * ce))


def test_criterion_losses_match_jax():
    rng = np.random.default_rng(3)
    N, H, R = 16, 32, B * M
    gv = np.arange(M)[None] < np.array([[M], [2]])
    outputs = {"pred_coords": rng.uniform(0, 64, (B, N, 2)).astype(np.float32),
               "pred_logits": rng.standard_normal((B, N, 2)).astype(np.float32),
               "pred_masks": rng.standard_normal((B, H, H)).astype(np.float32) * 3}
    gt_points = rng.uniform(0, 64, (B, M, 2)).astype(np.float32)
    gt_labels = np.zeros((B, M), np.int32)
    sem = (rng.random((B, H, H)) < 0.3).astype(np.float32)
    src = JMA.hungarian_match_host(JMA.MatcherConfig(), outputs["pred_coords"],
                                   outputs["pred_logits"], gt_points, gt_labels, gv)
    vm = gv.reshape(R)
    sam_pred = np.where(vm[:, None, None], rng.standard_normal((R, H, H)) * 4, -1e9)
    sam_pred = sam_pred.astype(np.float32)
    sam_gt = np.where(vm[:, None, None], rng.random((R, H, H)) < 0.2, 0).astype(np.float32)
    sam_iou = np.where(vm, rng.random(R), 1.0).astype(np.float32)
    args = (gt_points, gt_labels, gv, sem, src, sam_pred, sam_iou, sam_gt)
    want = JC.criterion_losses(JC.CriterionConfig(), _jnp(outputs), *map(jnp.asarray, args))
    got = TC.criterion_losses(TC.CriterionConfig(),
                              {k: torch.from_numpy(v) for k, v in outputs.items()},
                              *map(torch.from_numpy, args))
    assert set(got) == set(want)
    for k in want:
        if k in ("loss_mask", "loss_dice"):
            # focal: the JAX package's fp32 evaluation sits 1.1-1.9e-6 from
            # the float64 value, the port's within 1e-7; the port is held to
            # the float64 value at 1e-6 and to JAX at 5e-6
            logits, target = ((outputs["pred_masks"], sem) if k == "loss_mask"
                              else (sam_pred, sam_gt))
            np.testing.assert_allclose(float(got[k]), _focal64(logits, target) * 20 ** (
                k == "loss_mask"), rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=5e-6, err_msg=k)
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    # a padded slot scatters into the dropped column: query 0 stays background
    assert src[1, 2:].tolist() == [-1] * (M - 2) and 0 not in src[1, :2]


# ---------------------------------------------------------------------------
# the prompter's training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [1.0, 1.6], ids=["inside", "outside"])
def test_grid_sample_points_gradient_matches_jax(span):
    """Border sampling: the coordinate gradient is zero outside [-1, 1] under
    both rules (the JAX sampler clips the neighbours and keeps the weights,
    torch's border clips the coordinate); inside they agree."""
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    coords = rng.uniform(-span, span, (2, 40, 2)).astype(np.float32)
    w = rng.standard_normal((2, 40, 5)).astype(np.float32)
    jf, jc = jax.grad(lambda f, c: jnp.sum(JD.grid_sample_points(f, c) * w), argnums=(0, 1))(
        jnp.asarray(feat), jnp.asarray(coords))
    f = torch.from_numpy(feat).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    (TD.grid_sample_points(f, c) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jc), atol=1e-5)
    outside = np.abs(coords) > 1
    if span > 1:
        assert outside.sum() >= 10
        assert (c.grad.numpy()[outside] == 0).all() and (np.asarray(jc)[outside] == 0).all()


def test_prompter_training_forward_and_gradients_match_jax(prompter_params):
    """Rate 0 with a dropout key: the mask head normalises with the batch
    statistics (and reports them); the gradients of a weighted sum of the
    three outputs with respect to every prompter parameter."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    wc, wl, wm = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, 16, 2), (B, 16, 2), (B, S, S)))

    def jloss(p):
        out, _ = JD.prompter_apply(p, JCFG.prompter, jnp.asarray(img), None,
                                   dropout_key=jax.random.PRNGKey(0))
        loss = (jnp.sum(out["pred_coords"] * wc) + jnp.sum(out["pred_logits"] * wl)
                + jnp.sum(out["pred_masks"] * wm))
        return loss, out

    (jl, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_jnp(prompter_params))
    prompter = _port_prompter(prompter_params)
    prompter.requires_grad_(True)
    prompter.train()
    with _HeadMargin(prompter):
        got, _ = prompter(torch.from_numpy(img), dropout_generator=torch.Generator())
    assert set(got) == set(want) == {"pred_coords", "pred_logits", "pred_masks", "mask_bn_stats"}
    for k in ("pred_coords", "pred_logits", "pred_masks"):
        _close(got[k], want[k], 1e-5)
    for k in ("mean", "var"):
        _close(got["mask_bn_stats"][k], want["mask_bn_stats"][k], 1e-5)
    loss = ((got["pred_coords"] * torch.from_numpy(wc)).sum()
            + (got["pred_logits"] * torch.from_numpy(wl)).sum()
            + (got["pred_masks"] * torch.from_numpy(wm)).sum())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    loss.backward()
    ref = prompter_state_dict_from_jax(_np(jg), TCFG.prompter)
    largest = max(np.abs(v).max() for v in ref.values())
    reached = 0
    for name, p in prompter.named_parameters():
        want_g, got_g = ref[name].reshape(p.shape), p.grad
        if name == "mask_head.conv1.bias":
            # zero in exact arithmetic: the batch mean takes the bias out
            assert max(np.abs(want_g).max(), got_g.abs().max().item()) <= 1e-6 * largest
        elif not np.abs(want_g).max():
            # not reached: SR_PFO without a SAM feature, the single-level
            # FPN's coarser convolutions
            assert got_g is None and name.startswith(("sr_pfo.", "neck1.")), name
        else:
            _close(got_g, want_g, 1e-4)
            reached += 1
    assert reached > 60


def test_head_dropout_rate_and_scale():
    """Inverted dropout at the config's rate after each hidden ReLU, drawn
    from the generator; none at eval, without a generator, or at rate 0."""
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    y = TD.head_dropout(x, 0.1, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(TD.head_dropout(x, 0.1, torch.Generator().manual_seed(0)), y)
    assert TD.head_dropout(x, 0.1, None) is x and TD.head_dropout(x, 0.0, gen) is x

    prompter = TD.Prompter(TD.PrompterConfig(backbone="resnet18", dropout=0.5), seed=0,
                           device="cpu")
    img = torch.from_numpy(np.random.default_rng(6).standard_normal((1, S, S, 3)).astype(
        np.float32))
    with torch.no_grad():
        eval_out, _ = prompter(img, dropout_generator=torch.Generator().manual_seed(1))
        prompter.train()
        plain, _ = prompter(img)
        drop1, _ = prompter(img, dropout_generator=torch.Generator().manual_seed(1))
        drop2, _ = prompter(img, dropout_generator=torch.Generator().manual_seed(1))
    assert "mask_bn_stats" not in eval_out and "mask_bn_stats" in plain
    assert not torch.equal(drop1["pred_coords"], plain["pred_coords"])
    assert torch.equal(drop1["pred_coords"], drop2["pred_coords"])
    # the mask head has no dropout: its output follows the batch statistics alone
    assert torch.equal(drop1["pred_masks"], plain["pred_masks"])


# ---------------------------------------------------------------------------
# the joint forward, two steps, the CLI
# ---------------------------------------------------------------------------

def _record():
    """An optax transformation that keeps the updates it is given (the
    clipped gradients) as its state, chained in front of AdamW."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step in precompute mode (float64 host matching), its AdamW
    behind the recorder; compiled once per bank state at first call."""
    tx = optax.chain(_record(), JN.make_optimizer_nuclei(JCFG))
    return tx, JN.make_train_step_nuclei(CFG, JCFG, tx, matcher_mode="precompute")


ZERO_IN_EXACT = ("prompter.mask_head.conv1.bias",)


def _check_grads(model, prompter, ref, step):
    named = TN.named_trainables(model, prompter)
    assert {n for n, _ in named} <= set(ref)
    # what the port leaves out of its optimizer: the prompt encoder
    # (frozen in JAX, its Fourier matrix included) and the BN buffers
    assert all(n.startswith(("sam_prompt_encoder.", "prompter.mask_head.bn.running_"))
               for n in set(ref) - {n for n, _ in named})
    largest = max(float(np.abs(ref[n]).max()) for n, _ in named)
    reached = set()
    for name, p in named:
        want = ref[name].reshape(p.shape)
        got = p.grad.numpy()
        if _zero_in_exact(name):
            # zero in exact arithmetic (the batch mean takes the bias out;
            # softmax is invariant to a key bias): round-off on both sides
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * largest, name
        elif not np.abs(want).max():
            assert not np.abs(got).max(), f"step {step} {name}: not reached in JAX"
        else:
            err = float(np.abs(got - want).max() / np.abs(want).max())
            assert err <= 1e-4, f"step {step} {name}: {err:.2e}"
            reached.add(name.split(".")[0])
    assert {"prompter", "image_encoder", "sam_mask_decoder"} <= reached
    assert ("memory_attention" in reached) == (step == 1)
    assert "memory_encoder" not in reached


def _zero_in_exact(name):
    return name in ZERO_IN_EXACT or (name.startswith("sam_mask_decoder.")
                                     and name.endswith("k_proj.bias"))


def _check_params(model, prompter, ref, steps, lr):
    for name, p in TN.named_trainables(model, prompter):
        diff = np.abs(p.detach().numpy() - ref[name].reshape(p.shape))
        assert diff.max() <= 2 * lr * steps + 1e-6, name
        # Adam steps a leaf whose gradient is round-off by the round-off's sign
        assert _zero_in_exact(name) or np.median(diff) <= 1e-7, name
    for name, p in model.sam_prompt_encoder.state_dict().items():     # frozen in both
        np.testing.assert_array_equal(p.numpy(), ref[f"sam_prompt_encoder.{name}"].reshape(
            p.shape), err_msg=name)
    for k in ("running_mean", "running_var"):
        _close(getattr(prompter.mask_head.bn, k), ref[f"prompter.mask_head.bn.{k}"], 1e-5)


def _flat(tree):
    return {**state_dict_from_jax(tree["sam2"], CFG),
            **{f"prompter.{k}": v for k, v in
               prompter_state_dict_from_jax(tree["prompter"], TCFG.prompter).items()}}


def _forward_nuclei_matches_jax(params):
    """``forward_nuclei`` on a non-empty bank (the drawn memories condition
    the image), all B x M cell slots in one decoder call through
    ``image_indices``."""
    batch, bank = _batch(7), _bank_np(8)
    jout, jcells, jious, jnear, jbank = jax.jit(
        lambda p, b, k: JN.forward_nuclei(p, CFG, JCFG, b, k, jax.random.PRNGKey(3), True,
                                          dropout_key=jax.random.PRNGKey(4)))(
        _jnp(params), _jnp(batch), _jnp(bank))
    model, prompter = _port(params)
    prompter.train()
    with torch.no_grad():
        tout, tcells, tious, tnear, tbank = TN.forward_nuclei(
            model, prompter, TCFG, {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in bank.items()}, None, True,
            indices=torch.from_numpy(INDICES))
    assert tuple(tcells.shape) == (B, M, S, S) and tuple(tious.shape) == (B, M)
    np.testing.assert_allclose(tnear.numpy(), np.asarray(jnear), atol=1e-5)
    assert (tnear.numpy()[~batch["gt_valid"]] == 0).all()
    np.testing.assert_allclose(tcells.numpy(), np.asarray(jcells), atol=1e-4)
    np.testing.assert_allclose(tious.numpy(), np.asarray(jious), atol=1e-4)
    _close(tout["pred_coords"], jout["pred_coords"], 1e-5)
    _same_bank(tbank, jbank)
    assert int(tbank["valid"].sum()) == 3 + B


def test_forward_nuclei_and_two_train_steps_match_jax(params, inject, jax_step):
    """``forward_nuclei`` first (one test, so that a worker makes the JAX
    SAM2 weights once), then the two steps. The steps run on noise images
    under synthetic cells: on the flat synthetic images one ReLU input
    within round-off of 0 (about one in 10^5 a layer) takes the other side
    in the two packages, and with the flat background's contributions
    cancelling it moved backbone gradients by up to 5 % of their max
    (measured per loss); on noise images they agree to 6e-6."""
    _forward_nuclei_matches_jax(params)
    tx, jstep = jax_step
    model, prompter = _port(params)
    opt = TN.make_optimizer_nuclei(model, prompter, TCFG)
    step = TN.make_train_step_nuclei(model, prompter, TCFG, opt)
    P = CFG.sam_image_embedding_size ** 2
    jbank = JSB.init_similarity_bank(K, P, CFG.mem_dim, P * CFG.hidden_dim)
    tbank = TR2.init_bank(model, K)
    jp = _jnp(params)
    jopt = tx.init(jp)
    for i, nonempty in enumerate((False, True)):
        batch = _batch(12 + i, textured=True)
        jp, jopt, jbank, jm = jstep(jp, jopt, _jnp(batch), jbank, jax.random.PRNGKey(20 + i),
                                    bank_nonempty=nonempty)
        with _HeadMargin(prompter):
            tbank, tm = step(batch, tbank, nonempty, indices=torch.from_numpy(INDICES))
        assert set(tm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {name}")
        _check_grads(model, prompter, _flat(_np(jopt[0])), i)
        _check_params(model, prompter, _flat(_np(jp)), i + 1, TCFG.lr)
        _same_bank(tbank, jbank)
    assert int(tbank["valid"].sum()) == 2 * B
    assert prompter.training


BASE = ["-net", "prompter", "-image_size", "64", "-out_size", "64", "-epochs", "1",
        "-steps_per_epoch", "2", "-val_freq", "1", "-b", "2", "-print_freq", "1",
        "-device", "cpu", "-val_max_samples", "1", "-max_cells", "4", "-memory_bank_size", "4"]


def _run(monkeypatch, argv):
    monkeypatch.setattr(t2, "get_config", lambda name, **kw: TINY)
    calls = {"step": 0, "val": 0}
    step, val = t2.recipe_nuclei.make_train_step_nuclei, t2.validate_nuclei

    def counted_step(*a, **k):
        inner = step(*a, **k)

        def run(*b, **kw):
            calls["step"] += 1
            return inner(*b, **kw)

        return run

    def counted_val(args, model, prompter, val_ds, bank, gen):
        assert not prompter.training
        calls["val"] += 1
        return val(args, model, prompter, val_ds, bank, gen)

    monkeypatch.setattr(t2.recipe_nuclei, "make_train_step_nuclei", counted_step)
    monkeypatch.setattr(t2, "validate_nuclei", counted_val)
    return t2.main(argv), calls


@pytest.mark.parametrize("dataset", ["synthetic", "monuseg"])
def test_train_2d_cli_nuclei(tmp_path, monkeypatch, dataset):
    """The resnet50 prompter and TINY SAM2 train two steps and validate one
    image; the checkpoints hold both modules."""
    argv = BASE + ["-dataset", dataset, "-logdir", str(tmp_path / "logs")]
    if dataset == "monuseg":
        root = tmp_path / "MoNuSeg"
        # training tiles larger than the crop (the augmentation crops them),
        # test images of one crop
        _write_monuseg(str(root), "train", "images", "labels", n=4, size=80)
        _write_monuseg(str(root), "test", "images", "labels", n=2, size=64)
        argv += ["-data_path", str(root)]
    (model, prompter), calls = _run(monkeypatch, argv)
    assert model.device.type == "cpu" and prompter.cfg.backbone == "resnet50"
    assert calls == {"step": 2, "val": 1}
    rows = [json.loads(ln) for ln in open(glob.glob(str(tmp_path / "logs" / "*" / "Log" /
                                                        "scalars.jsonl"))[0])]
    assert any("train/loss_cls" in str(r) for r in rows) and any("val/aji" in str(r)
                                                                 for r in rows)
    assert not any(p.requires_grad for p in model.sam_prompt_encoder.parameters())
    assert all(p.requires_grad for p in prompter.parameters())
    ckpts = glob.glob(str(tmp_path / "logs" / "*" / "Model" / "best_*.pt"))
    for path in ckpts:
        m2 = SAM2Model(TINY, seed=9, device="cpu")
        p2 = TD.Prompter(prompter.cfg, seed=9, device="cpu")
        state = restore_checkpoint(path, m2)
        load_reference_state_dict(p2, state["prompter"])
        assert state["epoch"] == 0 and os.path.basename(path) in ("best_dice.pt", "best_aji.pt")
        for a, b in zip(p2.state_dict().values(), prompter.state_dict().values()):
            assert torch.equal(a, b)


def test_checkpoint_holds_both_modules(tmp_path):
    """``save_checkpoint(..., prompter=, name=)`` writes ``<name>.pt`` with
    both state dicts: ``restore_checkpoint`` reads the model, the
    ``"prompter"`` entry loads into a prompter."""
    from medsam2_tpu_torch.checkpoint.store import save_checkpoint

    model = SAM2Model(TINY, seed=3, device="cpu")
    prompter = TD.Prompter(TCFG.prompter, seed=3, device="cpu")
    with torch.no_grad():
        prompter.mask_head.bn.running_mean.add_(0.5)
    path = save_checkpoint(str(tmp_path), model, {}, 4, prompter=prompter, name="best_aji")
    assert os.path.basename(path) == "best_aji.pt"
    m2 = SAM2Model(TINY, seed=4, device="cpu")
    p2 = TD.Prompter(TCFG.prompter, seed=4, device="cpu")
    state = restore_checkpoint(path, m2)
    load_reference_state_dict(p2, state["prompter"])
    assert state["epoch"] == 4
    for mine, theirs in ((m2, model), (p2, prompter)):
        for (ka, a), (kb, b) in zip(mine.state_dict().items(), theirs.state_dict().items()):
            assert ka == kb and torch.equal(a, b), ka
