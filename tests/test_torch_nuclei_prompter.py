"""The DPA-P2PNet prompter, JAX package against the PyTorch port, on the CPU
at 64 px: the same numpy-seeded inputs through both, weights made by the
JAX init and carried across by ``prompter_state_dict_from_jax``.

- ``grid_sample_points`` on points inside and outside [-1, 1] (the border
  rule; torch's default zero padding would differ outside), to 1e-6;
- ``anchor_points``; ``GroupNorm``;
- the backbone features of resnet18 and pvt_v2_b0, and the FPN, to 1e-4
  of each output's largest |value|;
- the whole forward with BN (random running statistics) and GN mask heads,
  with and without the SAM semantic feature (SR_PFO), resnet18 and
  pvt_v2_b0: coordinates, logits and mask logits to 1e-4 of max;
- the state dict covers every parameter and buffer (strict load), and the
  eval-by-default and device rules (the training forward:
  ``tests/test_torch_nuclei_train.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.prompter import backbone as JB
from medsam2_tpu.prompter import dpa_p2pnet as JD
from medsam2_tpu.prompter.fpn import fpn_apply, fpn_init
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  prompter_state_dict_from_jax)
from medsam2_tpu_torch.prompter import backbone as TB
from medsam2_tpu_torch.prompter import dpa_p2pnet as TD
from medsam2_tpu_torch.prompter.fpn import FPN

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py

TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


@pytest.mark.parametrize("span", [1.0, 1.6], ids=["inside", "outside"])
def test_grid_sample_points_matches_jax(span):
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    coords = rng.uniform(-span, span, (2, 40, 2)).astype(np.float32)
    if span > 1:
        assert (np.abs(coords) > 1).any(axis=-1).sum() >= 10
    want = np.asarray(JD.grid_sample_points(jnp.asarray(feat), jnp.asarray(coords)))
    got = TD.grid_sample_points(torch.from_numpy(feat), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("hw,space", [((64, 64), 16), ((64, 80), 16), ((50, 70), 16),
                                      ((256, 256), 16)])
def test_anchor_points_match_jax(hw, space):
    np.testing.assert_array_equal(TD.anchor_points(*hw, space), JD.anchor_points(*hw, space))


@pytest.mark.parametrize("C", [64, 96, 40])
def test_group_norm_matches_jax(C):
    rng = np.random.default_rng(C)
    x = rng.standard_normal((2, 5, 7, C)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(C).astype(np.float32),
         "bias": rng.standard_normal(C).astype(np.float32)}
    want = JB.group_norm_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = TB.group_norm(torch.from_numpy(x), torch.from_numpy(p["scale"]),
                        torch.from_numpy(p["bias"]))
    _close(got, want, 1e-6)


def _image(seed=0, size=64):
    return np.random.default_rng(seed).standard_normal((1, size, size, 3)).astype(np.float32)


_TREES = {}


def _prompter_pair(backbone, mask_norm="bn", sr_pfo=True):
    """(JAX config, JAX params, port prompter), made once per setting; the
    BN mask head gets random running statistics and affine."""
    key = (backbone, mask_norm, sr_pfo)
    if key not in _TREES:
        jcfg = JD.PrompterConfig(backbone=backbone, mask_norm=mask_norm, use_sr_pfo=sr_pfo)
        p = _np(JD.prompter_init(jax.random.PRNGKey(0), jcfg))
        if mask_norm == "bn":
            rng = np.random.default_rng(1)
            p["mask_head"]["bn"] = {"w": rng.uniform(0.5, 1.5, 256).astype(np.float32),
                                    "b": rng.normal(0, 0.2, 256).astype(np.float32),
                                    "mean": rng.normal(0, 0.2, 256).astype(np.float32),
                                    "var": rng.uniform(0.5, 1.5, 256).astype(np.float32)}
        tcfg = TD.PrompterConfig(backbone=backbone, mask_norm=mask_norm, use_sr_pfo=sr_pfo)
        prompter = TD.Prompter(tcfg, seed=5, device="cpu")
        load_reference_state_dict(prompter, prompter_state_dict_from_jax(p, tcfg))
        _TREES[key] = (jcfg, p, prompter)
    return _TREES[key]


@pytest.mark.parametrize("backbone", ["resnet18", "pvt_v2_b0"])
def test_backbone_features_match_jax(backbone):
    _, p, prompter = _prompter_pair(backbone)
    img = _image(1)
    want = JB.backbone_apply(jax.tree_util.tree_map(jnp.asarray, p["backbone"]),
                             jnp.asarray(img), backbone)
    with torch.no_grad():
        got = prompter.backbone(torch.from_numpy(img))
    assert len(got) == 4
    assert [g.shape[-1] for g in got] == list(TB.backbone_channels(backbone))
    assert [g.shape[1] for g in got] == [16, 8, 4, 2]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("num_outs", [4, 1])
def test_fpn_matches_jax(num_outs):
    rng = np.random.default_rng(2)
    chans = (32, 64, 160, 256)
    feats = [rng.standard_normal((1, 16 >> i, 16 >> i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    p = _np(fpn_init(jax.random.PRNGKey(3), chans, 64))
    want = fpn_apply(jax.tree_util.tree_map(jnp.asarray, p), [jnp.asarray(f) for f in feats],
                     num_outs)
    fpn = FPN(chans, 64, torch.Generator().manual_seed(0))
    sd = {}
    for part in ("lateral", "fpn"):
        for i, cp in enumerate(p[part]):
            sd[f"{part}.{i}.weight"] = torch.from_numpy(cp["w"].transpose(3, 2, 0, 1).copy())
            sd[f"{part}.{i}.bias"] = torch.from_numpy(cp["b"].copy())
    fpn.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = fpn([torch.from_numpy(f) for f in feats], num_outs)
    assert len(got) == len(want) == num_outs
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("backbone", ["resnet18", "pvt_v2_b0"])
@pytest.mark.parametrize("mask_norm", ["bn", "gn"])
@pytest.mark.parametrize("semantic", [False, True], ids=["no_sam_feature", "sam_feature"])
def test_prompter_forward_matches_jax(backbone, mask_norm, semantic):
    jcfg, p, prompter = _prompter_pair(backbone, mask_norm)
    img = _image(2)
    sem = (np.random.default_rng(3).standard_normal((1, 4, 4, 256)).astype(np.float32)
           if semantic else None)
    want, wfeats = JD.prompter_apply(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                                     jnp.asarray(img), None if sem is None else jnp.asarray(sem))
    with torch.no_grad():
        got, gfeats = prompter(torch.from_numpy(img),
                               None if sem is None else torch.from_numpy(sem))
    assert set(got) == {"pred_coords", "pred_logits", "pred_masks"}
    assert tuple(got["pred_coords"].shape) == (1, 16, 2)
    assert tuple(got["pred_masks"].shape) == (1, 64, 64)
    for k in got:
        _close(got[k], want[k])
    for g, w in zip(gfeats, wfeats):
        _close(g, w)


def test_prompter_without_sr_pfo_ignores_the_sam_feature():
    jcfg, p, prompter = _prompter_pair("resnet18", "gn", sr_pfo=False)
    assert prompter.sr_pfo is None and "sr_pfo" not in p
    img = _image(4)
    sem = np.random.default_rng(5).standard_normal((1, 4, 4, 256)).astype(np.float32)
    want, _ = JD.prompter_apply(jax.tree_util.tree_map(jnp.asarray, p), jcfg, jnp.asarray(img),
                                jnp.asarray(sem))
    with torch.no_grad():
        got, _ = prompter(torch.from_numpy(img), torch.from_numpy(sem))
        plain, _ = prompter(torch.from_numpy(img))
    for k in got:
        _close(got[k], want[k])
        assert torch.equal(got[k], plain[k])


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50", "pvt_v2_b0", "pvt_v2_b2"])
def test_state_dict_names_follow_the_jax_tree(backbone):
    """Every JAX leaf lands on a port parameter or buffer of its shape, and
    the port has nothing the tree lacks (checked on shapes alone, without
    running the JAX init of the large backbones)."""
    jcfg = JD.PrompterConfig(backbone=backbone)
    shapes = jax.eval_shape(lambda k: JD.prompter_init(k, jcfg), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = prompter_state_dict_from_jax(zeros, TD.PrompterConfig(backbone=backbone))
    prompter = TD.Prompter(TD.PrompterConfig(backbone=backbone), device="cpu")
    own = prompter.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    with pytest.raises(ValueError):
        prompter_state_dict_from_jax(zeros, TD.PrompterConfig(backbone=backbone,
                                                              mask_norm="gn"))


def test_inference_only_and_card_by_default():
    """Frozen and in eval mode by default: a dropout generator is ignored
    there (the training forward is ``prompter.train()``)."""
    _, _, prompter = _prompter_pair("resnet18")
    with torch.no_grad():
        plain, _ = prompter(torch.from_numpy(_image()))
        drawn, _ = prompter(torch.from_numpy(_image()),
                            dropout_generator=torch.Generator().manual_seed(0))
    assert set(drawn) == set(plain) == {"pred_coords", "pred_logits", "pred_masks"}
    for k in plain:
        assert torch.equal(drawn[k], plain[k])
    assert not any(t.requires_grad for t in prompter.parameters())
    assert not prompter.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.Prompter(TD.PrompterConfig(backbone="resnet18"))
