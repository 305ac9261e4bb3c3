"""The nuclei serving engine, JAX package against the PyTorch port, on the
CPU at TINY (``tests/test_predictors.py``, image size 64) with resnet18 and
pvt_v2_b0 prompters (weights made once by the JAX init and carried across
by ``prompter_state_dict_from_jax`` / ``state_dict_from_jax``).

- ``predict_points`` (with and without the semantic-mask filter);
- ``decode_cells``, logits (to 1e-3, as the SAM heads) and bit-packed
  (equal, away from logits within 1e-3 of 0), with an empty and a
  non-empty bank;
- ``merge_instances`` on random masks, given on their crops with offsets
  and image-sized (zero offsets, JAX's form): equal maps;
- ``predict_instances`` on a 96 x 96 synthetic image, crop 64, overlap 32
  (4 crops: the drop of points in processed crops, the progressive point
  NMS, one bank write per decoded crop and the merge all run), and again
  on a second image against the bank the first wrote: equal instance maps
  and equal banks, unless a mask logit within round-off of 0 took the
  other sign (then AJI >= 0.99 and the bank to the card's phase-15 rule;
  the test names the flips). Both packages read the bank's last valid
  slot (the draws injected through ``read_similarity_bank(indices=...)``);
- ``cli.train_2d.validate_nuclei`` on three 64-px synthetic images: the
  metric dict to 1e-6.

The prompter's class head leans to the foreground (its output bias set to
(1, -1)), so that random weights propose enough points to decode."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.api import nuclei_inference as JNI
from medsam2_tpu.cli import train_2d as JCLI
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu.postproc.amg_utils import batched_mask_to_box
from medsam2_tpu.prompter import dpa_p2pnet as JD
from medsam2_tpu.state import similarity_bank as JSB
from medsam2_tpu.train.recipe_nuclei import NucleiRecipeConfig
from medsam2_tpu_torch.api import nuclei_inference as TNI
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  prompter_state_dict_from_jax,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.cli import train_2d as TCLI
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.data.synthetic import synthetic_nuclei
from medsam2_tpu_torch.metrics.instance import get_fast_aji, remap_label
from medsam2_tpu_torch.prompter import dpa_p2pnet as TD
from medsam2_tpu_torch.state import similarity_bank as TSB
from tests.test_predictors import TINY

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py

CFG = TINY
BANK = 8
BACKBONES = ("resnet18", "pvt_v2_b0")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sam_params():
    return _np(sam2_init(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def port_model(sam_params):
    model = SAM2Model(CFG, seed=1, device="cpu")
    load_reference_state_dict(model, state_dict_from_jax(sam_params, CFG))
    return model


_PROMPTERS = {}


def _prompters(backbone):
    """(JAX params, JAX recipe config, port prompter) for ``backbone``,
    made once per module."""
    if backbone not in _PROMPTERS:
        pcfg = JD.PrompterConfig(backbone=backbone)
        p = _np(JD.prompter_init(jax.random.PRNGKey(1), pcfg))
        p["cls_head"]["out"]["b"] = np.array([1.0, -1.0], np.float32)
        rng = np.random.default_rng(2)
        p["mask_head"]["bn"]["mean"] = rng.normal(0, 0.1, 256).astype(np.float32)
        p["mask_head"]["bn"]["var"] = rng.uniform(0.5, 1.5, 256).astype(np.float32)
        tcfg = TD.PrompterConfig(backbone=backbone)
        prompter = TD.Prompter(tcfg, seed=3, device="cpu")
        load_reference_state_dict(prompter, prompter_state_dict_from_jax(p, tcfg))
        _PROMPTERS[backbone] = (p, NucleiRecipeConfig(prompter=pcfg), prompter)
    return _PROMPTERS[backbone]


def _last_slot_jax(bank, cur, key, n, indices=None):
    idx = jnp.maximum(jnp.sum(bank["valid"]) - 1, 0).reshape(1, 1) * jnp.ones(
        (cur.shape[0], n), jnp.int32)
    return _ORIG_JAX_READ(bank, cur, key, n, indices=idx)


def _last_slot_port(bank, cur, generator, n, indices=None):
    idx = (bank["valid"].sum() - 1).clamp_min(0).reshape(1, 1).expand(cur.shape[0], n)
    return _ORIG_PORT_READ(bank, cur, generator, n, indices=idx)


_ORIG_JAX_READ = JSB.read_similarity_bank
_ORIG_PORT_READ = TSB.read_similarity_bank


@pytest.fixture
def injected(monkeypatch):
    """Both packages draw the bank's last valid slot; the JAX encode is
    re-traced with the patched read (and again after the test)."""
    monkeypatch.setattr(JSB, "read_similarity_bank", _last_slot_jax)
    monkeypatch.setattr(TSB, "read_similarity_bank", _last_slot_port)
    JNI._jit_encode.cache_clear()
    yield
    JNI._jit_encode.cache_clear()


def _banks(seed=None, filled=0):
    """An empty bank of BANK slots (or ``filled`` random ones) in both
    packages."""
    P = CFG.sam_image_embedding_size ** 2
    jb = {k: np.array(v) for k, v in JSB.init_similarity_bank(
        BANK, P, CFG.mem_dim, P * CFG.hidden_dim).items()}
    if filled:
        rng = np.random.default_rng(seed)
        jb["feats"][:filled] = rng.standard_normal((filled, P, CFG.mem_dim))
        jb["embeds"][:filled] = rng.standard_normal((filled, P * CFG.hidden_dim))
        jb["iou"][:filled] = rng.uniform(0.3, 0.9, filled)
        jb["valid"][:filled] = True
    tb = {k: torch.from_numpy(v.copy()) for k, v in jb.items()}
    return {k: jnp.asarray(v) for k, v in jb.items()}, tb


def _same_bank(tb, jb, tol=1e-4):
    np.testing.assert_array_equal(tb["valid"].numpy(), np.asarray(jb["valid"]))
    for key in ("feats", "iou", "embeds"):
        want = np.asarray(jb[key], np.float32)
        got = tb[key].float().numpy()
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0), key


def _image(seed, size):
    return synthetic_nuclei(np.random.default_rng(seed), size=size, num_cells=10)["image"]


def test_crop_with_overlap_matches_jax():
    for args in ((96, 96, 64, 32), (1000, 1000, 256, 64), (64, 64, 64, 64), (300, 257, 256, 0),
                 (50, 40, 64, 16)):
        assert TNI.crop_with_overlap(*args) == JNI.crop_with_overlap(*args)
    assert len(TNI.crop_with_overlap(1000, 1000, 256, 64)) == 25


@pytest.mark.parametrize("backbone", BACKBONES)
@pytest.mark.parametrize("filtering", [False, True], ids=["all", "filtered"])
def test_predict_points_matches_jax(backbone, filtering):
    p, rcfg, prompter = _prompters(backbone)
    img = _image(0, 64)[None]
    jp, js = JNI.predict_points({"prompter": p}, rcfg, jnp.asarray(img), filtering=filtering)
    tp, ts = TNI.predict_points(prompter, torch.from_numpy(img), filtering=filtering)
    assert len(tp) == len(jp) and (filtering or len(tp) >= 4)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(ts, js, atol=1e-5)


@pytest.mark.parametrize("nonempty", [False, True], ids=["empty_bank", "bank"])
def test_decode_cells_matches_jax(sam_params, port_model, injected, nonempty):
    jb, tb = _banks(seed=4, filled=3 if nonempty else 0)
    img = _image(1, 64)[None]
    pts = np.random.default_rng(5).uniform(2, 62, (70, 2)).astype(np.float32)  # 2 chunks of 64
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    key = jax.random.PRNGKey(0)
    jl, ji = JNI.decode_cells({"sam2": sam_params}, CFG, pts, jb, key, jimg, nonempty)
    tl, ti = TNI.decode_cells(port_model, pts, tb, None, timg, nonempty)
    assert tl.shape == jl.shape == (70, 64, 64)
    np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(ti, ji, atol=1e-3)
    jm, _ = JNI.decode_cells({"sam2": sam_params}, CFG, pts, jb, key, jimg, nonempty, binary=True)
    tm, _ = TNI.decode_cells(port_model, pts, tb, None, timg, nonempty, binary=True)
    assert tm.dtype == bool and tm.shape == jm.shape
    sure = np.abs(jl) > 1e-3
    np.testing.assert_array_equal(tm[sure], jm[sure])
    np.testing.assert_array_equal(tm, tl > 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_instances_matches_jax(seed):
    """Random overlapping discs from four 40-px crops of a 64-px image, some
    points decoded in two crops, some masks empty."""
    rng = np.random.default_rng(seed)
    H = W = 64
    crops = [(0, 0), (24, 0), (0, 24), (24, 24)]
    yy, xx = np.mgrid[0:40, 0:40]
    local, offsets, pids = [], [], []
    for i in range(30):
        cy, cx, r = rng.uniform(0, 40), rng.uniform(0, 40), rng.uniform(0, 9)
        local.append(((yy - cy) ** 2 + (xx - cx) ** 2) < r * r)
        offsets.append(crops[i % 4])
        pids.append(int(rng.integers(0, 20)))
    full = []
    for m, (x0, y0) in zip(local, offsets):
        g = np.zeros((H, W), bool)
        g[y0:y0 + 40, x0:x0 + 40] = m
        full.append(g)
    scores = rng.random(30).astype(np.float32)
    boxes = batched_mask_to_box(np.stack(full))
    want = JNI.merge_instances(full, scores, boxes, np.array(pids), (H, W), 0.6)
    assert want.max() > 3
    for masks, offs in ((local, offsets), (full, [(0, 0)] * len(full))):
        np.testing.assert_array_equal(
            TNI.merge_instances(masks, offs, scores, boxes, np.array(pids), (H, W), 0.6), want)


def _recording(monkeypatch, module, store):
    """Wrap ``module.decode_cells`` to keep each call's logits as well."""
    orig = module.decode_cells

    def wrapped(*a, **k):
        store.append(orig(*a, **{**k, "binary": False, "return_memory": False})[0])
        return orig(*a, **k)

    monkeypatch.setattr(module, "decode_cells", wrapped)


def _flips(jl, tl):
    """The mask pixels whose sign differs between the packages, and the
    largest |JAX logit| among them."""
    n, worst = 0, 0.0
    for a, b in zip(jl, tl):
        f = (a > 0) != (b > 0)
        n += int(f.sum())
        worst = max(worst, float(np.abs(a[f]).max(initial=0.0)))
    return n, worst


@pytest.mark.parametrize("backbone", BACKBONES)
def test_predict_instances_matches_jax(sam_params, port_model, injected, monkeypatch, backbone):
    """Equal instance maps and banks. A logit within round-off of 0 (the
    packages agree to ~4e-7 here) can take the other sign in the port; the
    bank's memory of that crop then moves, as the card's phase 15 sees.
    Then the flips must all lie within 1e-5 of 0, the maps agree in AJI >=
    0.99, the bank's memory features in relative L2 to 5e-3 and its
    embeddings and IoUs to 1e-3 of their largest value."""
    p, rcfg, prompter = _prompters(backbone)
    params = {"sam2": sam_params, "prompter": p}
    jb, tb = _banks()
    key = jax.random.PRNGKey(7)
    jl, tl = [], []
    _recording(monkeypatch, JNI, jl)
    _recording(monkeypatch, TNI, tl)
    for seed in (2, 3):
        sample = {"image": _image(seed, 96)}
        assert len(JNI.crop_with_overlap(96, 96, 64, 32)) == 4
        want = JNI.predict_instances(params, CFG, rcfg, sample, jb, key, overlap=32)
        got = TNI.predict_instances(port_model, prompter, sample, tb, None, overlap=32)
        assert got.dtype == want.dtype == np.int32
        assert want.max() >= 4 and len(jl) == len(tl) >= 2
        flips, worst = _flips(jl, tl)
        if flips == 0:
            np.testing.assert_array_equal(got, want)
            _same_bank(tb, jb)
            continue
        assert worst <= 1e-5, f"{flips} mask pixels differ in sign, |logit| up to {worst}"
        assert get_fast_aji(remap_label(want), remap_label(got)) >= 0.99
        np.testing.assert_array_equal(tb["valid"].numpy(), np.asarray(jb["valid"]))
        feats = np.asarray(jb["feats"])
        assert np.linalg.norm(tb["feats"].numpy() - feats) <= 5e-3 * np.linalg.norm(feats)
        for k in ("embeds", "iou"):
            want_k = np.asarray(jb[k])
            assert np.abs(tb[k].numpy() - want_k).max() <= 1e-3 * np.abs(want_k).max(), k
    assert int(tb["valid"].sum()) >= 4


def test_validate_nuclei_matches_jax(sam_params, port_model, injected, tmp_path):
    p, rcfg, prompter = _prompters("resnet18")
    rng = np.random.default_rng(9)
    val = [synthetic_nuclei(rng, size=64, num_cells=6) for _ in range(3)]
    args = argparse.Namespace(val_max_samples=3, point_filtering=False, vis=False)
    jb, tb = _banks()
    want = JCLI.validate_nuclei(args, CFG, rcfg, {"sam2": sam_params, "prompter": p}, val, jb,
                                jax.random.PRNGKey(0))
    got = TCLI.validate_nuclei(args, port_model, prompter, val, tb, None)
    assert set(got) == set(want) == {"dice1", "dice2", "aji", "aji_plus", "dq", "sq", "pq"}
    assert want["dice1"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    _same_bank(tb, jb)
    # -vis: the agreement map and the instance overlay of each image, as JAX
    pytest.importorskip("matplotlib")
    vis_args = argparse.Namespace(val_max_samples=1, vis=True, _sample_dir=str(tmp_path))
    TCLI.validate_nuclei(vis_args, port_model, prompter, val, tb, None)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["val0_compare.png", "val0_inst.png"]
