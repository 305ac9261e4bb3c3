"""The 2D image path, JAX package against the PyTorch port, on CPU at TINY:
``SAM2ImagePredictor`` (set_image features, predict with points, a box, a
mask input, multimask on and off, the batch API, the image embedding), and
the host and device helpers it and the mask generator stand on
(``SAM2Transforms``, connected components, small-region removal, NMS, RLE,
bit-packing). Same seeded weights and inputs through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.api.image_predictor import SAM2ImagePredictor as JaxPredictor
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu.ops import connected_components as JC
from medsam2_tpu.ops import nms as JN
from medsam2_tpu.postproc import amg_utils as JA
from medsam2_tpu.utils.transforms import SAM2Transforms as JaxTransforms
from medsam2_tpu_torch.api.automatic_mask_generator import packbits
from medsam2_tpu_torch.api.image_predictor import SAM2ImagePredictor
from medsam2_tpu_torch.checkpoint.convert import load_reference_state_dict, state_dict_from_jax
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.ops import connected_components as TC
from medsam2_tpu_torch.ops import nms as TN
from medsam2_tpu_torch.postproc import amg_utils as TA
from medsam2_tpu_torch.utils.transforms import SAM2Transforms
from tests.test_predictors import TINY

torch.set_num_threads(2)
TOL = 1e-3          # IoU predictions and low-res logits (the SAM heads' tolerance)


@pytest.fixture(scope="module")
def predictors():
    params = sam2_init(jax.random.PRNGKey(0), TINY)
    model = SAM2Model(TINY, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), TINY))
    jp, tp = JaxPredictor(params, TINY), SAM2ImagePredictor(model)
    img = (np.random.default_rng(0).random((100, 120, 3)) * 255).astype(np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    return jp, tp


def _assert_masks_match(tp, jp, tmasks, jmasks, kw):
    """Binary masks equal wherever the JAX logit is not within TOL of the
    threshold (a pixel on the boundary may round either way)."""
    jlog = jp.predict(return_logits=True, **kw)[0]
    assert tmasks.shape == jmasks.shape and tmasks.dtype == bool
    differ = tmasks != jmasks
    assert not np.any(differ & (np.abs(jlog) > TOL)), np.abs(jlog[differ]).min()


PROMPTS = {
    "point_multimask": dict(point_coords=np.array([[60.0, 50.0]]), point_labels=np.array([1])),
    "point_single": dict(point_coords=np.array([[60.0, 50.0]]), point_labels=np.array([1]),
                         multimask_output=False),
    "box": dict(box=np.array([10, 10, 80, 80]), multimask_output=False),
    "box_and_point": dict(point_coords=np.array([[60.0, 50.0]]), point_labels=np.array([0]),
                          box=np.array([10, 10, 80, 80])),
    "two_points_unnormalised": dict(point_coords=np.array([[0.5, 0.5], [0.2, 0.7]]),
                                    point_labels=np.array([1, 0]), normalize_coords=False),
}


def test_set_image_features_match_jax(predictors):
    jp, tp = predictors
    np.testing.assert_allclose(tp._features["image_embed"].numpy(),
                               np.asarray(jp._features["image_embed"]), atol=1e-4)
    assert len(tp._features["high_res_feats"]) == len(jp._features["high_res_feats"]) == 2
    for g, w in zip(tp._features["high_res_feats"], jp._features["high_res_feats"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    emb = tp.get_image_embedding()
    assert tuple(emb.shape) == (1, 256, 4, 4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jp.get_image_embedding()), atol=1e-4)


@pytest.mark.parametrize("name", list(PROMPTS))
def test_predict_matches_jax(predictors, name):
    jp, tp = predictors
    kw = PROMPTS[name]
    tm, ti, tl = tp.predict(**kw)
    jm, ji, jl = jp.predict(**kw)
    M = 3 if kw.get("multimask_output", True) else 1
    assert tm.shape == (M, 100, 120) and ti.shape == (M,) and tl.shape == (M, 16, 16)
    np.testing.assert_allclose(ti, np.asarray(ji), atol=TOL)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
    _assert_masks_match(tp, jp, tm, np.asarray(jm), kw)


def test_mask_input_round_matches_jax(predictors):
    """The low-res logits of one round (clamped to +/-32) fed back as the
    mask prompt of the next."""
    jp, tp = predictors
    first = dict(point_coords=np.array([[60.0, 50.0]]), point_labels=np.array([1]),
                 multimask_output=False)
    low = jp.predict(**first)[2]
    assert np.abs(tp.predict(**first)[2]).max() <= 32.0
    kw = dict(first, mask_input=np.asarray(low))
    tm, ti, tl = tp.predict(**kw)
    jm, ji, jl = jp.predict(**kw)
    np.testing.assert_allclose(ti, np.asarray(ji), atol=TOL)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
    _assert_masks_match(tp, jp, tm, np.asarray(jm), kw)


def test_batch_api_matches_jax(predictors):
    jp, tp = predictors
    imgs = [(np.random.default_rng(i).random((64, 72, 3)) * 255).astype(np.uint8)
            for i in range(2)]
    kw = dict(point_coords_batch=[np.array([[32.0, 32.0]]), np.array([[16.0, 20.0]])],
              point_labels_batch=[np.array([1]), np.array([1])])
    try:
        jp.set_image_batch(imgs)
        tp.set_image_batch(imgs)
        tmasks, tious, tlows = tp.predict_batch(**kw)
        jmasks, jious, jlows = jp.predict_batch(**kw)
        assert tp.get_image_embedding().shape[0] == 2
        assert len(tmasks) == 2 and tmasks[0].shape == (3, 64, 72)
        for i in range(2):
            np.testing.assert_allclose(tious[i], np.asarray(jious[i]), atol=TOL)
            np.testing.assert_allclose(tlows[i], np.asarray(jlows[i]), atol=TOL)
    finally:
        img = (np.random.default_rng(0).random((100, 120, 3)) * 255).astype(np.uint8)
        jp.set_image(img)
        tp.set_image(img)


def test_predict_before_set_image_raises():
    model = SAM2Model(TINY, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="set_image"):
        SAM2ImagePredictor(model).predict(point_coords=np.zeros((1, 2)),
                                          point_labels=np.ones(1))


# ---------------------------------------------------------------------------
# transforms, connected components, NMS, RLE, packbits
# ---------------------------------------------------------------------------


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    jt = JaxTransforms(64, max_hole_area=6, max_sprinkle_area=4)
    tt = SAM2Transforms(64, max_hole_area=6, max_sprinkle_area=4, device="cpu")
    for img in ((rng.random((100, 80, 3)) * 255).astype(np.uint8),
                rng.random((50, 70, 3)).astype(np.float32),
                (rng.random((30, 30, 3)) * 200).astype(np.float32)):
        np.testing.assert_allclose(tt(img).numpy(), np.asarray(jt(img)), atol=1e-5)
    pts = rng.random((5, 2)) * 90
    np.testing.assert_allclose(tt.transform_coords(pts, True, (90, 60)),
                               jt.transform_coords(pts, True, (90, 60)), rtol=1e-6)
    box = np.array([5, 7, 40, 80])
    np.testing.assert_allclose(tt.transform_boxes(box, True, (90, 60)),
                               jt.transform_boxes(box, True, (90, 60)), rtol=1e-6)
    logits = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    logits[0, 0, 4:6, 4:6] = -5.0                     # a hole inside a positive blob
    logits[0, 0, 2:9, 2:9] = np.where(logits[0, 0, 2:9, 2:9] < 0, 3.0, logits[0, 0, 2:9, 2:9])
    got = tt.postprocess_masks(torch.from_numpy(logits), (40, 50))
    want = jt.postprocess_masks(jnp.asarray(logits), (40, 50))
    assert tuple(got.shape) == (2, 3, 40, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _same_partition(a, b):
    """Two labelings name the same components (equal up to renaming)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    assert np.array_equal(a == 0, b == 0)
    pairs = set(zip(a[a > 0].tolist(), b[b > 0].tolist()))
    assert len(pairs) == len(set(a[a > 0].tolist())) == len(set(b[b > 0].tolist()))


def test_connected_components_and_small_regions_match_jax():
    rng = np.random.default_rng(2)
    masks = rng.random((3, 40, 48)) > 0.55
    masks[2, :, :] = False
    masks[2, 3:30, 5:9] = True                          # a long thin component
    tl, ta = TC.connected_components(torch.from_numpy(masks))
    jl, ja = JC.connected_components(jnp.asarray(masks))
    for i in range(3):
        _same_partition(tl[i].numpy(), jl[i])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for mode in ("holes", "islands"):
        for thresh in (3, 25, 10 ** 6):                 # 10**6: every island small
            tm, tch = TC.remove_small_regions(torch.from_numpy(masks[0]), thresh, mode)
            jm, jch = JC.remove_small_regions(jnp.asarray(masks[0]), thresh, mode)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            assert bool(tch) == bool(jch)
    logits = torch.from_numpy(rng.standard_normal((1, 2, 24, 24)).astype(np.float32))
    np.testing.assert_allclose(
        TC.fill_holes_and_sprinkles(logits, 8, 5).numpy(),
        np.asarray(JC.fill_holes_and_sprinkles(jnp.asarray(logits.numpy()), 8, 5)))


def test_nms_rle_boxes_and_packbits():
    rng = np.random.default_rng(3)
    xy = rng.random((60, 2)) * 50
    boxes = np.concatenate([xy, xy + 5 + rng.random((60, 2)) * 30], 1).astype(np.float32)
    scores = rng.random(60).astype(np.float32)
    idxs = rng.integers(0, 3, 60)
    for thr in (0.3, 0.7):
        np.testing.assert_array_equal(TN.nms_np(boxes, scores, thr),
                                      JN.nms_np(boxes, scores, thr))
        np.testing.assert_array_equal(TN.batched_nms_np(boxes, scores, idxs, thr),
                                      JN.batched_nms_np(boxes, scores, idxs, thr))
    assert TN.nms_np(np.zeros((0, 4)), np.zeros(0), 0.5).shape == (0,)
    masks = rng.random((4, 13, 21)) > 0.6
    masks[1] = True
    masks[2] = False
    rles = TA.mask_to_rle(masks)
    assert rles == JA.mask_to_rle(masks)
    for m, r in zip(masks, rles):
        np.testing.assert_array_equal(TA.rle_to_mask(r), m)
        assert TA.area_from_rle(r) == m.sum()
    np.testing.assert_array_equal(TA.batched_mask_to_box(torch.from_numpy(masks)).numpy(),
                                  JA.batched_mask_to_box(masks))
    for w in (21, 16, 3):
        np.testing.assert_array_equal(packbits(torch.from_numpy(masks[..., :w])).numpy(),
                                      np.packbits(masks[..., :w], axis=-1))
    logits = rng.standard_normal((2, 3, 9, 9)).astype(np.float32)
    np.testing.assert_allclose(TA.calculate_stability_score(torch.from_numpy(logits), 0.0, 1.0)
                               .numpy(), np.asarray(JA.calculate_stability_score(logits, 0.0, 1.0)))
    crops = JA.generate_crop_boxes((100, 150), 2, 512 / 1500)
    assert TA.generate_crop_boxes((100, 150), 2, 512 / 1500) == crops
    for a, b in zip(TA.build_all_layer_point_grids(8, 2, 2), JA.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(a, b)
