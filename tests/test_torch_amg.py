"""``SAM2AutomaticMaskGenerator.generate``, JAX package against the PyTorch
port, on CPU at TINY with the same seeded weights and image. The loaded
variant (``pred_iou_thresh=0``, ``stability_score_thresh=0``): with random
weights the default thresholds keep almost nothing, and the filters, NMS and
RLE would do no work. Records match one for one: counts, RLEs and boxes
equal, predicted IoU and stability to 1e-4."""

import jax
import numpy as np
import pytest
import torch

from medsam2_tpu.api.automatic_mask_generator import SAM2AutomaticMaskGenerator as JaxAMG
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu_torch.api.automatic_mask_generator import SAM2AutomaticMaskGenerator
from medsam2_tpu_torch.checkpoint.convert import load_reference_state_dict, state_dict_from_jax
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.postproc import amg_utils as amg
from tests.test_predictors import TINY

torch.set_num_threads(2)
LOADED = dict(points_per_side=8, points_per_batch=16, pred_iou_thresh=0.0,
              stability_score_thresh=0.0)


@pytest.fixture(scope="module")
def models():
    params = sam2_init(jax.random.PRNGKey(0), TINY)
    model = SAM2Model(TINY, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), TINY))
    return params, model


def _image(seed=0, h=80, w=96):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 60).astype(np.uint8)
    img[20:50, 30:70] = 220                     # a bright square over texture
    return img


@pytest.mark.parametrize("case", [
    dict(),
    dict(crop_n_layers=1),
    dict(use_m2m=True),
    dict(min_mask_region_area=20, output_mode="uncompressed_rle"),
], ids=["single_crop", "crop_layers", "m2m", "small_regions_rle"])
def test_generate_matches_jax(models, case):
    params, model = models
    kw = dict(LOADED, **case)
    img = _image()
    want = JaxAMG(params, TINY, **kw).generate(img)
    got = SAM2AutomaticMaskGenerator(model, **kw).generate(img)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if kw.get("output_mode", "binary_mask") == "binary_mask":
            assert g["segmentation"].dtype == bool
            np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
        else:
            assert g["segmentation"] == w["segmentation"]
        assert g["area"] == w["area"]
        assert g["bbox"] == w["bbox"] and g["crop_box"] == w["crop_box"]
        np.testing.assert_allclose(g["point_coords"], w["point_coords"], rtol=1e-6)
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= 1e-4
        assert abs(g["stability_score"] - w["stability_score"]) <= 1e-4


def test_coco_rle_without_pycocotools(models):
    """``coco_rle`` hands each RLE to pycocotools when installed; without it
    the uncompressed RLE comes back, as in the JAX package."""
    _, model = models
    out = SAM2AutomaticMaskGenerator(model, output_mode="coco_rle", **LOADED).generate(_image(1))
    assert out
    for rec in out:
        rle = rec["segmentation"]
        assert rle == amg.coco_encode_rle(rle) or isinstance(rle["counts"], str)
