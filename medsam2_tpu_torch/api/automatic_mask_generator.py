"""SAM2AutomaticMaskGenerator (counterpart of
``medsam2_tpu/api/automatic_mask_generator.py``, reference
``sam2_train/automatic_mask_generator.py``).

A grid of ``points_per_side^2`` single-point prompts per crop, decoded
multimask in batches of ``points_per_batch`` on the device. Each batch is
also scored there: the logits are upsampled to the crop, and their IoU
predictions, stability scores, boxes and the thresholded masks bit-packed
along the width stay on the device. The host pulls each score array once per
crop, filters by IoU / stability / crop edge, runs box NMS, and pulls only
the survivors' packed masks, once, to encode them as RLE. Crops are merged
by a second NMS that prefers smaller crops; ``min_mask_region_area`` removes
small islands and holes and dedupes again.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from medsam2_tpu_torch.api.image_predictor import SAM2ImagePredictor
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.ops.connected_components import remove_small_regions
from medsam2_tpu_torch.ops.nms import batched_nms_np
from medsam2_tpu_torch.postproc import amg_utils as amg


class SAM2AutomaticMaskGenerator:
    def __init__(
        self,
        model: SAM2Model,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.8,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        mask_threshold: float = 0.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        multimask_output: bool = True,
        use_m2m: bool = False,
        **kwargs,
    ):
        assert (points_per_side is None) != (point_grids is None), \
            "Exactly one of points_per_side or point_grids must be provided."
        if points_per_side is not None:
            self.point_grids = amg.build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        assert output_mode in ("binary_mask", "uncompressed_rle", "coco_rle")
        self.predictor = SAM2ImagePredictor(model)
        self.model = model
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.multimask_output = multimask_output
        self.use_m2m = use_m2m

    @torch.no_grad()
    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image: HWC uint8 RGB -> list of mask records (``:152-204``)."""
        mask_data = self._generate_masks(image)
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh), self.model.device)
        if self.output_mode == "coco_rle":
            mask_data["segmentations"] = [amg.coco_encode_rle(r) for r in mask_data["rles"]]
        elif self.output_mode == "binary_mask":
            mask_data["segmentations"] = [amg.rle_to_mask(r) for r in mask_data["rles"]]
        else:
            mask_data["segmentations"] = mask_data["rles"]
        return [{
            "segmentation": mask_data["segmentations"][i],
            "area": amg.area_from_rle(mask_data["rles"][i]),
            "bbox": amg.box_xyxy_to_xywh(mask_data["boxes"][i]).tolist(),
            "predicted_iou": float(mask_data["iou_preds"][i]),
            "point_coords": [mask_data["points"][i].tolist()],
            "stability_score": float(mask_data["stability_score"][i]),
            "crop_box": amg.box_xyxy_to_xywh(mask_data["crop_boxes"][i]).tolist(),
        } for i in range(len(mask_data["segmentations"]))]

    def _generate_masks(self, image: np.ndarray) -> amg.MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = amg.generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = amg.MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx, orig_size))
        if len(crop_boxes) > 1 and len(data["boxes"]) > 0:
            # prefer masks from smaller crops (``:219-229``)
            scores = 1 / amg.box_xyxy_to_xywh(np.asarray(data["crop_boxes"]))[:, 2]
            keep = batched_nms_np(np.asarray(data["boxes"], np.float32), scores,
                                  np.zeros(len(scores)), self.crop_nms_thresh)
            data.filter(keep)
        data.to_numpy()
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx, orig_size) -> amg.MaskData:
        x0, y0, x1, y1 = crop_box
        cropped_im = image[y0:y1, x0:x1, :]
        cropped_im_size = cropped_im.shape[:2]
        self.predictor.set_image(cropped_im)
        points_scale = np.array(cropped_im_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale

        # every point batch is queued on the device before anything is pulled
        batches, host_points = [], []
        for (points,) in amg.batch_iterator(self.points_per_batch, points_for_image):
            batches.append(self._decode_score_batch(points, cropped_im_size))
            host_points.append(points)
        self.predictor.reset_predictor()

        # one pull per score array for the whole crop
        iou_flat, stability, boxes, packed = (torch.cat([b[i] for b in batches])
                                              for i in range(4))
        iou_flat = iou_flat.cpu().numpy()
        stability = stability.cpu().numpy()
        boxes = boxes.cpu().numpy().reshape(-1, 4)
        M = len(iou_flat) // len(points_for_image)
        points_rep = np.repeat(np.concatenate(host_points), M, axis=0)

        # host filters on the scalars
        orig_h, orig_w = orig_size
        keep_mask = np.ones(len(iou_flat), bool)
        if self.pred_iou_thresh > 0.0:
            keep_mask &= iou_flat > self.pred_iou_thresh
        if self.stability_score_thresh > 0.0:
            keep_mask &= stability >= self.stability_score_thresh
        keep_mask &= ~amg.is_box_near_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h])
        kept_idx = np.flatnonzero(keep_mask)
        data = amg.MaskData(iou_preds=iou_flat[kept_idx], points=points_rep[kept_idx],
                            stability_score=stability[kept_idx], boxes=boxes[kept_idx])
        keep = np.zeros(0, np.int64)
        if len(kept_idx) > 0:
            nms_keep = batched_nms_np(data["boxes"], data["iou_preds"],
                                      np.zeros(len(kept_idx)), self.box_nms_thresh)
            data.filter(nms_keep)
            keep = kept_idx[nms_keep]      # survivors' rows in candidate order

        # one pull of the survivors' packed masks
        H, W = cropped_im_size
        if len(keep) > 0:
            rows = packed[torch.from_numpy(keep).to(packed.device)].cpu().numpy()
            masks = np.unpackbits(rows, axis=-1, count=W).astype(bool)
            data["rles"] = amg.mask_to_rle(amg.uncrop_masks(masks, crop_box, orig_h, orig_w))
        else:
            data["rles"] = []
        data["boxes"] = amg.uncrop_boxes_xyxy(data["boxes"], crop_box).reshape(-1, 4)
        data["points"] = amg.uncrop_points(data["points"], crop_box).reshape(-1, 2)
        data["crop_boxes"] = np.asarray([crop_box] * len(data["rles"]), np.float32).reshape(-1, 4)
        return data

    def _decode_score_batch(self, points, im_size):
        """Decode and score one point batch on the device, with no host
        synchronisation. Returns (IoU predictions [n M], stability [n M],
        boxes [n M, 4], packed masks [n M, H, ceil(W / 8)] uint8)."""
        pred = self.predictor
        dev = pred.device
        in_points = pred._transforms.transform_coords(points, normalize=True, orig_hw=im_size)
        n = len(in_points)
        coords = torch.from_numpy(in_points[:, None, :].astype(np.float32)).to(dev)
        labels = torch.ones(n, 1, dtype=torch.int32, device=dev)
        low_res, iou_preds = _decode_point_grid(self.model, pred._features, coords, labels)
        if self.use_m2m:
            # every candidate re-fed as a single-mask prompt with its point,
            # its logits clamped to +/-32 as the predictor returns them
            # (automatic_mask_generator.py:326-335,417-434)
            M = low_res.shape[1]
            flat = low_res.reshape(n * M, 1, *low_res.shape[2:]).clamp(-32.0, 32.0)
            low_res, iou_preds = _refine_with_m2m(
                self.model, pred._features, coords.repeat_interleave(M, 0),
                labels.repeat_interleave(M, 0), flat)
            low_res = low_res.reshape(n, M, *low_res.shape[2:])
            iou_preds = iou_preds.reshape(n, M)
        return _score_and_pack_masks(low_res, iou_preds, tuple(im_size), self.mask_threshold,
                                     self.stability_score_offset)

    @staticmethod
    def postprocess_small_regions(mask_data: amg.MaskData, min_area: int, nms_thresh: float,
                                  device="cuda") -> amg.MaskData:
        """Remove small islands and holes on ``device``, then dedupe; masks
        left unchanged score 1 and win the NMS (``:366-415``)."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = torch.from_numpy(amg.rle_to_mask(rle)).to(device)
            m, holes_changed = remove_small_regions(mask, min_area, "holes")
            m, islands_changed = remove_small_regions(m, min_area, "islands")
            new_masks.append(m.cpu().numpy())
            scores.append(float(not (bool(holes_changed) or bool(islands_changed))))
        masks = np.stack(new_masks)
        boxes = amg.batched_mask_to_box(torch.from_numpy(masks)).numpy()
        keep = batched_nms_np(boxes, np.asarray(scores), np.zeros(len(boxes)), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:     # changed masks are encoded again
                mask_data["rles"][i] = amg.mask_to_rle(masks[i][None])[0]
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data


def _broadcast_features(features, B: int):
    return (features["image_embed"].expand(B, *features["image_embed"].shape[1:]),
            [f.expand(B, *f.shape[1:]) for f in features["high_res_feats"]])


def _decode_point_grid(model: SAM2Model, features, coords, labels):
    """One multimask decode over a batch of single-point prompts."""
    embed, high_res = _broadcast_features(features, coords.shape[0])
    out = model.forward_sam_heads(
        embed, point_inputs={"point_coords": coords, "point_labels": labels},
        high_res_features=high_res, multimask_output=True)
    return out.low_res_multimasks, out.ious


def _refine_with_m2m(model: SAM2Model, features, coords, labels, mask_input):
    """Single-mask refinement with the previous logits as the mask prompt
    (eval build: unstable single masks fall back to the best candidate)."""
    embed, high_res = _broadcast_features(features, coords.shape[0])
    out = model.forward_sam_heads(
        embed, point_inputs={"point_coords": coords, "point_labels": labels},
        mask_inputs=mask_input.permute(0, 2, 3, 1), high_res_features=high_res,
        multimask_output=False, eval_dynamic_multimask=True)
    return out.low_res_multimasks, out.ious


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits(bits, axis=-1)`` on the device: eight values per byte,
    the first in the most significant bit, the tail byte zero-padded."""
    W = bits.shape[-1]
    pad = (-W) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(*bits.shape[:-1], pad)], dim=-1)
    groups = bits.reshape(*bits.shape[:-1], (W + pad) // 8, 8).to(torch.uint8)
    shifts = torch.arange(7, -1, -1, device=bits.device, dtype=torch.uint8)
    return (groups << shifts).sum(dim=-1, dtype=torch.uint8)


def _score_and_pack_masks(low_res, iou_preds, out_hw, mask_threshold: float,
                          stability_offset: float):
    """Upsample low-res logits [B, M, h, w] to ``out_hw`` and compute what the
    filters need: flat IoU predictions, stability scores, boxes, and the
    thresholded masks bit-packed along the width."""
    B, M = low_res.shape[:2]
    up = layers.interpolate(low_res.float().permute(0, 2, 3, 1), out_hw,
                            method="bilinear").permute(0, 3, 1, 2)
    flat = up.reshape(B * M, *out_hw)
    stability = amg.calculate_stability_score(flat, mask_threshold, stability_offset)
    binary = flat > mask_threshold
    return (iou_preds.reshape(B * M), stability, amg.batched_mask_to_box(binary),
            packbits(binary))
