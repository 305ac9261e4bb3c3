"""SAM2ImagePredictor: the image-prompt API (counterpart of
``medsam2_tpu/api/image_predictor.py``, reference
``sam2_train/sam2_image_predictor.py``).

``set_image`` encodes once and keeps the decoder's features in fp32, with
``no_mem_embed`` added to the lowest-resolution level
(``sam2_image_predictor.py:99-107``); ``predict`` runs the prompt encoder and
mask decoder on them. Prompts are not padded to a shared slot count (a
padded slot is an extra sentinel token that shifts the decoder's attention
off the reference's arithmetic). The image API is eval-only, and the
reference's eval build swaps unstable single-mask outputs for the best
multimask candidate (``eval_dynamic_multimask``). Returned low-res logits are
clamped to +/-32 so they can be fed back as ``mask_input``
(``sam2_image_predictor.py:414``).

Everything runs on the model's device (the card by default); results come
back as numpy arrays, as the reference returns them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from medsam2_tpu_torch.core.sam2_model import SAM2Model, compute_dtype
from medsam2_tpu_torch.utils.transforms import SAM2Transforms


class SAM2ImagePredictor:
    def __init__(self, model: SAM2Model, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0):
        self.model = model
        self.cfg = model.cfg
        self._transforms = SAM2Transforms(
            resolution=self.cfg.image_size, mask_threshold=mask_threshold,
            max_hole_area=max_hole_area, max_sprinkle_area=max_sprinkle_area,
            device=model.device)
        self.mask_threshold = mask_threshold
        self.reset_predictor()

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- reference API ----------------------------------------------------

    def set_image(self, image: np.ndarray) -> None:
        """image: HWC uint8 / float RGB."""
        self.reset_predictor()
        self._orig_hw = [tuple(image.shape[:2])]
        self._features = self._encode(self._transforms(image)[None])
        self._is_image_set = True

    def set_image_batch(self, image_list) -> None:
        self.reset_predictor()
        self._orig_hw = [tuple(im.shape[:2]) for im in image_list]
        self._features = self._encode(self._transforms.forward_batch(image_list))
        self._is_image_set = True

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False, normalize_coords: bool = True,
                img_idx: int = -1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (masks [M, H, W], iou_predictions [M], low-res logits
        [M, h, w]) as numpy (``SAM2ImagePredictor.predict``, ``:217-283``)."""
        if not self._is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) first.")
        coords, labels = self._prep_prompts(point_coords, point_labels, box, normalize_coords,
                                            img_idx)
        mask_in = None
        if mask_input is not None:
            m = np.asarray(mask_input, np.float32)
            if m.ndim == 3:
                m = m[None]
            mask_in = torch.from_numpy(m.transpose(0, 2, 3, 1).copy()).to(self.device)
        feats = self._features
        if img_idx >= 0:
            feats = {"image_embed": feats["image_embed"][img_idx:img_idx + 1],
                     "high_res_feats": [f[img_idx:img_idx + 1] for f in feats["high_res_feats"]]}
        low_res, ious = self._decode(feats, coords, labels, mask_in, multimask_output)
        hw = self._orig_hw[img_idx if img_idx >= 0 else 0]
        masks = self._transforms.postprocess_masks(low_res, hw)[0].cpu().numpy()
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks, ious[0].cpu().numpy(), low_res[0].clamp(-32.0, 32.0).cpu().numpy()

    def predict_batch(self, point_coords_batch=None, point_labels_batch=None, box_batch=None,
                      mask_input_batch=None, multimask_output=True, return_logits=False,
                      normalize_coords=True):
        out_masks, out_ious, out_lows = [], [], []
        for i in range(len(self._orig_hw)):
            pick = (lambda b: b[i] if b is not None else None)  # noqa: E731
            m, iou, lo = self.predict(pick(point_coords_batch), pick(point_labels_batch),
                                      pick(box_batch), pick(mask_input_batch), multimask_output,
                                      return_logits, normalize_coords, img_idx=i)
            out_masks.append(m)
            out_ious.append(iou)
            out_lows.append(lo)
        return out_masks, out_ious, out_lows

    def get_image_embedding(self) -> torch.Tensor:
        """[B, C, h, w], channels first as the reference exposes it."""
        if not self._is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) first.")
        return self._features["image_embed"].permute(0, 3, 1, 2)

    def reset_predictor(self) -> None:
        self._features = None
        self._orig_hw: List[Tuple[int, int]] = []
        self._is_image_set = False

    # -- internals --------------------------------------------------------

    def _prep_prompts(self, point_coords, point_labels, box, normalize_coords, img_idx):
        """Box corners (labels 2, 3) first, then clicks; [1, P, 2] coords and
        [1, P] labels on the device (``sam2_image_predictor.py:373-384``)."""
        hw = self._orig_hw[img_idx if img_idx >= 0 else 0]
        pts, lbl = [], []
        if box is not None:
            pts.append(self._transforms.transform_boxes(box, normalize_coords, hw)[0])
            lbl.append(np.array([2, 3], np.int32))
        if point_coords is not None:
            assert point_labels is not None
            pts.append(self._transforms.transform_coords(
                np.asarray(point_coords, np.float32).reshape(-1, 2), normalize_coords, hw))
            lbl.append(np.asarray(point_labels, np.int32).reshape(-1))
        if not pts:
            coords = np.zeros((1, 1, 2), np.float32)
            labels = -np.ones((1, 1), np.int32)
        else:
            coords = np.concatenate(pts, 0)[None]
            labels = np.concatenate(lbl, 0)[None]
        return (torch.from_numpy(coords).to(self.device),
                torch.from_numpy(labels).to(self.device))

    @torch.no_grad()
    def _encode(self, x: torch.Tensor):
        """Forward the encoder; keep the decoder-ready features in fp32."""
        model = self.model
        out = model.forward_image(x.to(compute_dtype(self.cfg)))
        feats, _ = model.prepare_backbone_features(out)
        embed = feats[-1]
        B, h, w, C = embed.shape
        embed = (embed.reshape(B, h * w, C) + model.no_mem_embed.to(embed.dtype)).reshape(
            B, h, w, C)
        return {"image_embed": embed.float(), "high_res_feats": [f.float() for f in feats[:-1]]}

    @torch.no_grad()
    def _decode(self, feats, coords, labels, mask_input, multimask_output: bool):
        """(low-res multimask logits [B, M, h, w], IoU predictions [B, M])."""
        out = self.model.forward_sam_heads(
            feats["image_embed"], point_inputs={"point_coords": coords, "point_labels": labels},
            mask_inputs=mask_input, high_res_features=feats["high_res_feats"] or None,
            multimask_output=multimask_output, eval_dynamic_multimask=True)
        return out.low_res_multimasks, out.ious
