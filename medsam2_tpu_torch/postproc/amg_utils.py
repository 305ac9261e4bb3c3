"""Automatic-mask-generator utilities (counterpart of
``medsam2_tpu/postproc/amg_utils.py``, reference ``sam2_train/utils/amg.py``):
the record container, point grids, crop boxes, uncropping, RLE encoding and
decoding, boxes around masks and the stability score.

Host-side numpy for the sequential parts (RLE, crops); the stability score
and the boxes around masks take torch tensors on any device. The JAX
package can hand RLE encoding and NMS to a native C++ library
(``medsam2_tpu/native/postproc.cpp``); that is host code with the same
results, and the port keeps the numpy path.
"""

from __future__ import annotations

import math
from copy import deepcopy
from itertools import product
from typing import Any, Dict, Generator, ItemsView, List, Tuple

import numpy as np
import torch


class MaskData:
    """A dict of batched arrays / lists with ``filter``, ``cat`` and
    ``to_numpy`` (``amg.py:18-77``). Values are lists, numpy arrays or torch
    tensors; filtering brings tensors to the host."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            assert isinstance(v, (list, np.ndarray, torch.Tensor)), \
                "MaskData only supports list, numpy arrays and torch tensors"
        self._stats: Dict[str, Any] = dict(**kwargs)

    def __setitem__(self, key, item):
        assert isinstance(item, (list, np.ndarray, torch.Tensor))
        self._stats[key] = item

    def __delitem__(self, key):
        del self._stats[key]

    def __getitem__(self, key):
        return self._stats[key]

    def items(self) -> ItemsView[str, Any]:
        return self._stats.items()

    def filter(self, keep) -> None:
        keep = np.asarray(keep)
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, (np.ndarray, torch.Tensor)):
                self._stats[k] = _np(v)[keep]
            elif isinstance(v, list) and keep.dtype == bool:
                self._stats[k] = [a for i, a in enumerate(v) if keep[i]]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in keep]
            else:
                raise TypeError(f"MaskData key {k} has unsupported type {type(v)}")

    def cat(self, new_stats: "MaskData") -> None:
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = deepcopy(v)
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                self._stats[k] = np.concatenate([_np(self._stats[k]), _np(v)], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + deepcopy(v)
            else:
                raise TypeError(f"MaskData key {k} has unsupported type {type(v)}")

    def to_numpy(self) -> None:
        for k, v in self._stats.items():
            if isinstance(v, torch.Tensor):
                self._stats[k] = _np(v)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def is_box_near_crop_edge(boxes, crop_box, orig_box, atol: float = 20.0) -> np.ndarray:
    """``amg.py:80-95``: boxes near the crop edge but not the image edge."""
    boxes = uncrop_boxes_xyxy(np.asarray(boxes, np.float32), crop_box)
    near_crop = np.isclose(boxes, np.asarray(crop_box, np.float32)[None], atol=atol)
    near_orig = np.isclose(boxes, np.asarray(orig_box, np.float32)[None], atol=atol)
    return np.any(near_crop & ~near_orig, axis=1)


def box_xyxy_to_xywh(box_xyxy: np.ndarray) -> np.ndarray:
    box = np.array(box_xyxy, np.float32).copy()
    box[..., 2] = box[..., 2] - box[..., 0]
    box[..., 3] = box[..., 3] - box[..., 1]
    return box


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    assert len(args) > 0 and all(len(a) == len(args[0]) for a in args)
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size: (b + 1) * batch_size] for arg in args]


def mask_to_rle(masks: np.ndarray) -> List[Dict[str, Any]]:
    """Column-major (Fortran-order) uncompressed RLE of bool masks [B, h, w]
    (``mask_to_rle_pytorch``, ``amg.py:109-137``); counts start with the
    background run."""
    masks = np.asarray(masks, bool)
    B, h, w = masks.shape
    flat = masks.transpose(0, 2, 1).reshape(B, -1)
    out = []
    for i in range(B):
        row = flat[i]
        change = np.nonzero(row[1:] != row[:-1])[0] + 1
        runs = np.diff(np.concatenate([[0], change, [h * w]]))
        counts = [] if not row[0] else [0]
        counts.extend(runs.tolist())
        out.append({"size": [h, w], "counts": counts})
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """``amg.py:140-155``."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx: idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """``amg.py:296-302`` through pycocotools when it is installed; without
    it the uncompressed RLE is returned unchanged, as the JAX package does."""
    try:
        from pycocotools import mask as mask_utils  # type: ignore
    except ImportError:
        return uncompressed_rle
    h, w = uncompressed_rle["size"]
    rle = mask_utils.frPyObjects(uncompressed_rle, h, w)
    rle["counts"] = rle["counts"].decode("utf-8")
    return rle


def calculate_stability_score(masks: torch.Tensor, mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU of the masks thresholded at ``mask_threshold`` +/- the offset
    (``amg.py:158-178``), empty unions counting as 1. masks [..., H, W]
    logits."""
    masks = torch.as_tensor(masks)
    inter = (masks > (mask_threshold + threshold_offset)).sum(dim=(-1, -2)).float()
    union = (masks > (mask_threshold - threshold_offset)).sum(dim=(-1, -2)).float()
    return inter / union.clamp(min=1.0)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced points in [0, 1]^2 (``amg.py:181-188``)."""
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    points_x = np.tile(points_one_side[None, :], (n_per_side, 1))
    points_y = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([points_x, points_y], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, ...], n_layers: int,
                        overlap_ratio: float) -> Tuple[List[List[int]], List[int]]:
    """The whole image, then 4, 16, ... overlapping crops per layer
    (``amg.py:202-236``)."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0, y0 in product(crop_box_x0, crop_box_y0):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return np.asarray(boxes, np.float32) + np.array([[x0, y0, x0, y0]], np.float32)


def uncrop_points(points, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return np.asarray(points, np.float32) + np.array([[x0, y0]], np.float32)


def uncrop_masks(masks: np.ndarray, crop_box: List[int], orig_h: int,
                 orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    return np.pad(np.asarray(masks), ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1)))


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """XYXY boxes around bool masks [..., H, W], on their device; an empty
    mask gives [0, 0, 0, 0] (the min/max trick of ``amg.py:305-348``)."""
    h, w = masks.shape[-2:]
    in_h = masks.any(dim=-1)
    hc = in_h * torch.arange(h, device=masks.device)
    bottom = hc.amax(dim=-1)
    top = (hc + h * (~in_h)).amin(dim=-1)
    in_w = masks.any(dim=-2)
    wc = in_w * torch.arange(w, device=masks.device)
    right = wc.amax(dim=-1)
    left = (wc + w * (~in_w)).amin(dim=-1)
    empty = (right < left) | (bottom < top)
    box = torch.stack([left, top, right, bottom], dim=-1).float()
    return torch.where(empty[..., None], torch.zeros_like(box), box)
