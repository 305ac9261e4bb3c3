"""Synthetic BTCV-format volumes (counterpart of ``synthetic_volume`` in
``medsam2_tpu/data/synthetic.py``) for tests, smoke training and the chip
smoke without the (license-gated) medical datasets. numpy only."""

from __future__ import annotations

from typing import Dict

import numpy as np

from medsam2_tpu_torch.data.prompts import generate_bbox, random_click


def synthetic_volume(rng: np.random.Generator, T: int = 8, size: int = 128,
                     num_objects: int = 2, prompt: str = "bbox") -> Dict:
    """BTCV-format volume dict: drifting ellipses as organs."""
    imgs = np.zeros((T, 3, size, size), np.float32)
    label, pt_dict, p_label_dict, bbox_dict = {}, {}, {}, {}
    centers = rng.uniform(size * 0.3, size * 0.7, (num_objects, 2))
    radii = rng.uniform(size * 0.08, size * 0.15, (num_objects, 2))
    drift = rng.uniform(-2, 2, (num_objects, 2))
    yy, xx = np.mgrid[0:size, 0:size]
    for t in range(T):
        frame_masks, frame_pts, frame_lbls, frame_boxes = {}, {}, {}, {}
        for o in range(num_objects):
            cy, cx = centers[o] + drift[o] * t
            m = (((yy - cy) / radii[o, 0]) ** 2 + ((xx - cx) / radii[o, 1]) ** 2) <= 1
            if m.sum() == 0:
                continue
            imgs[t, :, m] = 0.5 + 0.5 * (o + 1) / num_objects
            frame_masks[o + 1] = m.astype(np.int32)[None]
            if prompt == "click":
                lbl, pt = random_click(m, 1, rng)
                frame_lbls[o + 1] = lbl
                frame_pts[o + 1] = pt
            else:
                frame_boxes[o + 1] = generate_bbox(m, 0.0, rng)
        imgs[t] += rng.normal(0, 0.05, (3, size, size))
        label[t] = frame_masks
        pt_dict[t] = frame_pts
        p_label_dict[t] = frame_lbls
        bbox_dict[t] = frame_boxes
    imgs = np.clip(imgs, 0, 1) * 255
    out = {"image": imgs, "label": label,
           "image_meta_dict": {"filename_or_obj": "synthetic"}}
    if prompt == "click":
        out["pt"] = pt_dict
        out["p_label"] = p_label_dict
    else:
        out["bbox"] = bbox_dict
    return out
