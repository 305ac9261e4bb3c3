"""Synthetic BTCV-format volumes, REFUGE-format fundus samples and
MoNuSeg-format nuclei images (counterparts of ``synthetic_volume``,
``synthetic_fundus`` and ``synthetic_nuclei`` in
``medsam2_tpu/data/synthetic.py``) for tests, smoke training and the chip
smoke without the (license-gated) medical datasets. numpy only: one
``np.random.Generator`` state gives the JAX package's arrays."""

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


def synthetic_fundus(rng: np.random.Generator, size: int = 256) -> Dict:
    """REFUGE-format sample: a bright disc with a darker cup."""
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.uniform(size * 0.4, size * 0.6, 2)
    r_cup = rng.uniform(size * 0.08, size * 0.15)
    cup = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r_cup ** 2
    img = np.full((size, size, 3), 0.4, np.float32)
    disc = ((yy - cy) ** 2 + (xx - cx) ** 2) <= (r_cup * 2) ** 2
    img[disc] = 0.8
    img[cup] = 0.95
    img += rng.normal(0, 0.03, img.shape)
    lbl, pt = random_click(cup, 1, rng)
    mask = cup.astype(np.float32)
    return {
        "image": np.clip(img, 0, 1).transpose(2, 0, 1),
        "multi_rater": np.repeat(mask[None, None], 7, axis=0),
        "p_label": lbl,
        "pt": pt,
        "mask": mask[None],
        "mask_ori": mask[None],
        "image_meta_dict": {"filename_or_obj": "synthetic"},
    }


def synthetic_nuclei(rng: np.random.Generator, size: int = 256,
                     num_cells: int = 12) -> Dict:
    """MoNuSeg-train-format sample: random non-overlapping elliptical nuclei."""
    inst_map = np.zeros((size, size), np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    pid = 0
    for _ in range(num_cells * 3):
        if pid >= num_cells:
            break
        cy, cx = rng.uniform(10, size - 10, 2)
        ry, rx = rng.uniform(4, 10, 2)
        m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1
        if (inst_map[m] != 0).any() or m.sum() < 8:
            continue
        pid += 1
        inst_map[m] = pid
    img = np.full((size, size, 3), 0.85, np.float32)
    img[inst_map > 0] = 0.35
    img += rng.normal(0, 0.04, img.shape)

    pids = np.unique(inst_map)
    pids = pids[pids > 0]
    pts, insts = [], []
    for p in pids:
        coords = np.argwhere(inst_map == p)
        r = coords[rng.integers(len(coords))]
        pts.append([r[1], r[0]])
        insts.append(inst_map == p)
    return {
        "image": np.clip(img, 0, 1).astype(np.float32),
        "inst_masks": np.stack(insts) if insts else np.zeros((0, size, size), bool),
        "points_choose": np.asarray(pts, np.float32),
        "labels_choose": np.ones(len(pts), np.int64),
        "points_all": np.asarray(pts, np.float32),
        "labels_all": np.zeros(len(pts), np.int64),
        "cell_num": len(pts),
        "binary_mask": (inst_map > 0).astype(np.uint8),
        "inst_map": inst_map,
        "ori_shape": np.asarray([size, size]),
    }
