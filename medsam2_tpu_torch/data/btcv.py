"""BTCV / AMOS CT-volume datasets (counterpart of
``medsam2_tpu/data/btcv.py``; rebuild of ``func_3d/dataset/btcv.py`` and
``amos.py`` — the reference AMOS file is a byte-level copy of BTCV). numpy
only; PIL is imported when a volume is read.

Layout on disk: ``<root>/<mode>/image/<case>/<i>.jpg`` slices and
``<root>/<mode>/mask/<case>/<i>.npy`` integer masks. Behaviour reproduced:
leading/trailing empty-slice trimming, random ``video_length`` window in
training (else ``num_frame / 4``), per-object binary masks per frame, click or
bbox prompts per object.

Two output formats:
- ``__getitem__``: the reference dict contract (image [T, 3, S, S], nested
  label/prompt dicts) for the predictor APIs.
- ``as_recipe_batch``: padded fixed-shape arrays for the
  ``recipe_3d`` train step.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from medsam2_tpu_torch.data.prompts import bbox_to_xyxy, generate_bbox, random_click


class BTCV:
    def __init__(self, data_path: str, mode: str = "Training", image_size: int = 1024,
                 video_length: Optional[int] = None, prompt: str = "click",
                 variation: float = 0.0, seed: Optional[int] = None):
        self.data_path = data_path
        self.mode = mode
        self.image_size = image_size
        self.prompt = prompt
        self.variation = variation
        self.rng = np.random.default_rng(seed)
        self.video_length = video_length if mode == "Training" else None
        self.name_list = sorted(os.listdir(os.path.join(data_path, mode, "image")))

    def __len__(self):
        return len(self.name_list)

    def _load_volume(self, name):
        from PIL import Image

        mask_dir = os.path.join(self.data_path, self.mode, "mask", name)
        img_dir = os.path.join(self.data_path, self.mode, "image", name)
        num_frame = len(os.listdir(mask_dir))
        seg = np.stack([np.load(os.path.join(mask_dir, f"{i}.npy"))
                        for i in range(num_frame)], axis=-1)
        # trim empty leading/trailing slices (btcv.py:49-57)
        nz = [i for i in range(seg.shape[-1]) if seg[..., i].sum() > 0]
        start, end = (nz[0], nz[-1]) if nz else (0, seg.shape[-1] - 1)
        seg = seg[..., start:end + 1]
        imgs = []
        for i in range(start, end + 1):
            img = Image.open(os.path.join(img_dir, f"{i}.jpg")).convert("RGB")
            img = img.resize((self.image_size, self.image_size))
            imgs.append(np.asarray(img, np.float32))
        return np.stack(imgs), seg

    def __getitem__(self, index) -> Dict:
        name = self.name_list[index]
        imgs, seg = self._load_volume(name)
        num_frame = seg.shape[-1]
        video_length = self.video_length or max(int(num_frame / 4), 1)
        if num_frame > video_length and self.mode == "Training":
            starting = int(self.rng.integers(0, num_frame - video_length + 1))
        else:
            starting = 0
            video_length = min(video_length, num_frame)

        S = self.image_size
        img_tensor = np.zeros((video_length, 3, S, S), np.float32)
        mask_dict, pt_dict, p_label_dict, bbox_dict = {}, {}, {}, {}
        from PIL import Image

        for t in range(video_length):
            frame = starting + t
            mask = seg[..., frame]
            obj_ids = np.unique(mask[mask > 0])
            frame_masks, frame_pts, frame_lbls, frame_boxes = {}, {}, {}, {}
            for obj in obj_ids:
                obj_mask = Image.fromarray(mask == obj).resize((S, S))
                obj_mask = np.asarray(obj_mask).astype(np.int32)[None]
                frame_masks[int(obj)] = obj_mask
                if self.prompt == "click":
                    lbl, pt = random_click(obj_mask[0], 1, self.rng)
                    frame_lbls[int(obj)] = lbl
                    frame_pts[int(obj)] = pt
                elif self.prompt == "bbox":
                    frame_boxes[int(obj)] = generate_bbox(
                        obj_mask[0], self.variation, self.rng)
            img_tensor[t] = imgs[frame].transpose(2, 0, 1)
            mask_dict[t] = frame_masks
            if self.prompt == "click":
                pt_dict[t] = frame_pts
                p_label_dict[t] = frame_lbls
            else:
                bbox_dict[t] = frame_boxes

        out = {
            "image": img_tensor,
            "label": mask_dict,
            "image_meta_dict": {"filename_or_obj": name},
        }
        if self.prompt == "click":
            out["pt"] = pt_dict
            out["p_label"] = p_label_dict
        else:
            out["bbox"] = bbox_dict
        return out


# AMOS is structurally identical to BTCV in the reference (amos.py == btcv.py
# modulo the class name); expose the alias rather than a copied class.
AMOS = BTCV


def pack_to_recipe_batch(samples: List[Dict], video_length: int, num_objects: int,
                         prompt_freq: int, image_size: int, max_points: int = 8):
    """Convert reference-format volume dicts into the padded recipe_3d batch."""
    Bv = len(samples)
    T, O, S, P = video_length, num_objects, image_size, max_points
    n_prompt = len(range(0, T, prompt_freq))
    batch = {
        "images": np.zeros((Bv, T, S, S, 3), np.float32),
        "gt_masks": np.zeros((Bv, T, O, S, S), np.float32),
        "prompt_coords": np.zeros((Bv, n_prompt, O, P, 2), np.float32),
        "prompt_labels": -np.ones((Bv, n_prompt, O, P), np.int32),
        "prompt_use_mask": np.ones((Bv, n_prompt, O), bool),
        "obj_valid": np.zeros((Bv, O), bool),
    }
    for v, s in enumerate(samples):
        imgs = s["image"]
        Ts = min(T, imgs.shape[0])
        batch["images"][v, :Ts] = imgs[:Ts].transpose(0, 2, 3, 1) / 255.0
        obj_ids = sorted({o for t in s["label"] for o in s["label"][t]})[:O]
        for oi, obj in enumerate(obj_ids):
            batch["obj_valid"][v, oi] = True
            for t in range(Ts):
                if obj in s["label"].get(t, {}):
                    batch["gt_masks"][v, t, oi] = s["label"][t][obj][0]
        for pi, t in enumerate(range(0, Ts, prompt_freq)):
            for oi, obj in enumerate(obj_ids):
                if "pt" in s and obj in s.get("pt", {}).get(t, {}):
                    batch["prompt_coords"][v, pi, oi, 0] = s["pt"][t][obj]
                    batch["prompt_labels"][v, pi, oi, 0] = s["p_label"][t][obj]
                    batch["prompt_use_mask"][v, pi, oi] = False
                elif "bbox" in s and obj in s.get("bbox", {}).get(t, {}):
                    box = s["bbox"][t][obj]
                    if not np.any(np.isnan(box)):
                        batch["prompt_coords"][v, pi, oi, :2] = bbox_to_xyxy(box)
                        batch["prompt_labels"][v, pi, oi, 0] = 2
                        batch["prompt_labels"][v, pi, oi, 1] = 3
                        batch["prompt_use_mask"][v, pi, oi] = False
    return batch
