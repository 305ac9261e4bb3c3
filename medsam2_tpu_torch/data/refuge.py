"""REFUGE fundus dataset (counterpart of ``medsam2_tpu/data/refuge.py``;
rebuild of ``func_2d/dataset.py``): one folder per sample with 7 rater cup
masks, the majority vote (>= 0.5 of the rater mean) as ground truth, and a
random click on the fused mask. numpy only; PIL is imported when a sample
is read.

Layout on disk: ``<root>/<mode>-400/<name>/<name>_cropped.jpg`` and
``<name>_seg_cup_<1..7>_cropped.jpg``."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from medsam2_tpu_torch.data.prompts import random_click


class REFUGE:
    def __init__(self, data_path: str, mode: str = "Training", image_size: int = 1024,
                 out_size: int = 1024, seed: Optional[int] = None):
        self.data_path = data_path
        self.mode = mode
        self.image_size = image_size
        self.out_size = out_size
        self.rng = np.random.default_rng(seed)
        root = os.path.join(data_path, mode + "-400")
        self.subfolders = sorted(f.path for f in os.scandir(root) if f.is_dir())

    def __len__(self):
        return len(self.subfolders)

    def __getitem__(self, index) -> Dict:
        from PIL import Image

        subfolder = self.subfolders[index]
        name = os.path.basename(subfolder)
        img = Image.open(os.path.join(subfolder, name + "_cropped.jpg")).convert("RGB")
        raters = [
            np.asarray(
                Image.open(os.path.join(subfolder, f"{name}_seg_cup_{i}_cropped.jpg"))
                .convert("L").resize((self.image_size, self.image_size)), np.float32) / 255.0
            for i in range(1, 8)
        ]
        img = np.asarray(img.resize((self.image_size, self.image_size)), np.float32) / 255.0
        multi_rater = np.stack([(r >= 0.5).astype(np.float32) for r in raters])
        fused = multi_rater.mean(axis=0)
        point_label, pt = random_click(fused, 1, self.rng)
        mask_ori = (fused >= 0.5).astype(np.float32)
        if self.out_size != self.image_size:
            m = Image.fromarray((mask_ori * 255).astype(np.uint8)).resize(
                (self.out_size, self.out_size))
            mask = (np.asarray(m, np.float32) / 255.0 >= 0.5).astype(np.float32)
        else:
            mask = mask_ori
        return {
            "image": img.transpose(2, 0, 1),
            "multi_rater": multi_rater[:, None],
            "p_label": point_label,
            "pt": pt,
            "mask": mask[None],
            "mask_ori": mask_ori[None],
            "image_meta_dict": {"filename_or_obj": name},
        }


def pack_refuge_batch(samples, image_size: int, out_size: int, max_points: int = 8):
    """Reference sample dicts -> the ``recipe_2d`` batch arrays: images
    [B, S, S, 3] in [0, 1], coords [B, max_points, 2] (x, y) pixels, labels
    [B, max_points] (-1 padding), gt_masks [B, out, out]."""
    B = len(samples)
    batch = {
        "images": np.zeros((B, image_size, image_size, 3), np.float32),
        "coords": np.zeros((B, max_points, 2), np.float32),
        "labels": -np.ones((B, max_points), np.int32),
        "gt_masks": np.zeros((B, out_size, out_size), np.float32),
    }
    for i, s in enumerate(samples):
        batch["images"][i] = s["image"].transpose(1, 2, 0)
        batch["coords"][i, 0] = s["pt"]
        batch["labels"][i, 0] = s["p_label"]
        batch["gt_masks"][i] = s["mask"][0]
    return batch
