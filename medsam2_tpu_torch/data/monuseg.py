"""MoNuSeg / CPM-17 nuclei instance datasets (counterpart of
``medsam2_tpu/data/monuseg.py``; rebuild of ``func_2d/monuseg.py`` and
``func_2d/cpm.py``, which differ only in directory names). numpy only; PIL
and scipy are imported when a sample is read.

Layout: ``<root>/{train,test}/images/*.png|tif`` + ``labels/*.mat`` with an
``inst_map`` array. Per-cell center-point prompts with nearest-foreground
fallback (``monuseg.py:102-116``), a random <= ``num_mask_per_img`` cell
subset for training (``:123-137``), binary union mask; in train mode the
augmentation of :mod:`medsam2_tpu_torch.data.augment` first, drawn from the
reader's seeded generator.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from medsam2_tpu_torch.data.augment import NucleiAugmentConfig, augment_nuclei
from medsam2_tpu_torch.utils.transforms import IMAGENET_MEAN, IMAGENET_STD


def cell_centers(inst_map: np.ndarray, pids: np.ndarray) -> np.ndarray:
    """Per-cell center points (x, y) with nearest-foreground snapping."""
    pts = []
    for pid in pids:
        coords = np.argwhere(inst_map == pid)  # (row, col)
        center = np.round(coords.mean(axis=0)).astype(np.int64)
        if inst_map[center[0], center[1]] != pid:
            d = ((coords - center) ** 2).sum(axis=1)
            center = coords[d.argmin()]
        pts.append([center[1], center[0]])  # (x, y)
    return np.asarray(pts, np.float32) if pts else np.zeros((0, 2), np.float32)


class MONUSEG:
    image_dirname = "images"
    label_dirname = "labels"

    def __init__(self, data_path: str, mode: str = "train", image_size: int = 256,
                 out_size: int = 256, num_mask_per_img: int = 150,
                 seed: Optional[int] = None, augment=None):
        """``augment``: a :class:`~medsam2_tpu_torch.data.augment.NucleiAugmentConfig`
        turning on the training augmentation (``func_2d/monuseg.py:39-55``),
        or ``True`` for the default one at ``image_size``; train mode only."""
        self.data_path = data_path
        self.mode = mode
        self.image_size = image_size
        self.out_size = out_size
        self.num_mask_per_img = num_mask_per_img
        self.rng = np.random.default_rng(seed)
        if augment is True:
            augment = NucleiAugmentConfig(crop_size=image_size)
        self.augment = augment if mode == "train" else None
        self.image_root = os.path.join(data_path, mode, self.image_dirname)
        self.label_root = os.path.join(data_path, mode, self.label_dirname)
        self.paths = sorted(os.listdir(self.image_root))

    def __len__(self):
        return len(self.paths)

    def _load(self, index):
        import scipy.io as sio
        from PIL import Image

        path = self.paths[index]
        img = np.asarray(
            Image.open(os.path.join(self.image_root, path)).convert("RGB"), np.float32)
        mat = sio.loadmat(
            os.path.join(self.label_root, os.path.splitext(path)[0] + ".mat"))
        inst_map = mat["inst_map"].astype(np.int32)
        return img, inst_map, path

    def __getitem__(self, index) -> Dict:
        img, inst_map, path = self._load(index)
        if self.augment:
            img, inst_map = augment_nuclei(img, inst_map, self.augment, self.rng)
        ori_shape = inst_map.shape[:2]
        pids = np.unique(inst_map)
        pids = pids[pids > 0]
        cell_num = len(pids)

        points_all = cell_centers(inst_map, pids)
        labels_all = np.ones(cell_num, np.int64) - 1  # single class -> 0
        normalized = (img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD

        if self.mode != "train":
            return {
                "image": normalized,
                "image_raw": img,
                "inst_map": inst_map,
                "type_map": (inst_map > 0).astype(np.float32),
                "points_all": points_all,
                "labels_all": labels_all,
                "binary_mask": (inst_map > 0).astype(np.uint8),
                "ori_shape": np.asarray(ori_shape),
                "name": os.path.splitext(path)[0],
            }

        # training: random <= num_mask_per_img cell subset with random in-cell clicks
        chosen = self.rng.choice(pids, min(cell_num, self.num_mask_per_img),
                                 replace=False) if cell_num else np.zeros(0, np.int64)
        points_choose, inst_choose = [], []
        for pid in chosen:
            coords = np.argwhere(inst_map == pid)
            r = coords[self.rng.integers(len(coords))]
            points_choose.append([r[1], r[0]])
            inst_choose.append(inst_map == pid)
        points_choose = np.asarray(points_choose, np.float32) if len(chosen) else \
            np.zeros((0, 2), np.float32)
        inst_choose = np.stack(inst_choose) if len(chosen) else \
            np.zeros((0, *ori_shape), bool)

        return {
            "image": normalized,
            "inst_masks": inst_choose,
            "points_choose": points_choose,
            # type-1 = 0 for single-class nuclei (monuseg.py:116): these go
            # straight into the SAM prompt encoder as point labels
            "labels_choose": np.zeros(len(chosen), np.int64),
            "points_all": points_all,
            "labels_all": labels_all,
            "cell_num": len(chosen),
            "binary_mask": (inst_map > 0).astype(np.uint8),
            "ori_shape": np.asarray(ori_shape),
        }


class CPM(MONUSEG):
    """CPM-17: identical pipeline, ``Images``/``Labels`` directories
    (``func_2d/cpm.py:22-30``)."""

    image_dirname = "Images"
    label_dirname = "Labels"


def pack_nuclei_batch(samples, image_size: int, out_size: int, max_cells: int):
    """Training dicts -> the nuclei recipe's batch arrays (prefix-valid cell
    slots). An image of another size is min-max scaled to uint8 and resized
    with PIL's default filter, as the JAX package intends (it calls
    ``ndarray.ptp``, which numpy 2 removed; ``np.ptp`` is the same value)."""
    B = len(samples)
    M = max_cells
    batch = {
        "images": np.zeros((B, image_size, image_size, 3), np.float32),
        "gt_points": np.zeros((B, M, 2), np.float32),
        "gt_labels": np.zeros((B, M), np.int32),
        "gt_valid": np.zeros((B, M), bool),
        "gt_cell_masks": np.zeros((B, M, out_size, out_size), np.float32),
        "gt_semantic": np.zeros((B, image_size, image_size), np.float32),
    }
    from PIL import Image

    for i, s in enumerate(samples):
        img = s["image"]
        if img.shape[:2] != (image_size, image_size):
            img = np.asarray(Image.fromarray(
                ((img - img.min()) / max(np.ptp(img), 1e-6) * 255).astype(np.uint8)
            ).resize((image_size, image_size)), np.float32)
        batch["images"][i] = img
        n = min(len(s["points_choose"]), M)
        scale = image_size / s["image"].shape[1]
        batch["gt_points"][i, :n] = s["points_choose"][:n] * scale
        batch["gt_valid"][i, :n] = True
        for c in range(n):
            m = s["inst_masks"][c].astype(np.uint8) * 255
            m = np.asarray(Image.fromarray(m).resize((out_size, out_size)))
            batch["gt_cell_masks"][i, c] = (m > 127).astype(np.float32)
        sem = np.asarray(Image.fromarray(s["binary_mask"] * 255).resize(
            (image_size, image_size)))
        batch["gt_semantic"][i] = (sem > 127).astype(np.float32)
    return batch
