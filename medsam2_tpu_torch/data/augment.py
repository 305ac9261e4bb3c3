"""Host-side training augmentation for the nuclei recipe (counterpart of
``medsam2_tpu/data/augment.py``, numpy only; the draws come from the
caller's ``np.random.Generator`` in the same order, so both packages give
the same crops, flips, rotations and jitter).

The reference trains MoNuSeg/CPM through a configurable albumentations stack
(``func_2d/monuseg.py:39-55``: the transform list comes from the missing
mmengine data config; the crop-based 256-px recipe implies random crops plus
the standard flips/rot90/color-jitter nucleus-segmentation pipeline). Here the
same pipeline is plain seedable numpy on (image, instance map) pairs:

- random crop to ``crop_size`` (pixel-exact, no interpolation),
- horizontal/vertical flips + 90-degree rotations (dihedral group),
- brightness/contrast/saturation jitter on the raw image only.

Geometry transforms are applied to the *instance map*; per-cell prompts and
masks are re-derived downstream from the augmented map, so points stay
consistent with their cells by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class NucleiAugmentConfig:
    crop_size: int = 256
    p_hflip: float = 0.5
    p_vflip: float = 0.5
    p_rot90: float = 0.5          # then k in {1,2,3} uniformly
    p_color: float = 0.5
    brightness: float = 0.2       # multiplicative jitter range +-
    contrast: float = 0.2
    saturation: float = 0.2
    # retry crops that land on empty background (keeps at least one nucleus
    # when the source tile has any); 0 disables
    min_cell_retries: int = 4


def _pad_reflect(arr: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Reflect-pad the first two axes by (ph, pw). np.pad 'reflect' requires
    pad < dim, so tiles much smaller than the crop (e.g. 100 px tile, 256
    crop) are padded in chunks; 1-px dims fall back to edge padding."""
    while ph > 0 or pw > 0:
        dh = min(ph, max(arr.shape[0] - 1, 1))
        dw = min(pw, max(arr.shape[1] - 1, 1))
        widths = ((0, dh), (0, dw)) + ((0, 0),) * (arr.ndim - 2)
        mode = "reflect" if min(arr.shape[0], arr.shape[1]) > 1 else "edge"
        arr = np.pad(arr, widths, mode=mode)
        ph -= dh
        pw -= dw
    return arr


def random_crop_pair(img: np.ndarray, inst_map: np.ndarray, size: int,
                     rng: np.random.Generator,
                     min_cell_retries: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Random ``size``x``size`` crop of (image, instance map); pads (reflect)
    when the source is smaller. Retries up to ``min_cell_retries`` times to
    land a crop containing at least one instance pixel."""
    H, W = inst_map.shape[:2]
    if H < size or W < size:
        ph, pw = max(size - H, 0), max(size - W, 0)
        img = _pad_reflect(img, ph, pw)
        inst_map = _pad_reflect(inst_map, ph, pw)
        H, W = inst_map.shape[:2]
    for _ in range(max(min_cell_retries, 0) + 1):
        y0 = int(rng.integers(0, H - size + 1))
        x0 = int(rng.integers(0, W - size + 1))
        crop_inst = inst_map[y0:y0 + size, x0:x0 + size]
        if crop_inst.max() > 0 or inst_map.max() == 0:
            break
    return img[y0:y0 + size, x0:x0 + size], crop_inst


def color_jitter(img: np.ndarray, cfg: NucleiAugmentConfig,
                 rng: np.random.Generator) -> np.ndarray:
    """Brightness/contrast/saturation jitter on a [0, 255] float image."""
    out = img.astype(np.float32)
    b = 1.0 + rng.uniform(-cfg.brightness, cfg.brightness)
    c = 1.0 + rng.uniform(-cfg.contrast, cfg.contrast)
    s = 1.0 + rng.uniform(-cfg.saturation, cfg.saturation)
    out = out * b
    mean = out.mean()
    out = (out - mean) * c + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * s + gray
    return np.clip(out, 0.0, 255.0)


def augment_nuclei(img: np.ndarray, inst_map: np.ndarray,
                   cfg: NucleiAugmentConfig,
                   rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the full pipeline to a raw [0,255] image + instance map pair.
    Returns float32 image [crop, crop, 3] and int32 instance map."""
    img, inst_map = random_crop_pair(img, inst_map, cfg.crop_size, rng,
                                     cfg.min_cell_retries)
    img = np.ascontiguousarray(img.astype(np.float32))
    inst_map = np.ascontiguousarray(inst_map)
    if rng.random() < cfg.p_hflip:
        img, inst_map = img[:, ::-1], inst_map[:, ::-1]
    if rng.random() < cfg.p_vflip:
        img, inst_map = img[::-1], inst_map[::-1]
    if rng.random() < cfg.p_rot90:
        k = int(rng.integers(1, 4))
        img = np.rot90(img, k, axes=(0, 1))
        inst_map = np.rot90(inst_map, k, axes=(0, 1))
    if rng.random() < cfg.p_color:
        img = color_jitter(img, cfg, rng)
    return (np.ascontiguousarray(img, np.float32),
            np.ascontiguousarray(inst_map, np.int32))
