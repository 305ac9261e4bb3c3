"""Input normalisation used by ``init_state`` (counterpart of the part of
``medsam2_tpu/utils/transforms.py`` the propagation path reaches)."""

from __future__ import annotations

import numpy as np
import torch

from medsam2_tpu_torch.core import layers

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_video(images: np.ndarray, resolution: int, device) -> torch.Tensor:
    """[T, H, W, 3] RGB (uint8, or float in [0, 255] or [0, 1]) -> [T, S, S, 3]
    float32, bilinear-resized without antialias and ImageNet-normalised, on
    ``device``. uint8 input always scales by 1/255; float input scales when
    its maximum exceeds 2 (``video_predictor.init_state``)."""
    images = np.asarray(images)
    x = torch.from_numpy(images.astype(np.float32)).to(device)
    if images.dtype == np.uint8 or float(images.max()) > 2.0:
        x = x / 255.0
    x = layers.interpolate(x, (resolution, resolution), method="bilinear")
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    return (x - mean) / std
