"""Image / coordinate transforms (counterpart of
``medsam2_tpu/utils/transforms.py``): resize to the model resolution and
ImageNet-normalise, map coordinates and boxes to model space, and bring mask
logits back to the original resolution."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from medsam2_tpu_torch.core import layers

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _normalise(x: torch.Tensor) -> torch.Tensor:
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std


def preprocess_video(images: np.ndarray, resolution: int, device) -> torch.Tensor:
    """[T, H, W, 3] RGB (uint8, or float in [0, 255] or [0, 1]) -> [T, S, S, 3]
    float32, bilinear-resized without antialias and ImageNet-normalised, on
    ``device``. uint8 input always scales by 1/255; float input scales when
    its maximum exceeds 2 (``video_predictor.init_state``)."""
    images = np.asarray(images)
    x = torch.from_numpy(images.astype(np.float32)).to(device)
    if images.dtype == np.uint8 or float(images.max()) > 2.0:
        x = x / 255.0
    return _normalise(layers.interpolate(x, (resolution, resolution), method="bilinear"))


class SAM2Transforms:
    """``SAM2Transforms`` (reference ``transforms.py:15-99``). Images and
    masks are torch tensors on ``device``; coordinates stay numpy."""

    def __init__(self, resolution: int, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0, device="cuda"):
        self.resolution = resolution
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self.device = torch.device(device)

    def __call__(self, image: np.ndarray) -> torch.Tensor:
        """HWC uint8 / float image -> [S, S, 3] normalised float32. Scales by
        1/255 for uint8 or a maximum above 2; the resize antialiases, as
        torchvision's ``Resize`` does on tensors."""
        image = np.asarray(image)
        x = torch.from_numpy(image.astype(np.float32)).to(self.device)
        if image.dtype == np.uint8 or float(x.max()) > 2.0:
            x = x / 255.0
        x = layers.interpolate(x[None], (self.resolution, self.resolution),
                               method="bilinear", antialias=True)[0]
        return _normalise(x)

    def forward_batch(self, images) -> torch.Tensor:
        return torch.stack([self(im) for im in images])

    def transform_coords(self, coords: np.ndarray, normalize: bool = False,
                         orig_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """(x, y) pixel coordinates -> model resolution (``transforms.py:44-60``)."""
        coords = np.asarray(coords, np.float32).copy()
        if normalize:
            assert orig_hw is not None
            h, w = orig_hw
            coords[..., 0] = coords[..., 0] / w
            coords[..., 1] = coords[..., 1] / h
        return coords * self.resolution

    def transform_boxes(self, boxes: np.ndarray, normalize: bool = False,
                        orig_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """XYXY boxes -> [B, 2, 2] corner points in model space."""
        return self.transform_coords(np.asarray(boxes, np.float32).reshape(-1, 2, 2),
                                     normalize, orig_hw)

    def postprocess_masks(self, masks: torch.Tensor, orig_hw: Tuple[int, int]) -> torch.Tensor:
        """[B, M, h, w] logits -> [B, M, H, W] fp32 at the original size, by
        bilinear resize, after hole and sprinkle filling when configured
        (``transforms.py:74-99``)."""
        if self.max_hole_area > 0 or self.max_sprinkle_area > 0:
            from medsam2_tpu_torch.ops.connected_components import fill_holes_and_sprinkles

            masks = fill_holes_and_sprinkles(masks, self.max_hole_area, self.max_sprinkle_area)
        x = layers.interpolate(masks.float().permute(0, 2, 3, 1), tuple(orig_hw),
                               method="bilinear")
        return x.permute(0, 3, 1, 2)
