"""Connected components on the device (counterpart of
``medsam2_tpu/ops/connected_components.py``), with the same algorithm, so
the two agree: every foreground pixel starts with its own label, then 32
sweeps of a 3x3 max-pool (8-connectivity) masked to the foreground, each
followed by a pointer jump (a pixel takes the label its label's pixel holds).
Component areas come from a scatter-add over the labels.

The sweeps bound the reach: a component wider than they reach keeps more
than one label, as in the JAX package (a true CCL such as scipy's would
differ there). The consumers, hole filling and AMG's small-region removal,
only need small components labelled right.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def connected_components(mask: torch.Tensor, num_sweeps: int = 32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """8-connectivity components of a bool mask [B, H, W]. Returns (labels
    [B, H, W] int64, 0 = background, a distinct positive id per component;
    areas [B, H, W] int64, the pixel's component area, 0 on background)."""
    B, H, W = mask.shape
    mask = mask.bool()
    idx = torch.arange(1, H * W + 1, device=mask.device, dtype=torch.float32).reshape(1, H, W)
    # float32 holds every label exactly (H * W < 2^24); max-pool takes floats
    labels = torch.where(mask, idx, torch.zeros((), device=mask.device))
    for _ in range(num_sweeps):
        pooled = F.max_pool2d(labels[:, None], 3, stride=1, padding=1)[:, 0]
        labels = torch.where(mask, pooled, torch.zeros_like(pooled))
        flat = labels.reshape(B, H * W)
        parent = torch.gather(flat, 1, (flat.long() - 1).clamp(min=0)).reshape(B, H, W)
        labels = torch.where(mask, torch.maximum(labels, parent), torch.zeros_like(labels))
    flat = labels.long().reshape(B, H * W)
    counts = torch.zeros(B, H * W + 1, dtype=torch.int64, device=mask.device)
    counts.scatter_add_(1, flat, mask.reshape(B, H * W).long())
    areas = torch.gather(counts, 1, flat).reshape(B, H, W) * mask
    return flat.reshape(B, H, W), areas


def fill_holes_in_mask_scores(mask_logits: torch.Tensor, max_area: int,
                              num_sweeps: int = 32) -> torch.Tensor:
    """Holes (components of logits <= 0) of area <= ``max_area`` get the
    score 0.1 (``utils/misc.py:247-258``). mask_logits [B, M, H, W]."""
    if max_area <= 0:
        return mask_logits
    B, M, H, W = mask_logits.shape
    flat = mask_logits.reshape(B * M, H, W)
    holes = flat <= 0
    _, areas = connected_components(holes, num_sweeps)
    filled = torch.where(holes & (areas <= max_area), torch.full_like(flat, 0.1), flat)
    return filled.reshape(B, M, H, W)


def remove_small_regions(mask: torch.Tensor, area_thresh: float, mode: str,
                         num_sweeps: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove small islands or fill small holes of a bool mask [H, W]
    (``utils/amg.py:269-293``). Returns (mask, changed) as tensors. A region
    is small when its area is below ``area_thresh``; when every island is
    small, the largest is kept, ties going to the smallest label."""
    assert mode in ("holes", "islands")
    working = ~mask if mode == "holes" else mask
    labels, areas = connected_components(working[None], num_sweeps)
    labels, areas = labels[0], areas[0]
    small = (areas > 0) & (areas < area_thresh)
    changed = small.any()
    working = working & ~small
    if mode == "islands":
        max_area = areas.max()
        big = torch.iinfo(torch.int64).max
        tie_label = torch.where(areas == max_area, labels, torch.full_like(labels, big)).min()
        largest_only = (labels == tie_label) & mask
        return torch.where(working.any(), working, largest_only), changed
    return ~working, changed


def fill_holes_and_sprinkles(mask_logits: torch.Tensor, max_hole_area: float,
                             max_sprinkle_area: float) -> torch.Tensor:
    """Hole and sprinkle filling of ``SAM2Transforms.postprocess_masks``
    (``utils/transforms.py:74-99``): small holes -> 0.1, small positive
    components -> -0.1."""
    x = mask_logits
    if max_hole_area > 0:
        x = fill_holes_in_mask_scores(x, int(max_hole_area))
    if max_sprinkle_area > 0:
        B, M, H, W = x.shape
        flat = x.reshape(B * M, H, W)
        pos = flat > 0
        _, areas = connected_components(pos)
        flat = torch.where(pos & (areas <= max_sprinkle_area), torch.full_like(flat, -0.1), flat)
        x = flat.reshape(B, M, H, W)
    return x
