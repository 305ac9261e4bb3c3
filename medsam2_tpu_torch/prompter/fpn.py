"""mmdet-style FPN of the prompter (counterpart of
``medsam2_tpu/prompter/fpn.py``; reference ``sam2_train/modeling/fpn.py``):
lateral 1x1 convs, nearest top-down fusion, 3x3 output convs."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from medsam2_tpu_torch.core import layers


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int, gen: torch.Generator):
        super().__init__()
        self.lateral = nn.ModuleList(layers.Conv2d(c, out_channels, 1, gen) for c in in_channels)
        self.fpn = nn.ModuleList(layers.Conv2d(out_channels, out_channels, 3, gen, padding=1)
                                 for _ in in_channels)

    def forward(self, feats: List[torch.Tensor], num_outs: int) -> List[torch.Tensor]:
        """feats: highest resolution first. Returns the first ``num_outs``
        levels (``fpn.py:15-283`` with its default options); the output convs
        of the levels not returned are not run."""
        laterals = [conv(f) for conv, f in zip(self.lateral, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            up = layers.interpolate(laterals[i].float(), (h, w), method="nearest")
            laterals[i - 1] = laterals[i - 1] + up.to(laterals[i].dtype)
        return [conv(lat) for conv, lat in zip(self.fpn[:num_outs], laterals[:num_outs])]
