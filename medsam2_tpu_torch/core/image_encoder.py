"""Image encoder: Hiera trunk + FPN neck (counterpart of
``medsam2_tpu/core/image_encoder.py``). NHWC outputs, highest resolution
first; sine position encodings per level from static shapes."""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from medsam2_tpu_torch.configs import FpnNeckConfig, SAM2Config
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.hiera import Hiera
from medsam2_tpu_torch.core.pos_enc import sine_pos_embed


class _NeckConv(nn.Module):
    def __init__(self, dim: int, cfg: FpnNeckConfig, gen: torch.Generator):
        super().__init__()
        self.conv = layers.Conv2d(dim, cfg.d_model, cfg.kernel_size, gen,
                                  stride=cfg.stride, padding=cfg.padding)


class FpnNeck(nn.Module):
    def __init__(self, cfg: FpnNeckConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(_NeckConv(d, cfg, gen) for d in cfg.backbone_channel_list)

    def forward(self, xs: List[torch.Tensor]):
        """xs: trunk outputs, highest-res first. Returns (features, pos)
        lists, highest-res first (``image_encoder.py:101-133``)."""
        cfg = self.cfg
        n = len(self.convs) - 1
        out = [None] * (n + 1)
        pos = [None] * (n + 1)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i].conv(xs[i])
            if i in cfg.fpn_top_down_levels and prev is not None:
                top_down = layers.interpolate(
                    prev.float(), (lateral.shape[1], lateral.shape[2]),
                    method=cfg.fpn_interp_model).to(lateral.dtype)
                prev = lateral + top_down
                if cfg.fuse_type == "avg":
                    prev = prev / 2
            else:
                prev = lateral
            out[i] = prev
            pe = sine_pos_embed(prev.shape[1], prev.shape[2], cfg.num_pos_feats,
                                device=prev.device, dtype=prev.dtype)
            pos[i] = pe[None].expand(prev.shape)
        return out, pos


class ImageEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config, gen: torch.Generator):
        super().__init__()
        self.scalp = cfg.scalp
        self.trunk = Hiera(cfg.trunk, gen)
        self.neck = FpnNeck(cfg.neck, gen)

    def forward(self, sample, trunk_pos_embed=None) -> Dict:
        """sample [B, H, W, 3] -> ``vision_features`` (lowest kept level),
        ``vision_pos_enc``, ``backbone_fpn`` (``image_encoder.py:29-42``)."""
        features, pos = self.neck(self.trunk(sample, pos_embed=trunk_pos_embed))
        if self.scalp > 0:
            features, pos = features[: -self.scalp], pos[: -self.scalp]
        return {"vision_features": features[-1], "vision_pos_enc": pos,
                "backbone_fpn": features}
