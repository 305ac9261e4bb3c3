"""Prompt encoder (counterpart of ``medsam2_tpu/core/prompt_encoder.py``).

Points are a fixed-size [B, P, 2] array with int labels; label -1 is padding
(``not_a_point_embed``). Boxes arrive as two points labelled 2/3. Dense
embeddings are force-resized to ``cfg.dense_embed_size`` when the config sets
it (the fork's 16x16 nuclei behaviour)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from medsam2_tpu_torch.configs import SAM2Config
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.pos_enc import PositionEmbeddingRandom


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_dim
        mask_in = cfg.mask_in_chans
        self.pe_layer = PositionEmbeddingRandom(dim // 2, gen)
        # neg (0), pos (1), box top-left (2), box bottom-right (3)
        self.point_embeddings = nn.ModuleList(layers.Embedding(1, dim, gen) for _ in range(4))
        self.not_a_point_embed = layers.Embedding(1, dim, gen)
        self.no_mask_embed = layers.Embedding(1, dim, gen)
        self.mask_downscaling = nn.Sequential(
            layers.Conv2d(1, mask_in // 4, 2, gen, stride=2),
            layers.LayerNorm2d(mask_in // 4),
            layers.GELU(),
            layers.Conv2d(mask_in // 4, mask_in, 2, gen, stride=2),
            layers.LayerNorm2d(mask_in),
            layers.GELU(),
            layers.Conv2d(mask_in, dim, 1, gen),
        )

    def get_dense_pe(self):
        """[1, h, w, C] dense position encoding for the decoder."""
        s = self.cfg.sam_image_embedding_size
        return self.pe_layer.grid(s, s)[None]

    def embed_points(self, coords, labels):
        """coords [B, P, 2] pixel (x, y); labels [B, P] in {-1, 0, 1, 2, 3}.
        Appends the reference's sentinel padding point."""
        B = coords.shape[0]
        coords = torch.cat([coords.float() + 0.5, coords.new_zeros(B, 1, 2)], dim=1)
        labels = torch.cat([labels, -labels.new_ones(B, 1)], dim=1)
        S = self.cfg.image_size
        pe = self.pe_layer.points(coords, (S, S))
        pe = torch.where((labels == -1)[..., None], torch.zeros_like(pe), pe)
        table = torch.cat([self.not_a_point_embed.weight]
                          + [p.weight for p in self.point_embeddings], dim=0)
        return pe + table[labels.long() + 1]

    def forward(self, points: Tuple[torch.Tensor, torch.Tensor],
                masks: Optional[torch.Tensor] = None):
        """Returns (sparse [B, N, C], dense [B, h, w, C])
        (``prompt_encoder.py:140-190``)."""
        coords, labels = points
        bs = coords.shape[0]
        sparse = self.embed_points(coords, labels)
        dim = self.cfg.hidden_dim
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            s = self.cfg.sam_image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, dim).expand(bs, s, s, dim)
        if self.cfg.dense_embed_size is not None:
            d = self.cfg.dense_embed_size
            dense = layers.interpolate(dense, (d, d), method="bilinear")
        return sparse, dense
