"""Mask decoder (counterpart of ``medsam2_tpu/core/mask_decoder.py``).

Tokens [obj_score, iou, 4 mask tokens, sparse prompts] run through the
two-way transformer against the dense-prompt-conditioned image embedding;
masks come from hypernetwork MLPs over a 4x-upscaled embedding fused with the
high-res skip features, plus IoU and object-score heads and the dynamic
single/multi-mask stability fallback. ``image_indices`` maps each prompt row
to its image (the JAX package's gather, ``mask_decoder.py:89-92``), so that
one call decodes the prompts of several images."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from medsam2_tpu_torch.configs import SAM2Config
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAM2Config, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_dim
        n_tokens = cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(cfg.twoway_depth, dim, cfg.twoway_num_heads,
                                             cfg.twoway_mlp_dim, gen,
                                             cfg.attention_downsample_rate)
        self.iou_token = layers.Embedding(1, dim, gen)
        self.mask_tokens = layers.Embedding(n_tokens, dim, gen)
        self.output_upscaling = nn.Sequential(
            layers.ConvTranspose2d(dim, dim // 4, 2, gen),
            layers.LayerNorm2d(dim // 4),
            layers.GELU(),
            layers.ConvTranspose2d(dim // 4, dim // 8, 2, gen),
            layers.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            layers.MLP(dim, dim, dim // 8, 3, gen) for _ in range(n_tokens))
        self.iou_prediction_head = layers.MLP(
            dim, cfg.iou_head_hidden_dim, n_tokens, cfg.iou_head_depth, gen,
            sigmoid_output=cfg.iou_prediction_use_sigmoid)
        if cfg.use_high_res_features_in_sam:
            self.conv_s0 = layers.Conv2d(dim, dim // 8, 1, gen)
            self.conv_s1 = layers.Conv2d(dim, dim // 4, 1, gen)
        if cfg.pred_obj_scores:
            self.obj_score_token = layers.Embedding(1, dim, gen)
            if cfg.pred_obj_scores_mlp:
                self.pred_obj_score_head = layers.MLP(dim, dim, 1, 3, gen)
            else:
                self.pred_obj_score_head = layers.Linear(dim, 1, gen)

    def predict_masks(self, image_embeddings, image_pe, sparse, dense,
                      high_res_features: Optional[List[torch.Tensor]] = None,
                      image_indices: Optional[torch.Tensor] = None):
        cfg = self.cfg
        n_tokens = cfg.num_multimask_outputs + 1
        s = 1 if cfg.pred_obj_scores else 0
        N = sparse.shape[0]
        dtype = image_embeddings.dtype
        token_list = [self.iou_token.weight, self.mask_tokens.weight]
        if cfg.pred_obj_scores:
            token_list.insert(0, self.obj_score_token.weight)
        out_tokens = torch.cat(token_list, dim=0).to(dtype)
        tokens = torch.cat([out_tokens[None].expand(N, *out_tokens.shape),
                            sparse.to(dtype)], dim=1)

        if image_indices is not None:
            image_embeddings = image_embeddings.index_select(0, image_indices)
            if high_res_features:
                high_res_features = [f.index_select(0, image_indices)
                                     for f in high_res_features]
        src = image_embeddings + dense.to(dtype)
        pos_src = image_pe.to(dtype).expand(src.shape)
        b, h, w, c = src.shape
        hs, src_out = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, s, :]
        mask_tokens_out = hs[:, s + 1: s + 1 + n_tokens, :]

        src_out = src_out.reshape(b, h, w, c)
        dc1, ln, act1, dc2, act2 = self.output_upscaling
        x = dc1(src_out)
        if cfg.use_high_res_features_in_sam:
            feat_s0, feat_s1 = high_res_features
            x = act1(ln(x + feat_s1.to(dtype)))
            upscaled = act2(dc2(x) + feat_s0.to(dtype))
        else:
            upscaled = act2(dc2(act1(ln(x))))

        hyper_in = torch.stack([mlp(mask_tokens_out[:, i, :])
                                for i, mlp in enumerate(self.output_hypernetworks_mlps)],
                               dim=1)                              # [N, M, C/8]
        masks = torch.einsum("nmc,nhwc->nmhw", hyper_in, upscaled)
        iou_pred = self.iou_prediction_head(iou_token_out)
        if cfg.pred_obj_scores:
            obj_logits = self.pred_obj_score_head(hs[:, 0, :])
        else:
            obj_logits = 10.0 * iou_pred.new_ones(N, 1)
        return masks, iou_pred, mask_tokens_out, obj_logits

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output: bool,
                high_res_features=None, dynamic_multimask_via_stability: bool = False,
                image_indices: Optional[torch.Tensor] = None):
        """Returns (masks [N, M, H, W], iou_pred [N, M], sam_tokens_out
        [N, m, C], object_score_logits [N, 1]) (``mask_decoder.py:110-168``).
        ``image_indices`` [N] picks each prompt row's image from the batch of
        ``image_embeddings`` and ``high_res_features``."""
        masks, iou_pred, mask_tokens_out, obj_logits = self.predict_masks(
            image_embeddings, image_pe, sparse, dense, high_res_features, image_indices)
        if multimask_output:
            masks, iou_pred = masks[:, 1:], iou_pred[:, 1:]
        elif dynamic_multimask_via_stability:
            masks, iou_pred = _dynamic_multimask_via_stability(masks, iou_pred)
        else:
            masks, iou_pred = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and self.cfg.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return masks, iou_pred, sam_tokens_out, obj_logits


# the reference's dynamic_multimask_stability_{delta,thresh} defaults
STABILITY_DELTA = 0.05
STABILITY_THRESH = 0.98


def _stability_scores(mask_logits, delta: float):
    flat = mask_logits.flatten(-2)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp_min(1), torch.ones_like(area_u))


def _dynamic_multimask_via_stability(masks, iou_pred):
    """Fall back from the single-mask token to the best multimask token when
    the single mask is unstable (``mask_decoder.py:281-317``)."""
    multi_logits, multi_iou = masks[:, 1:], iou_pred[:, 1:]
    best = multi_iou.argmax(dim=-1)
    bidx = torch.arange(masks.shape[0], device=masks.device)
    best_logits = multi_logits[bidx, best][:, None]
    best_iou = multi_iou[bidx, best][:, None]
    single_logits, single_iou = masks[:, 0:1], iou_pred[:, 0:1]
    stable = _stability_scores(single_logits, STABILITY_DELTA) >= STABILITY_THRESH
    out_masks = torch.where(stable[..., None, None], single_logits, best_logits)
    out_iou = torch.where(stable, single_iou, best_iou)
    return out_masks, out_iou
