"""Memory attention + memory encoder (counterpart of
``medsam2_tpu/core/memory.py``).

Memory attention: per layer, RoPE self-attention over the current frame's
tokens, cross-attention to the memory, FFN. The cross-attention reads the
memory either in storage order over the bank's roped-key cache (kv-cached
kernel, inference; the k cache is written once per frame by
:func:`precompute_memory_kcache` plus a session-static positional half from
:func:`precompute_pos_kcache`), or in read order with a validity mask (flash
kernel) over the same cache gathered into read order (``k_cache``,
inference) or over raw memory tokens (differentiable: the training path, and
inference without the cache). Residual and
FFN dropout (rate ``cfg.dropout``) is active only when a ``torch.Generator``
is passed, as the JAX package's only when a dropout key is.

Memory encoder: mask -> strided-conv downsampler (16x) + projected pixel
features -> 2 ConvNeXt blocks -> 1x1 projection 256 -> 64.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from medsam2_tpu_torch.configs import MemoryAttentionConfig, MemoryEncoderConfig
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.pos_enc import sine_pos_embed
from medsam2_tpu_torch.core.transformer import (Attention, rope_attn_apply,
                                                rope_attn_storage, roped_k_for_tokens)

_ACTIVATIONS = {"relu": F.relu, "gelu": layers.gelu}


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout drawing its keep mask from ``generator`` (on x's
    device); the identity without a generator (``memory._dropout``)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.self_attn = Attention(d, cfg.self_attn_num_heads, gen)
        self.cross_attn_image = Attention(d, cfg.cross_attn_num_heads, gen,
                                          kv_in_dim=cfg.kv_in_dim)
        self.linear1 = layers.Linear(d, cfg.dim_feedforward, gen)
        self.linear2 = layers.Linear(cfg.dim_feedforward, d, gen)
        self.norm1 = layers.LayerNorm(d)
        self.norm2 = layers.LayerNorm(d)
        self.norm3 = layers.LayerNorm(d)

    def forward(self, tgt, query_pos, q_hw: Tuple[int, int], *, memory=None,
                memory_pos=None, num_obj_ptr_tokens: int = 0, kv_mask=None,
                kv_bundle: Optional[dict] = None, k_cached=None, layer: int = 0,
                generator: Optional[torch.Generator] = None):
        """``memory_attention.py:58-104``: cross-attention over the
        storage-order ``kv_bundle`` when given, else over ``memory`` in read
        order (the last ``num_obj_ptr_tokens`` tokens skip RoPE). With
        ``k_cached`` [B, Nc, C] (this layer's roped spatial keys) only the
        pointer tokens after them are projected into keys."""
        cfg = self.cfg
        rate = cfg.dropout
        tgt2 = self.norm1(tgt)
        q = tgt2 + query_pos if cfg.pos_enc_at_attn else tgt2
        tgt2 = rope_attn_apply(self.self_attn, q, q, tgt2, q_hw=q_hw,
                               rope_theta=cfg.rope_theta)
        tgt = tgt + dropout(tgt2, rate, generator)
        tgt2 = self.norm2(tgt)
        q = tgt2 + query_pos if cfg.pos_enc_at_cross_attn_queries else tgt2
        if kv_bundle is not None:
            tgt2 = rope_attn_storage(self.cross_attn_image, q, kv_bundle, layer,
                                     q_hw=q_hw, rope_theta=cfg.rope_theta)
        else:
            n = 0 if k_cached is None else k_cached.shape[1]
            k = memory[:, n:]
            if cfg.pos_enc_at_cross_attn_keys:
                k = k + memory_pos[:, n:]
            tgt2 = rope_attn_apply(self.cross_attn_image, q, k, memory, q_hw=q_hw,
                                   rope_theta=cfg.rope_theta, rope_k_repeat=True,
                                   num_k_exclude_rope=num_obj_ptr_tokens, kv_mask=kv_mask,
                                   k_cached=k_cached)
        tgt = tgt + dropout(tgt2, rate, generator)
        tgt2 = self.norm3(tgt)
        tgt2 = self.linear2(dropout(_ACTIVATIONS[cfg.activation](self.linear1(tgt2)),
                                    rate, generator))
        return tgt + dropout(tgt2, rate, generator)


class MemoryAttention(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg, gen)
                                    for _ in range(cfg.num_layers))
        self.norm = layers.LayerNorm(cfg.d_model)

    def forward(self, curr, curr_pos, q_hw: Tuple[int, int], *, memory=None,
                memory_pos=None, num_obj_ptr_tokens: int = 0, kv_mask=None,
                kv_bundle: Optional[dict] = None, k_cache=None,
                generator: Optional[torch.Generator] = None):
        """``MemoryAttention.forward`` (``memory_attention.py:119-169``).
        curr/curr_pos [B, Nq, C] -> [B, Nq, C]. The memory is either the
        storage-order ``kv_bundle`` (see :func:`rope_attn_storage`) or raw
        tokens ``memory``/``memory_pos`` [B, Nk, mem_dim] with ``kv_mask``
        [B, Nk] (True = attend). ``k_cache`` = (memory part [B, Fa, L, P, C],
        positional part [Fa, L, P, C]): the roped-key cache in read order,
        summed per layer into that layer's spatial keys, so the spatial
        memory tokens are not projected or rotated again."""
        out = curr
        if self.cfg.pos_enc_at_input and curr_pos is not None:
            out = out + 0.1 * curr_pos
        for li, layer in enumerate(self.layers):
            k_cached = None
            if k_cache is not None and kv_bundle is None:
                mem_part, pos_part = k_cache
                kc = mem_part[:, :, li] + pos_part[None, :, li].to(mem_part.dtype)
                k_cached = kc.reshape(kc.shape[0], -1, kc.shape[-1])
            out = layer(out, curr_pos, q_hw, memory=memory, memory_pos=memory_pos,
                        num_obj_ptr_tokens=num_obj_ptr_tokens, kv_mask=kv_mask,
                        kv_bundle=kv_bundle, k_cached=k_cached, layer=li,
                        generator=generator)
        return self.norm(out)


def precompute_memory_kcache(mem_attn: MemoryAttention, feats, q_hw: Tuple[int, int],
                             dtype=torch.bfloat16):
    """Per-layer roped k projections of one frame's memory features:
    feats [B, P, mem_dim] -> [B, L, P, d_model] (no bias: the positional half
    carries it)."""
    ks = [roped_k_for_tokens(layer.cross_attn_image, feats, q_hw,
                             mem_attn.cfg.rope_theta, with_bias=False).to(dtype)
          for layer in mem_attn.layers]
    return torch.stack(ks, dim=1)


def precompute_pos_kcache(mem_attn: MemoryAttention, pos_rows, q_hw: Tuple[int, int],
                          dtype=torch.bfloat16):
    """Session-static positional half of the k cache, with bias:
    pos_rows [Fa, P, mem_dim] -> [Fa, L, P, d_model]."""
    ks = [roped_k_for_tokens(layer.cross_attn_image, pos_rows, q_hw,
                             mem_attn.cfg.rope_theta, with_bias=True).to(dtype)
          for layer in mem_attn.layers]
    return torch.stack(ks, dim=1)


# ---------------------------------------------------------------------------
# Memory encoder
# ---------------------------------------------------------------------------


def _mask_downsampler_layout(cfg: MemoryEncoderConfig):
    num_layers = int(math.log2(cfg.mask_downsampler_total_stride)
                     // math.log2(cfg.mask_downsampler_stride))
    chans = [1]
    for _ in range(num_layers):
        chans.append(chans[-1] * cfg.mask_downsampler_stride ** 2)
    return num_layers, chans


class MaskDownSampler(nn.Module):
    """``encoder``: (conv, LayerNorm2d, GELU) per stride-2 step, then a 1x1
    conv to the embedding width — the reference's Sequential indices."""

    def __init__(self, cfg: MemoryEncoderConfig, gen: torch.Generator):
        super().__init__()
        num_layers, chans = _mask_downsampler_layout(cfg)
        mods = []
        for i in range(num_layers):
            mods += [layers.Conv2d(chans[i], chans[i + 1], cfg.mask_downsampler_kernel, gen,
                                   stride=cfg.mask_downsampler_stride,
                                   padding=cfg.mask_downsampler_padding),
                     layers.LayerNorm2d(chans[i + 1]),
                     layers.GELU()]
        mods.append(layers.Conv2d(chans[-1], cfg.in_dim, 1, gen))
        self.encoder = nn.Sequential(*mods)

    def forward(self, x):
        return self.encoder(x)


class CXBlock(nn.Module):
    """ConvNeXt block (``memory_encoder.py:62-117``), NHWC."""

    def __init__(self, dim: int, cfg: MemoryEncoderConfig, gen: torch.Generator):
        super().__init__()
        self.dwconv = layers.Conv2d(dim, dim, cfg.fuser_kernel_size, gen,
                                    padding=cfg.fuser_padding, groups=dim)
        self.norm = layers.LayerNorm2d(dim)
        self.pwconv1 = layers.Linear(dim, 4 * dim, gen)
        self.pwconv2 = layers.Linear(4 * dim, dim, gen)
        self.gamma = nn.Parameter(cfg.fuser_layer_scale_init * torch.ones(dim))

    def forward(self, x):
        y = self.pwconv2(layers.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + self.gamma.to(y.dtype) * y


class Fuser(nn.Module):
    def __init__(self, dim: int, cfg: MemoryEncoderConfig, gen: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim, cfg, gen)
                                    for _ in range(cfg.fuser_num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: MemoryEncoderConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.mask_downsampler = MaskDownSampler(cfg, gen)
        self.pix_feat_proj = layers.Conv2d(cfg.in_dim, cfg.in_dim, 1, gen)
        self.fuser = Fuser(cfg.in_dim, cfg, gen)
        if cfg.out_dim != cfg.in_dim:
            self.out_proj = layers.Conv2d(cfg.in_dim, cfg.out_dim, 1, gen)

    def forward(self, pix_feat, masks):
        """pix_feat [B, H, W, in_dim], masks [B, 16H, 16W, 1] (already scaled
        by the caller) -> (features [B, H, W, out_dim], pos [H, W, out_dim])
        (``memory_encoder.py:158-181``)."""
        feats = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        feats = self.fuser(feats)
        if self.cfg.out_dim != self.cfg.in_dim:
            feats = self.out_proj(feats)
        h, w = feats.shape[1], feats.shape[2]
        return feats, sine_pos_embed(h, w, self.cfg.num_pos_feats, device=feats.device,
                                     dtype=feats.dtype)
