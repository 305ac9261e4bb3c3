"""Hiera trunk (counterpart of ``medsam2_tpu/core/hiera.py``).

7x7/stride-4 patch embed -> MultiScaleBlocks with window attention, a few
global-attention blocks and max-pool q-pooling at stage transitions; windowed
absolute position embedding. Returns per-stage NHWC feature maps.

The port computes the reference math once: the JAX package's TPU-only
relayouts (width-folded / space-to-depth patch embed, split qkv, dot6d window
attention, chained window layout) are exact rewrites of this same math for
TPU tile layouts and have no counterpart here. Global-attention blocks reach
the flash kernel through :func:`medsam2_tpu_torch.ops.attention.attention`.

The encoder kernels sit behind the JAX package's switches, all off by
default, and run where its default dispatch (chained windows on,
``hiera.py:286-370``) runs them:

- ``MEDSAM2_FUSED_BLOCK=1``: a plain windowed block (no q-pooling, no dim
  change) whose extent divides its window size runs whole as the fused block
  (:mod:`~medsam2_tpu_torch.ops.fused_block`) on its window partition;
- ``MEDSAM2_FUSED_WINDOW=1``: a plain windowed block that needs padding takes
  its attention from :func:`~medsam2_tpu_torch.ops.window_attention.window_attention`
  on the padded qkv (the normed input is zero-padded before the qkv linear,
  so padded tokens carry qkv = bias and attend, as in the partition path);
- ``MEDSAM2_FUSED_MLP=1``: every other block's ``x + mlp(norm2(x))`` tail is
  :func:`~medsam2_tpu_torch.ops.fused_mlp.ln_mlp_residual` where the JAX
  package's ``ln_mlp_residual`` takes its kernel: a row count that tiles by
  128 and C within ``MEDSAM2_FUSED_MLP_MAXC`` when that is set
  (:func:`~medsam2_tpu_torch.ops.fused_mlp.fused_mlp_applies`).

On the card a switched-on kernel launches; on the CPU the same call runs its
plain twin.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from medsam2_tpu_torch.configs import HieraConfig
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.ops import fused_block, fused_mlp
from medsam2_tpu_torch.ops.attention import attention
from medsam2_tpu_torch.ops.window_attention import window_attention


def _use_fused_window(window_size: int, q_stride) -> bool:
    """``MEDSAM2_FUSED_WINDOW=1`` sends windowed blocks without q-pooling to
    the window-attention kernel (``hiera._use_fused_window``; its default
    list of window sizes is empty, so only "1" turns it on)."""
    return (os.environ.get("MEDSAM2_FUSED_WINDOW", "auto") == "1" and window_size > 0
            and q_stride is None)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, gen: torch.Generator):
        super().__init__()
        self.qkv = layers.Linear(dim, dim_out * 3, gen)
        self.proj = layers.Linear(dim_out, dim_out, gen)


class MultiScaleBlock(nn.Module):
    """``hieradet.py:136-168``; ``spec`` is one entry of
    ``HieraConfig.block_schedule()``."""

    def __init__(self, spec: dict, mlp_ratio: float, gen: torch.Generator):
        super().__init__()
        dim, dim_out = spec["dim"], spec["dim_out"]
        self.spec = spec
        self.norm1 = layers.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, gen)
        self.norm2 = layers.LayerNorm(dim_out, eps=1e-6)
        self.mlp = layers.MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, gen,
                              activation=layers.gelu)
        if dim != dim_out:
            self.proj = layers.Linear(dim, dim_out, gen)

    def _attention(self, x):
        """MultiScaleAttention (``hieradet.py:37-83``): fused qkv, optional q
        max-pooling, attention over the tokens of each batch row."""
        spec = self.spec
        B, H, W, _ = x.shape
        heads, dim_out = spec["num_heads"], spec["dim_out"]
        qkv = self.attn.qkv(x.reshape(B, H * W, -1))
        qkv = qkv.reshape(B, H * W, 3, heads, dim_out // heads)
        q, k, v = qkv.unbind(2)                               # [B, N, h, d]
        if spec["q_stride"] is not None:
            q = layers.max_pool2d(q.reshape(B, H, W, dim_out), spec["q_stride"],
                                  spec["q_stride"])
            H, W = q.shape[1], q.shape[2]
            q = q.reshape(B, H * W, heads, dim_out // heads)
        out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        out = out.transpose(1, 2).reshape(B, H, W, dim_out)
        return self.attn.proj(out)

    def fused_params(self) -> fused_block.BlockParams:
        fc1, fc2 = self.mlp.layers
        return fused_block.BlockParams(
            self.norm1.weight, self.norm1.bias, self.attn.qkv.weight, self.attn.qkv.bias,
            self.attn.proj.weight, self.attn.proj.bias, self.norm2.weight, self.norm2.bias,
            fc1.weight, fc1.bias, fc2.weight, fc2.bias)

    def _mlp_tail(self, x):
        """``x + mlp(norm2(x))``, through the fused kernel when switched on."""
        if fused_mlp.fused_mlp_applies(x.numel() // x.shape[-1], x.shape[-1]):
            fc1, fc2 = self.mlp.layers
            return fused_mlp.ln_mlp_residual(x, self.norm2.weight, self.norm2.bias, fc1.weight,
                                             fc1.bias, fc2.weight, fc2.bias, self.norm2.eps)
        return x + self.mlp(self.norm2(x))

    def forward(self, x):
        spec = self.spec
        window_size, q_stride = spec["window_size"], spec["q_stride"]
        H, W = x.shape[1], x.shape[2]
        divides = window_size > 0 and H % window_size == 0 and W % window_size == 0
        if divides and fused_block.fused_block_enabled():
            wins, _ = layers.window_partition(x, window_size)
            if fused_block.fused_window_block_supported(spec, tuple(wins.shape)):
                out = fused_block.fused_window_block(wins, self.fused_params(), spec["num_heads"],
                                                     self.norm1.eps)
                return layers.window_unpartition(out, window_size, (H, W), (H, W))

        shortcut = x
        x = self.norm1(x)
        if spec["dim"] != spec["dim_out"]:
            shortcut = self.proj(x)
            if q_stride is not None:
                shortcut = layers.max_pool2d(shortcut, q_stride, q_stride)

        if window_size > 0 and not divides and _use_fused_window(window_size, q_stride):
            ph, pw = (-H) % window_size, (-W) % window_size
            qkv = self.attn.qkv(F.pad(x, (0, 0, 0, pw, 0, ph)))
            out = window_attention(qkv, spec["num_heads"], window_size)[:, :H, :W]
            return self._mlp_tail(shortcut + self.attn.proj(out))

        pad_hw = (H, W)
        if window_size > 0:
            x, pad_hw = layers.window_partition(x, window_size)
        x = self._attention(x)

        out_ws = window_size
        H, W = shortcut.shape[1], shortcut.shape[2]
        if q_stride is not None:
            # unpartition at the pooled geometry (hieradet.py:152-159)
            out_ws = window_size // q_stride[0]
            pad_h = (out_ws - H % out_ws) % out_ws if out_ws > 0 else 0
            pad_w = (out_ws - W % out_ws) % out_ws if out_ws > 0 else 0
            pad_hw = (H + pad_h, W + pad_w)
        if window_size > 0:
            x = layers.window_unpartition(x, out_ws, pad_hw, (H, W))

        return self._mlp_tail(shortcut + x)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HieraConfig, gen: torch.Generator):
        super().__init__()
        self.proj = layers.Conv2d(3, cfg.embed_dim, cfg.patch_kernel[0], gen,
                                  stride=cfg.patch_stride[0],
                                  padding=cfg.patch_padding[0])


class Hiera(nn.Module):
    def __init__(self, cfg: HieraConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, gen)
        bh, bw = cfg.window_pos_embed_bkg_spatial_size
        ws = cfg.window_spec[0]
        # reference layouts: [1, C, h, w]
        self.pos_embed = layers.trunc_normal((1, cfg.embed_dim, bh, bw), gen)
        self.pos_embed_window = layers.trunc_normal((1, cfg.embed_dim, ws, ws), gen)
        self.blocks = nn.ModuleList(
            MultiScaleBlock(spec, cfg.mlp_ratio, gen) for spec in cfg.block_schedule())

    def get_pos_embed(self, h: int, w: int):
        """Bicubic-interpolated background embed + tiled window embed
        (``hieradet.py:269-277``). Returns [h, w, C] fp32."""
        bkg = layers.bicubic_resize(self.pos_embed.permute(0, 2, 3, 1), h, w)[0]
        win = self.pos_embed_window[0].permute(1, 2, 0)
        return bkg + win.repeat(h // win.shape[0], w // win.shape[1], 1)

    def forward(self, x, pos_embed: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """x [B, H, W, 3] -> per-stage NHWC maps. ``pos_embed``: a precomputed
        :meth:`get_pos_embed`, hoisted out of per-frame loops."""
        x = self.patch_embed.proj(x)
        if pos_embed is None:
            pos_embed = self.get_pos_embed(x.shape[1], x.shape[2])
        x = x + pos_embed.to(x.dtype)
        outputs = []
        stage_ends = set(self.cfg.stage_ends)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in stage_ends:
                outputs.append(x)
        return outputs
