"""Prompter backbones (counterpart of ``medsam2_tpu/prompter/backbone.py``;
the reference takes them from ``timm.create_model(features_only=True)``,
``dpa_p2pnet.py:22-24``): a ResNet with GroupNorm and PVT-v2 b0 / b2, each
returning 4 NHWC feature maps at strides 4 / 8 / 16 / 32.

Module and parameter names follow the JAX package's parameter tree
(``stem.conv``, ``stages.<s>.<b>.gn1``, ``stages.<s>.blocks.<i>.kv``, ...),
with ``w`` / ``scale`` as ``weight``, so that
:func:`medsam2_tpu_torch.checkpoint.convert.prompter_state_dict_from_jax`
is a renaming plus the layout change of each array. PVT-v2's
spatial-reduction attention goes through
:func:`medsam2_tpu_torch.ops.attention.attention`; at a 256-px crop its kv
length is at most 64, under the flash gate, so the plain path runs.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.ops.attention import attention

RESNET_SPECS = {
    "resnet18": ((2, 2, 2, 2), (64, 128, 256, 512), False),
    "resnet34": ((3, 4, 6, 3), (64, 128, 256, 512), False),
    "resnet50": ((3, 4, 6, 3), (256, 512, 1024, 2048), True),
}

# depths, embed_dims, num_heads, mlp_ratios, sr_ratios
PVT_SPECS = {
    "pvt_v2_b0": ((2, 2, 2, 2), (32, 64, 160, 256), (1, 2, 5, 8),
                  (8, 8, 4, 4), (8, 4, 2, 1)),
    "pvt_v2_b2": ((3, 4, 6, 3), (64, 128, 320, 512), (1, 2, 5, 8),
                  (8, 8, 4, 4), (8, 4, 2, 1)),
}


def group_norm(x, weight, bias, groups: int = 32, eps: float = 1e-5):
    """GroupNorm of NHWC ``x`` over min(groups, C) groups (fewer while they
    do not divide C), statistics and affine in fp32."""
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xf = x.float().reshape(B, H, W, g, C // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (y * weight + bias).to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, dim: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.groups = groups
        self.eps = eps

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


def _conv_gn(in_ch: int, out_ch: int, kernel: int, gen, stride: int = 1) -> nn.ModuleDict:
    return nn.ModuleDict({"conv": layers.Conv2d(in_ch, out_ch, kernel, gen, stride=stride,
                                                bias=False),
                          "gn": GroupNorm(out_ch)})


class ResBlock(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1) block, GroupNorm after
    each conv, a 1x1 conv + GN shortcut where the shape changes."""

    def __init__(self, in_ch: int, out_ch: int, bottleneck: bool, stride: int, gen):
        super().__init__()
        self.bottleneck = bottleneck
        self.stride = stride
        if bottleneck:
            mid = out_ch // 4
            self.conv1 = layers.Conv2d(in_ch, mid, 1, gen, bias=False)
            self.gn1 = GroupNorm(mid)
            self.conv2 = layers.Conv2d(mid, mid, 3, gen, stride=stride, padding=1, bias=False)
            self.gn2 = GroupNorm(mid)
            self.conv3 = layers.Conv2d(mid, out_ch, 1, gen, bias=False)
            self.gn3 = GroupNorm(out_ch)
        else:
            self.conv1 = layers.Conv2d(in_ch, out_ch, 3, gen, stride=stride, padding=1,
                                       bias=False)
            self.gn1 = GroupNorm(out_ch)
            self.conv2 = layers.Conv2d(out_ch, out_ch, 3, gen, padding=1, bias=False)
            self.gn2 = GroupNorm(out_ch)
        self.downsample = (_conv_gn(in_ch, out_ch, 1, gen, stride)
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        if self.bottleneck:
            y = self.gn3(self.conv3(F.relu(y)))
        identity = x
        if self.downsample is not None:
            identity = self.downsample["gn"](self.downsample["conv"](x))
        return F.relu(y + identity)


class ResNet(nn.Module):
    def __init__(self, name: str, gen: torch.Generator):
        super().__init__()
        depths, dims, bottleneck = RESNET_SPECS[name]
        self.stem = nn.ModuleDict({"conv": layers.Conv2d(3, 64, 7, gen, stride=2, padding=3,
                                                         bias=False),
                                   "gn": GroupNorm(64)})
        stages, in_ch = [], 64
        for s, (depth, out_ch) in enumerate(zip(depths, dims)):
            blocks = []
            for b in range(depth):
                blocks.append(ResBlock(in_ch, out_ch, bottleneck, 2 if (b == 0 and s > 0) else 1,
                                       gen))
                in_ch = out_ch
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(self.stem["gn"](self.stem["conv"](x)))
        # max-pool 3 / 2 over a -inf border (the stem's padding 1)
        y = F.pad(y, (0, 0, 1, 1, 1, 1), value=float("-inf"))
        y = layers.max_pool2d(y, (3, 3), (2, 2))
        outs = []
        for stage in self.stages:
            for block in stage:
                y = block(y)
            outs.append(y)
        return outs


class PVTBlock(nn.Module):
    """PVT-v2 block on an NHWC map: spatial-reduction attention and the
    depthwise-conv MixFFN (timm ``pvt_v2.py:83-185``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int, gen):
        super().__init__()
        hidden = dim * mlp_ratio
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.norm1 = layers.LayerNorm(dim, eps=1e-6)
        self.q = layers.Linear(dim, dim, gen)
        self.kv = layers.Linear(dim, 2 * dim, gen)
        self.proj = layers.Linear(dim, dim, gen)
        self.norm2 = layers.LayerNorm(dim, eps=1e-6)
        self.fc1 = layers.Linear(dim, hidden, gen)
        self.dwconv = layers.Conv2d(hidden, hidden, 3, gen, padding=1, groups=hidden)
        self.fc2 = layers.Linear(hidden, dim, gen)
        if sr_ratio > 1:
            # reduction conv k = s = sr, then a default-eps LN
            self.sr = layers.Conv2d(dim, dim, sr_ratio, gen, stride=sr_ratio)
            self.sr_norm = layers.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        B, H, W, C = x.shape
        n = self.norm1(x).reshape(B, H * W, C)
        q = self.q(n)
        kv_src = n
        if self.sr_ratio > 1:
            kv_src = self.sr_norm(self.sr(n.reshape(B, H, W, C)).reshape(B, -1, C))
        kv = self.kv(kv_src)
        k, v = kv[..., :C], kv[..., C:]
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(B, -1, self.num_heads, hd).transpose(1, 2)

        out = attention(heads(q), heads(k), heads(v))
        out = out.transpose(1, 2).reshape(B, H * W, C)
        x = x + self.proj(out).reshape(B, H, W, C)
        h = self.dwconv(self.fc1(self.norm2(x)))
        return x + self.fc2(layers.gelu(h))


class PVTStage(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch: int, stride: int, depth: int,
                 num_heads: int, mlp_ratio: int, sr_ratio: int, gen):
        super().__init__()
        # OverlapPatchEmbed (pvt_v2.py:187-206): conv, then a default-eps LN
        self.patch_embed = layers.Conv2d(in_ch, dim, patch, gen, stride=stride,
                                         padding=patch // 2)
        self.embed_norm = layers.LayerNorm(dim, eps=1e-5)
        self.blocks = nn.ModuleList(PVTBlock(dim, num_heads, mlp_ratio, sr_ratio, gen)
                                    for _ in range(depth))
        self.norm = layers.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        x = self.embed_norm(self.patch_embed(x))
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


class PVTv2(nn.Module):
    def __init__(self, name: str, gen: torch.Generator):
        super().__init__()
        depths, dims, heads, mlps, srs = PVT_SPECS[name]
        in_chs = (3,) + dims[:-1]
        self.stages = nn.ModuleList(
            PVTStage(in_chs[s], dims[s], 7 if s == 0 else 3, 4 if s == 0 else 2, depths[s],
                     heads[s], mlps[s], srs[s], gen) for s in range(len(depths)))

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs


def make_backbone(name: str, gen: torch.Generator) -> nn.Module:
    return PVTv2(name, gen) if name in PVT_SPECS else ResNet(name, gen)


def backbone_channels(name: str) -> Tuple[int, ...]:
    if name in PVT_SPECS:
        return PVT_SPECS[name][1]
    return RESNET_SPECS[name][1]
