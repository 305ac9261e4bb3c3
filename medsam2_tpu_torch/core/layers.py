"""Neural-net primitives (counterpart of ``medsam2_tpu/core/layers.py``).

Conventions, shared with the JAX package so the tests compare like with like:

- Activations are channels-last: images NHWC, tokens [B, N, C]. Convolutions
  permute to NCHW internally to call ``F.conv2d``.
- Parameters keep the reference (PyTorch SAM2) layouts and names: Linear
  ``weight [out, in]``, conv OIHW, LayerNorm ``weight``/``bias``. A module's
  ``state_dict`` is therefore a reference state dict.
- Parameters are float32; each use casts them to the activation dtype, while
  LayerNorm statistics and affine stay in float32 (``layers.linear_apply`` /
  ``layer_norm_apply``).
- Initialisation follows the JAX init distributions from a seeded
  ``torch.Generator``: fan-in uniform for linears and convs (``nn.Linear``'s
  default), trunc-normal(0.02) for position tables and learned tokens,
  standard normal for embeddings.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def fan_in_uniform(shape, fan_in: int, gen: torch.Generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    t = torch.empty(shape)
    t.uniform_(-bound, bound, generator=gen)
    return nn.Parameter(t)


def trunc_normal(shape, gen: torch.Generator, std: float = 0.02) -> nn.Parameter:
    """Truncated normal on [-2 std, 2 std] (``layers.trunc_normal``)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
    return nn.Parameter(t)


def normal(shape, gen: torch.Generator, std: float = 1.0) -> nn.Parameter:
    t = torch.empty(shape)
    t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` in x's dtype (``layers.linear_apply``)."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis; statistics and affine in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight + bias
    return y.to(x.dtype)


def gelu(x):
    """Exact erf GELU in fp32/fp64, the tanh approximation in bf16/fp16
    (``layers.gelu``)."""
    if x.dtype in (torch.float32, torch.float64):
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")


def conv2d(x, weight, bias=None, stride=(1, 1), padding=(0, 0), groups: int = 1):
    """NHWC convolution with an OIHW weight. A 1x1/stride-1 conv is the
    per-pixel matmul, as ``layers.conv2d_apply`` lowers it."""
    w = weight.to(x.dtype)
    if (w.shape[2] == 1 and w.shape[3] == 1 and tuple(stride) == (1, 1)
            and groups == 1 and tuple(padding) == (0, 0)):
        y = torch.matmul(x, w[:, :, 0, 0].t())
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, tuple(stride), tuple(padding),
                     1, groups).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def conv_transpose2d(x, weight, bias=None, stride=(2, 2)):
    """NHWC ``nn.ConvTranspose2d(kernel=stride, stride=stride)``; weight
    (in, out, kh, kw)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None,
                           tuple(stride)).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def interpolate(x, size: Tuple[int, int], method: str = "bilinear",
                antialias: bool = False):
    """Resize NHWC ``x`` (``layers.interpolate``): torch's ``nearest`` index
    rule, and bilinear/bicubic with ``align_corners=False``."""
    B, H, W, C = x.shape
    h, w = size
    if (H, W) == (h, w):
        return x
    if method == "nearest":
        # src = floor(dst * in / out) in fp32, as the JAX package computes it
        def src(n_out, n_in):
            i = torch.arange(n_out, dtype=torch.float32, device=x.device)
            return torch.floor(i * float(np.float32(n_in / n_out))).long().clamp(0, n_in - 1)

        return x[:, src(h, H)][:, :, src(w, W)]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode=method,
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1)


def bilinear_resize_ac(x, size: Tuple[int, int]):
    """Resize NHWC ``x`` as ``F.interpolate(mode="bilinear",
    align_corners=True)`` (``layers.bilinear_resize_ac``)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def bicubic_resize(x, out_h: int, out_w: int):
    """[B, H, W, C] bicubic resize, a = -0.75, ``align_corners=False`` (torch's
    kernel; ``layers.bicubic_resize``)."""
    if x.shape[1:3] == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def window_partition(x, window_size: int):
    """[B, H, W, C] -> ([B*nW, ws, ws, C], (Hp, Wp)); pads bottom/right."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    """Inverse of :func:`window_partition`."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def max_pool2d(x, kernel: Tuple[int, int], stride: Tuple[int, int]):
    """NHWC max pool, ceil_mode=False."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(kernel), tuple(stride))
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Modules (parameter names are the reference state-dict keys)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, gen: torch.Generator, bias: bool = True):
        super().__init__()
        self.weight = fan_in_uniform((out_dim, in_dim), in_dim, gen)
        self.bias = fan_in_uniform((out_dim,), in_dim, gen) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis. With eps=1e-6 on NHWC it is the
    reference's channels-first LayerNorm2d."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def LayerNorm2d(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6)


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class Conv2d(nn.Module):
    """NHWC conv with reference OIHW weight; ``padding`` is torch's symmetric
    int padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, gen: torch.Generator,
                 stride: int = 1, padding: int = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        fan_in = in_ch // groups * kernel * kernel
        self.weight = fan_in_uniform((out_ch, in_ch // groups, kernel, kernel), fan_in, gen)
        self.bias = fan_in_uniform((out_ch,), fan_in, gen) if bias else None
        self.stride = (stride, stride)
        self.padding = (padding, padding)
        self.groups = groups

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class ConvTranspose2d(nn.Module):
    """NHWC ``nn.ConvTranspose2d(in, out, kernel=stride, stride=stride)``."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, gen: torch.Generator):
        super().__init__()
        fan_in = out_ch * stride * stride
        self.weight = fan_in_uniform((in_ch, out_ch, stride, stride), fan_in, gen)
        self.bias = fan_in_uniform((out_ch,), fan_in, gen)
        self.stride = (stride, stride)

    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride)


class Embedding(nn.Module):
    """A learned [num, dim] table (``nn.Embedding``'s key), normal init."""

    def __init__(self, num: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.weight = normal((num, dim), gen)


class MLP(nn.Module):
    """SAM-style MLP: ``num_layers`` Linears, activation between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, gen: torch.Generator, activation=F.relu,
                 sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], gen) for i in range(num_layers))
        self.activation = activation
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = self.activation(x)
        if self.sigmoid_output:
            x = torch.sigmoid(x)
        return x
