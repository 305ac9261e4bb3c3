"""Per-window attention straight from the fused qkv layout (counterpart of
``medsam2_tpu/ops/window_attention.py``).

qkv [B, Hp, Wp, 3C] (Hp, Wp multiples of the window size, channels split
[3, heads, d] as the Hiera qkv reshape) -> [B, Hp, Wp, C]: every ws x ws
window attends within itself, fp32 logits and softmax, probabilities cast to
the input dtype before the PV product, fp32 accumulation.

- :func:`window_attention` replaces the Pallas ``_window_attn_kernel``. CUDA
  tensors launch ``csrc/window_attention.cu`` at the (head dim, window size)
  pairs of :data:`WINDOW_BUILT`: bf16 runs the wgmma + TMA kernel of
  ``csrc/window_attention_sm90.cu``,
  one CTA per (window, head, query part) as :func:`window_query_parts`
  says, fp32 an FMA kernel; CPU tensors run :func:`window_attention_plain`.
- :func:`window_attention_v2` replaces ``_window_attn_kernel_3d``, the same
  function over the free reshape [B*Hp, Wp, 3C]; it launches the same
  kernel.

Forward only: both raise when a gradient would be taken. No fallback: a CUDA
tensor reaches the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from medsam2_tpu_torch.ops.attention import (_aligned, _check_device, _dtype_code,
                                             _forward_only, _raise_on_error, _stream,
                                             sdpa_plain)

# (head dim: window sizes) csrc/window_attention.cu is instantiated for:
# hiera_t / hiera_s (d 96, every ws up to 14), hiera_b+ (d 56) and hiera_l
# (d 72) at their window sizes, ws 16 for hiera_l's fused stage-3 block.
WINDOW_BUILT = {96: tuple(range(1, 15)), 56: (4, 7, 8, 14), 72: (4, 8, 16)}


def window_query_parts(window_size: int):
    """The bf16 kernel's grid rule (``csrc/window_attention_sm90.cu``
    ``WinCfg``): each (window, head) splits its n = ws^2 query rows into
    ceil(n / 128) parts of whole window rows, so that a CTA holds at most 128
    query rows, 64 per consumer warpgroup. Returns (parts, window rows per
    part, consumer warpgroups). At ws 14 the 100 (window, head) pairs of
    hiera_t @1024 give 200 CTAs of 98 rows, two an SM: one wave on 132 SMs."""
    n = window_size * window_size
    parts = -(-n // 128)
    rows = -(-window_size // parts)
    return parts, rows, -(-(rows * window_size) // 64)


def _check_shape(qkv, num_heads: int, window_size: int, name: str):
    B, Hp, Wp, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % num_heads:
        raise ValueError(f"{name}: {C3} channels do not split into 3 x {num_heads} heads")
    if Hp % window_size or Wp % window_size:
        raise ValueError(f"{name}: padded dims ({Hp}, {Wp}) not multiples of {window_size}")
    return B, Hp, Wp, C3 // 3


def window_attention_plain(qkv, num_heads: int, window_size: int):
    """The kernel's math in plain PyTorch: partition into windows, attention
    per window and head through :func:`sdpa_plain` (fp32 logits and softmax,
    probabilities in the input dtype, fp32 PV), unpartition."""
    B, Hp, Wp, C = _check_shape(qkv, num_heads, window_size, "window_attention")
    ws, d = window_size, C // num_heads
    nh, nw = Hp // ws, Wp // ws
    t = qkv.reshape(B, nh, ws, nw, ws, 3, num_heads, d).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = t.reshape(3, B * nh * nw, num_heads, ws * ws, d)
    out = sdpa_plain(q, k, v, scale=1.0 / math.sqrt(d))      # [Bw, heads, n, d]
    out = out.reshape(B, nh, nw, num_heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(B, Hp, Wp, C)


def _launch(qkv, num_heads: int, window_size: int):
    B, Hp, Wp, C = _check_shape(qkv, num_heads, window_size, "window_attention")
    d = C // num_heads
    if window_size not in WINDOW_BUILT.get(d, ()):
        raise ValueError(f"window_attention: kernel built for (head dim: window sizes) "
                         f"{WINDOW_BUILT}, got d={d}, ws={window_size}")
    code = _dtype_code(qkv, "window_attention")
    from medsam2_tpu_torch.ops._build import load_library

    src = _aligned(qkv)
    out = torch.empty(B, Hp, Wp, C, device=qkv.device, dtype=qkv.dtype)
    rc = load_library().medsam2_window_attention_fwd(
        src.data_ptr(), out.data_ptr(), B, Hp, Wp, C, num_heads, window_size,
        ctypes.c_float(1.0 / math.sqrt(d)), code, _stream(qkv))
    _raise_on_error(rc, "window_attention")
    window_attention.launches += 1
    return out


def window_attention(qkv, num_heads: int, window_size: int):
    """qkv [B, Hp, Wp, 3C] -> [B, Hp, Wp, C] of per-window attention."""
    _forward_only("window_attention", qkv)
    if not _check_device(qkv, "window_attention"):
        return window_attention_plain(qkv, num_heads, window_size)
    return _launch(qkv, num_heads, window_size)


def window_attention_v2(qkv, num_heads: int, window_size: int):
    """:func:`window_attention` over the free reshape [B*Hp, Wp, 3C] (the
    JAX package's rank-3 form): windows never straddle two images, so the
    result is the same."""
    B, Hp, Wp, C3 = qkv.shape
    out = window_attention(qkv.reshape(1, B * Hp, Wp, C3), num_heads, window_size)
    return out.reshape(B, Hp, Wp, C3 // 3)


window_attention.launches = 0
