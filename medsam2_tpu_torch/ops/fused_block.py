"""A whole plain windowed Hiera block (counterpart of
``medsam2_tpu/ops/fused_block.py``).

On window-contiguous rows x [N, C] (every n = ws^2 consecutive rows one
window, the contiguous reshape of ``window_partition``'s [Bn, ws, ws, C]):

    x1  = x + proj(window_attn(qkv(LN1(x))))
    out = x1 + mlp(LN2(x1))

:func:`fused_window_block` replaces the Pallas ``_kernel``. CUDA tensors
launch ``csrc/fused_block.cu``, a sequence of the port's kernels at every
preset width: LN1, the qkv linear, the window attention kernel, the proj
linear with its residual, and the fused MLP (one launch where
:func:`~medsam2_tpu_torch.ops.fused_mlp.kernel_launches` says so, else
three); ``fused_window_block.launches`` counts one a block (and
``launches_by_width`` by the block's C). CPU tensors
run :func:`fused_window_block_plain`. Both follow the Pallas kernel's
arithmetic (``fused_block.py:90-132``): LN scale and bias cast to the input
dtype, qkv rounded before its bias, fp32 softmax with the probabilities cast
before PV, each head's output cast, the projection summed over heads in
fp32, and the residuals rounded as ``(x + y) + b``. Its MLP half is
:mod:`medsam2_tpu_torch.ops.fused_mlp`'s.

Off by default, as in the JAX package: ``MEDSAM2_FUSED_BLOCK=1``
(:func:`fused_block_enabled`). Under autograd the call is
:class:`_FusedWindowBlock`, the JAX ``custom_vjp`` (``fused_block.py:184-199``):
the forward is the kernel sequence (the twin on the CPU), the backward
re-runs the twin on the saved inputs and returns its vector-Jacobian
product. No fallback: a CUDA tensor reaches the kernel or the wrapper
raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple

import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.ops.attention import (_aligned, _check_device, _dtype_code,
                                             _raise_on_error, _stream, sdpa_plain)
from medsam2_tpu_torch.ops.fused_mlp import (_matmul_cast, kernel_launches,
                                             ln_mlp_residual_plain, twin_vjp)
from medsam2_tpu_torch.ops.window_attention import WINDOW_BUILT


class BlockParams(NamedTuple):
    """One block's weights, torch layouts (Linear weight [out, in])."""
    norm1_weight: torch.Tensor
    norm1_bias: torch.Tensor
    qkv_weight: torch.Tensor     # [3C, C]
    qkv_bias: torch.Tensor
    proj_weight: torch.Tensor    # [C, C]
    proj_bias: torch.Tensor
    norm2_weight: torch.Tensor
    norm2_bias: torch.Tensor
    fc1_weight: torch.Tensor     # [4C, C]
    fc1_bias: torch.Tensor
    fc2_weight: torch.Tensor     # [C, 4C]
    fc2_bias: torch.Tensor


def fused_block_enabled() -> bool:
    return os.environ.get("MEDSAM2_FUSED_BLOCK", "0") == "1"


def _pick_rows(N: int, n: int) -> int:
    """The JAX package's row block: a multiple of the window that divides N
    (``fused_block._pick_rows``); 0 when there is none."""
    for r in (1024, 512, 256, 128, 64, 32, 16):
        if r % n == 0 and N % r == 0 and r * r * 4 <= 4 << 20:
            return r
    return 0


def fused_window_block_supported(spec: dict, wins_shape) -> bool:
    """True when the fused block covers this block, by the JAX package's
    rule: a plain windowed block (no q-pooling, no dim change) on square
    windows whose heads split C, with a row block that tiles the windows
    (``fused_block.fused_window_block_supported``). The port's blocks always
    carry the qkv / proj / MLP biases."""
    if spec["q_stride"] is not None or spec["dim"] != spec["dim_out"]:
        return False
    Bn, ws, ws2, C = wins_shape
    if ws != ws2 or C % spec["num_heads"]:
        return False
    return _pick_rows(Bn * ws * ws, ws * ws) != 0


def fused_window_block_plain(x2d, p: BlockParams, num_heads: int, n: int, eps: float = 1e-6):
    """The kernel's math in plain PyTorch on window-contiguous rows [N, C]."""
    N, C = x2d.shape
    dt = x2d.dtype
    d = C // num_heads
    normed = layers.layer_norm(x2d, p.norm1_weight.to(dt).float(),
                               p.norm1_bias.to(dt).float(), eps)
    qkv = _matmul_cast(normed, p.qkv_weight) + p.qkv_bias.to(dt)
    q, k, v = qkv.reshape(N // n, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    heads = sdpa_plain(q, k, v, scale=1.0 / math.sqrt(d))    # [W, heads, n, d]
    heads = heads.permute(0, 2, 1, 3).reshape(N, C)
    acc = torch.matmul(heads.float(), p.proj_weight.to(dt).float().t())
    x1 = (x2d + acc.to(dt)) + p.proj_bias.to(dt)
    return ln_mlp_residual_plain(x1, p.norm2_weight, p.norm2_bias, p.fc1_weight, p.fc1_bias,
                                 p.fc2_weight, p.fc2_bias, eps)


def _launch(x2d, p: BlockParams, num_heads: int, n: int, eps: float):
    N, C = x2d.shape
    ws = math.isqrt(n)
    if (N % n or C % num_heads or C % 8 or ws * ws != n
            or ws not in WINDOW_BUILT.get(C // num_heads, ())):
        raise ValueError(f"fused_block: kernel built for C a multiple of 8 and the window "
                         f"kernel's (head dim: window sizes) {WINDOW_BUILT}, got C={C}, "
                         f"{num_heads} heads, n={n}, N={N}")
    if p.fc1_weight.shape != (4 * C, C):
        raise ValueError(f"fused_block: MLP hidden width {p.fc1_weight.shape[0]} != 4C")
    code = _dtype_code(x2d, "fused_block")
    params = [_aligned(t.detach().to(device=x2d.device, dtype=x2d.dtype)) for t in p]
    x = _aligned(x2d)
    out = torch.empty_like(x)
    # the sequence's scratch: LN rows, qkv, head outputs, x1, and the hidden
    # rows where the MLP takes three launches
    width = 6 * C + (4 * C if kernel_launches(C, 4 * C, code) == 3 else 0)
    work = torch.empty(N * width, device=x.device, dtype=x.dtype)
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_fused_block_fwd(
        x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), work.data_ptr(), N, C,
        num_heads, n, ctypes.c_float(eps), code, _stream(x2d))
    _raise_on_error(rc, "fused_block")
    fused_window_block.launches += 1
    by_width = fused_window_block.launches_by_width
    by_width[C] = by_width.get(C, 0) + 1
    return out


class _FusedWindowBlock(torch.autograd.Function):
    """B8 under autograd: forward the kernel sequence (the twin on the CPU),
    backward the twin's vector-Jacobian product on the saved inputs."""

    @staticmethod
    def forward(ctx, x2d, num_heads, n, eps, *weights):
        ctx.save_for_backward(x2d, *weights)
        ctx.static = (num_heads, n, eps)
        p = BlockParams(*weights)
        if _check_device(x2d, "fused_block"):
            return _launch(x2d, p, num_heads, n, eps)
        return fused_window_block_plain(x2d, p, num_heads, n, eps)

    @staticmethod
    def backward(ctx, g):
        num_heads, n, eps = ctx.static
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[4:])
        gx, *gw = twin_vjp(
            lambda x, *w: fused_window_block_plain(x, BlockParams(*w), num_heads, n, eps),
            ctx.saved_tensors, needs, g)
        return (gx, None, None, None, *gw)


def fused_window_block(wins, p: BlockParams, num_heads: int, eps: float = 1e-6):
    """One plain windowed block on partitioned windows [Bn, ws, ws, C]
    (the caller checks :func:`fused_window_block_supported`). The call is
    :class:`_FusedWindowBlock`, which keeps a graph only when a gradient
    will be taken."""
    Bn, ws, _, C = wins.shape
    y = _FusedWindowBlock.apply(wins.reshape(-1, C), num_heads, ws * ws, eps, *p)
    return y.reshape(wins.shape)


fused_window_block.launches = 0
# the same launches by block width C
fused_window_block.launches_by_width = {}
