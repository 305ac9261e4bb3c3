"""Fused LayerNorm -> MLP(fc1, GELU, fc2) -> residual (counterpart of
``medsam2_tpu/ops/fused_mlp.py``): the ``x + mlp(norm2(x))`` tail of a Hiera
block.

:func:`ln_mlp_residual` replaces the Pallas ``_kernel``. CUDA tensors launch
``csrc/fused_mlp.cu`` (``csrc/encoder_gemm.cu``'s kernels, bf16 on wgmma +
TMA): one kernel a call in bf16 at C in {96, 112, 144, 192, 224} with hidden
4C, else three (the LN rows, fc1 with GELU, fc2 with the residual;
:func:`kernel_launches`), at any row count and any C and hidden width that
are multiples of 8. ``ln_mlp_residual.launches`` counts calls. CPU tensors run
:func:`ln_mlp_residual_plain`. Both follow the Pallas
kernel's arithmetic, which differs from the unfused lowering in where it
rounds: LN statistics in fp32 with the scale and bias cast to the input
dtype, each matmul accumulated in fp32 and cast before its bias is added,
GELU tanh in bf16 / erf in fp32, and the output rounded as ``(x + y) + b2``
(``fused_mlp.py:58-75``; ``layers.linear_apply`` rounds ``x + (y + b2)``).

Off by default, as in the JAX package: ``MEDSAM2_FUSED_MLP=1`` turns the
Hiera blocks' MLP tails over to it where the JAX package's wrapper takes its
kernel (:func:`fused_mlp_applies`). Under autograd the call is
:class:`_LnMlpResidual`, the JAX ``custom_vjp`` (``fused_mlp.py:127-133``):
the forward is the kernel (the twin on the CPU), the backward re-runs the
twin on the saved inputs and returns its vector-Jacobian product. No
fallback: a CUDA tensor reaches the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.ops.attention import (_aligned, _check_device, _dtype_code, _ptr,
                                             _raise_on_error, _stream)


def fused_mlp_enabled() -> bool:
    return os.environ.get("MEDSAM2_FUSED_MLP", "0") == "1"


def _max_channels() -> int:
    """``MEDSAM2_FUSED_MLP_MAXC``: the JAX package's channel cap of the fused
    path (``fused_mlp._max_channels``); 0 = no cap."""
    return int(os.environ.get("MEDSAM2_FUSED_MLP_MAXC", "0"))


def _pick_block(n: int) -> int:
    """The JAX package's row block (``fused_mlp._pick_block``); 0 when no
    block of 1024, 512, 256 or 128 rows tiles ``n``."""
    for bn in (1024, 512, 256, 128):
        if n % bn == 0:
            return bn
    return 0


def fused_mlp_applies(rows: int, C: int) -> bool:
    """True where the JAX package's ``ln_mlp_residual`` takes its kernel
    (``fused_mlp.py:136-151``): the switch on, a row count that tiles by a
    row block, and C within ``MEDSAM2_FUSED_MLP_MAXC`` when that is set."""
    maxc = _max_channels()
    return fused_mlp_enabled() and _pick_block(rows) != 0 and (maxc == 0 or C <= maxc)


def _matmul_cast(x, w):
    """``x @ w.T`` accumulated in fp32 and cast to x's dtype, with the weight
    cast to x's dtype first (the kernel's products)."""
    return torch.matmul(x.float(), w.to(x.dtype).float().t()).to(x.dtype)


def ln_mlp_residual_plain(x2d, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    """The kernel's math in plain PyTorch. x2d [N, C]; torch Linear weights
    w1 [H, C], w2 [C, H]."""
    dt = x2d.dtype
    normed = layers.layer_norm(x2d, gamma.to(dt).float(), beta.to(dt).float(), eps)
    h = layers.gelu(_matmul_cast(normed, w1) + b1.to(dt))
    y = _matmul_cast(h, w2)
    return (x2d + y) + b2.to(dt)


@functools.lru_cache(maxsize=None)
def kernel_launches(C: int, H: int, dtype_code: int) -> int:
    """The kernel launches of one call at width C, hidden H and dtype code
    (0 float32, 1 bfloat16), as ``csrc/encoder_gemm.cu``'s ``mlp_launches``
    decides them: 1 or 3. Only a call of three needs the [N, C + H] buffer
    of LN and hidden rows."""
    from medsam2_tpu_torch.ops._build import load_library

    return load_library().medsam2_fused_mlp_launches(C, H, dtype_code)


def _launch(x2d, gamma, beta, w1, b1, w2, b2, eps: float):
    N, C = x2d.shape
    H = w1.shape[0]
    if C % 8 or H % 8:
        raise ValueError(f"fused_mlp: kernel built for C and hidden widths that are multiples "
                         f"of 8, got C={C}, hidden {H}")
    if w1.shape != (H, C) or w2.shape != (C, H):
        raise ValueError(f"fused_mlp: weights {tuple(w1.shape)} / {tuple(w2.shape)} do not fit "
                         f"C={C}, H={H}")
    code = _dtype_code(x2d, "fused_mlp")
    params = [_aligned(t.detach().to(device=x2d.device, dtype=x2d.dtype))
              for t in (gamma, beta, w1, b1, w2, b2)]
    x = _aligned(x2d)
    out = torch.empty_like(x)
    work = (torch.empty(N * (C + H), device=x.device, dtype=x.dtype)   # LN rows, hidden rows
            if kernel_launches(C, H, code) == 3 else None)
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_fused_mlp_fwd(
        x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), _ptr(work), N, C, H,
        ctypes.c_float(eps), code, _stream(x2d))
    _raise_on_error(rc, "fused_mlp")
    ln_mlp_residual.launches += 1
    return out


def twin_vjp(plain, inputs, needs, grad_out):
    """The vector-Jacobian product of ``plain(*inputs)`` with ``grad_out``,
    recomputed under autograd on detached copies of the saved inputs: a
    gradient for each input whose ``needs`` flag is set, else None (the
    backward of the JAX ``custom_vjp``s, ``jax.vjp`` of the unfused
    lowering)."""
    leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        y = plain(*leaves)
    wanted = [t for t, n in zip(leaves, needs) if n]
    got = iter(torch.autograd.grad(y, wanted, grad_out, allow_unused=True) if wanted else ())
    return [next(got) if n else None for n in needs]


class _LnMlpResidual(torch.autograd.Function):
    """B7 under autograd: forward the kernel (the twin on the CPU), backward
    the twin's vector-Jacobian product on the saved inputs."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x2d, gamma, beta, w1, b1, w2, b2)
        ctx.eps = eps
        if _check_device(x2d, "fused_mlp"):
            return _launch(x2d, gamma, beta, w1, b1, w2, b2, eps)
        return ln_mlp_residual_plain(x2d, gamma, beta, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        grads = twin_vjp(lambda *a: ln_mlp_residual_plain(*a, ctx.eps), ctx.saved_tensors,
                         ctx.needs_input_grad[:7], g)
        return (*grads, None)


def ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    """``(x + fc2(gelu(fc1(layer_norm(x))))) + b2`` for any leading shape
    [..., C]: the LayerNorm's scale and bias, then the two torch Linears'
    weights and biases (w1 [4C, C], w2 [C, 4C]). The call is
    :class:`_LnMlpResidual`, which keeps a graph only when a gradient will
    be taken."""
    C = x.shape[-1]
    y = _LnMlpResidual.apply(x.reshape(-1, C), gamma, beta, w1, b1, w2, b2, eps)
    return y.reshape(x.shape)


ln_mlp_residual.launches = 0
