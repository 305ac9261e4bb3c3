"""The building blocks that the fused LN-MLP (B7) and the fused window block
(B8) launch in sequence, on their own: the LayerNorm rows and the encoder
linear with its three epilogues (``csrc/encoder_gemm.cu``).

No Pallas kernel of the JAX package corresponds to either alone: they are
parts of ``medsam2_tpu/ops/fused_mlp.py:_kernel`` and
``medsam2_tpu/ops/fused_block.py:_kernel``, rounded where those round. The
wrappers here serve the tests and the per-launch split of B8
(``scripts/profile_port_block_split.py``); the model reaches the kernels
only through :mod:`~medsam2_tpu_torch.ops.fused_mlp` and
:mod:`~medsam2_tpu_torch.ops.fused_block`.

:func:`tile_n` restates the bf16 linear's column-tile rule
(``medsam2_linear_tile_n``) for the CPU tests.

CUDA tensors launch the kernels; CPU tensors run the plain versions. No
fallback: a CUDA tensor reaches the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.ops.attention import (_aligned, _check_device, _dtype_code,
                                             _forward_only, _ptr, _raise_on_error, _stream)

# what the linear writes (encoder_gemm.cuh's Epilogue), with T the working
# dtype and acc the fp32 product
EPI_BIAS = 0        # T(T(acc) + b)
EPI_BIAS_GELU = 1   # T(gelu(T(T(acc) + b)))
EPI_RESIDUAL = 2    # T(T(x + T(acc)) + b)

# the bf16 linear's tiles: 128 rows, a column width from the multiples of 16
# up to 192 (a consumer warpgroup holds the tile's 128 x BN fp32 sums)
TILE_M = 128
TILE_N_CHOICES = tuple(range(16, 193, 16))


def tile_n(M: int, N: int, K: int, sms: int) -> int:
    """The bf16 linear's column-tile width BN for an [M, K] x [K, N] product
    on ``sms`` SMs, as ``csrc/encoder_gemm.cu``'s ``tile_n`` picks it. The
    candidates are the multiples of 16 up to 192 that divide N, or all of
    them where none does. A persistent CTA takes up to ceil(tiles / sms)
    tiles (rounds), each costing about max(BN, 64) + 32 column units: the
    products grow with BN, but below 64 columns reading the A chunk from
    shared memory for every product costs as much as the product, and a
    tile also pays a fixed part (barriers, the epilogue's stores) worth
    about 32 columns. The rule takes the least rounds x (max(BN, 64) + 32),
    and the wider tile on a tie."""
    del K  # every tile walks the same K
    divisors = [bn for bn in TILE_N_CHOICES if N % bn == 0]
    best, best_cost = 0, None
    for bn in divisors or TILE_N_CHOICES:
        tiles = -(-M // TILE_M) * -(-N // bn)
        cost = -(-tiles // sms) * (max(bn, 64) + 32)
        if best_cost is None or cost <= best_cost:
            best, best_cost = bn, cost
    return best


def layer_norm_plain(x, g, b, eps: float = 1e-6):
    """The kernel's LN rows: fp32 statistics, the scale and bias cast to x's
    dtype, the result rounded to it."""
    dt = x.dtype
    return layers.layer_norm(x, g.to(dt).float(), b.to(dt).float(), eps)


def linear_plain(a, w, bias, resid=None, epi: int = EPI_BIAS):
    """The linear's math in plain PyTorch, rounded as the kernel's epilogue:
    the fp32 product rounded to a's dtype, then the bias (and GELU, or the
    residual first) in that dtype."""
    dt = a.dtype
    t = torch.matmul(a.float(), w.to(dt).float().t()).to(dt)
    if epi == EPI_RESIDUAL:
        return (resid + t) + bias.to(dt)
    h = t + bias.to(dt)
    return layers.gelu(h) if epi == EPI_BIAS_GELU else h


def layer_norm(x, g, b, eps: float = 1e-6):
    """LN rows of x [M, C] with the kernel's roundings."""
    _forward_only("encoder_layer_norm", x, g, b)
    if not _check_device(x, "encoder_layer_norm"):
        return layer_norm_plain(x, g, b, eps)
    M, C = x.shape
    if C % 8:
        raise ValueError(f"encoder_layer_norm: kernel built for C a multiple of 8, got {C}")
    code = _dtype_code(x, "encoder_layer_norm")
    x = _aligned(x)
    g, b = (_aligned(t.detach().to(device=x.device, dtype=x.dtype)) for t in (g, b))
    out = torch.empty_like(x)
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_encoder_layer_norm(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), M, C, ctypes.c_float(eps),
        code, _stream(x))
    _raise_on_error(rc, "encoder_layer_norm")
    layer_norm.launches += 1
    return out


def linear(a, w, bias, resid=None, epi: int = EPI_BIAS):
    """``epilogue(a @ w.T)`` for a [M, K], a torch Linear weight w [N, K],
    bias [N] and, for ``EPI_RESIDUAL``, resid [M, N]."""
    _forward_only("encoder_linear", a, w, bias, *(() if resid is None else (resid,)))
    if (epi == EPI_RESIDUAL) != (resid is not None) or epi not in (0, 1, 2):
        raise ValueError(f"encoder_linear: epilogue {epi} with resid "
                         f"{'given' if resid is not None else 'missing'}")
    if not _check_device(a, "encoder_linear"):
        return linear_plain(a, w, bias, resid, epi)
    M, K = a.shape
    N = w.shape[0]
    if N % 8 or K % 8 or w.shape != (N, K) or (resid is not None and resid.shape != (M, N)):
        raise ValueError(f"encoder_linear: kernel built for N and K multiples of 8, got a "
                         f"{tuple(a.shape)}, w {tuple(w.shape)}")
    code = _dtype_code(a, "encoder_linear")
    a = _aligned(a)
    w, bias = (_aligned(t.detach().to(device=a.device, dtype=a.dtype)) for t in (w, bias))
    resid = None if resid is None else _aligned(resid)
    out = torch.empty(M, N, device=a.device, dtype=a.dtype)
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_encoder_linear(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(resid), out.data_ptr(), M, N, K, epi,
        code, _stream(a))
    _raise_on_error(rc, "encoder_linear")
    linear.launches += 1
    return out


layer_norm.launches = 0
linear.launches = 0
