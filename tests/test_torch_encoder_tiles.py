"""The bf16 encoder linear's tiling, on the CPU.

``csrc/encoder_linear_sm90.cuh`` computes ``epilogue(a @ w.T)`` in 128 x BN
output tiles, BN chosen by ``tile_n`` (``csrc/encoder_gemm.cu``), walked by
a persistent grid of min(tiles, SMs) CTAs. Here:

- ``ops/encoder_linear.tile_n``, the rule's Python restatement (the ``cuda``
  tests hold the C function to it), at every linear of the fused window
  block (B8) and of the fused MLP's three-launch form (B7) in the four
  presets @512 and @1024: BN divides N, is a multiple of 16 up to 192, and
  never takes more rounds over 132 SMs than BN 128 would; and at widths no
  allowed BN divides;
- the persistent schedule, modelled as the kernel walks it, covers every
  tile once;
- the pieces that B7 and B8 launch (``layer_norm_plain``, ``linear_plain``
  with its three epilogues) compose to the blocks' twins exactly, so the
  linear's epilogue contract is the Pallas kernels' rounding order (the
  twins are held to the Pallas kernels in ``test_torch_encoder_kernels.py``).
"""

import math

import numpy as np
import pytest
import torch

from medsam2_tpu_torch import configs
from medsam2_tpu_torch.ops import encoder_linear as EL
from medsam2_tpu_torch.ops import fused_block as FB
from medsam2_tpu_torch.ops import fused_mlp as FM
from medsam2_tpu_torch.ops import window_attention as WA

SMS = 132
PRESETS = ("sam2_hiera_t", "sam2_hiera_s", "sam2_hiera_b_plus", "sam2_hiera_l")
# the widths whose bf16 fused MLP is one kernel (csrc/encoder_gemm.cu mlp_launches)
ONE_KERNEL_MLP = (96, 112, 144, 192, 224)


def _rounds(M, N, bn, sms=SMS):
    return -(-(-(-M // EL.TILE_M) * -(-N // bn)) // sms)


def _linears(preset: str, size: int):
    """(rows, C, name, N, K) of every linear the bf16 fused block and the
    three-launch fused MLP run in the preset at this image size."""
    cfg = getattr(configs, preset)(image_size=size)
    hw = cfg.image_size // cfg.trunk.patch_stride[0]
    out = set()
    for spec in cfg.trunk.block_schedule():
        if spec["q_stride"] is not None:
            hw //= spec["q_stride"][0]
        rows, C = hw * hw, spec["dim_out"]
        mlp = C not in ONE_KERNEL_MLP
        out.update({(rows, C, "qkv", 3 * C, C), (rows, C, "proj", C, C)})
        if mlp:
            out.update({(rows, C, "fc1", 4 * C, C), (rows, C, "fc2", C, 4 * C)})
    return sorted(out)


CASES = [(p, s) for p in PRESETS for s in (512, 1024)]


@pytest.mark.parametrize("preset,size", CASES, ids=lambda v: str(v))
def test_tile_n_divides_n_at_every_preset_linear(preset, size):
    for M, C, name, N, K in _linears(preset, size):
        bn = EL.tile_n(M, N, K, SMS)
        assert bn % 16 == 0 and 16 <= bn <= 192, (M, C, name, bn)
        assert N % bn == 0, (M, C, name, N, bn)


@pytest.mark.parametrize("preset,size", CASES, ids=lambda v: str(v))
def test_tile_n_takes_no_more_rounds_than_128(preset, size):
    for M, C, name, N, K in _linears(preset, size):
        bn = EL.tile_n(M, N, K, SMS)
        assert _rounds(M, N, bn) <= _rounds(M, N, 128), (M, C, name, bn)


def test_tile_n_at_hiera_l_stage_3():
    """hiera_l's C 576 blocks @1024 (4096 rows): qkv and proj at 144-wide
    tiles (384 and 128 tiles), fc1 at 192 (288 tiles), fc2 at 144."""
    got = {name: EL.tile_n(4096, N, K, SMS) for name, N, K in
           (("qkv", 1728, 576), ("proj", 576, 576), ("fc1", 2304, 576), ("fc2", 576, 2304))}
    assert got == {"qkv": 144, "proj": 144, "fc1": 192, "fc2": 144}


@pytest.mark.parametrize("N", [8, 40, 200, 1000, 2056])
def test_tile_n_where_no_allowed_width_divides(N):
    """No multiple of 16 divides N: the last column tile is ragged, and the
    rule still takes a multiple of 16 up to 192 and no more rounds than 128."""
    for M in (77, 1000, 65536):
        bn = EL.tile_n(M, N, 64, SMS)
        assert bn % 16 == 0 and 16 <= bn <= 192
        assert -(-N // bn) * bn >= N > (-(-N // bn) - 1) * bn
        assert _rounds(M, N, bn) <= _rounds(M, N, 128)


@pytest.mark.parametrize("sms", [132, 114, 7, 1])
def test_persistent_schedule_covers_every_tile_once(sms):
    """CTA b of min(tiles, sms) takes tiles b, b + grid, ...: each tile once,
    and the CTAs of one round share row blocks (column index fastest)."""
    for preset, size in CASES:
        for M, C, name, N, K in _linears(preset, size):
            bn = EL.tile_n(M, N, K, sms)
            n_tiles = -(-N // bn)
            tiles = -(-M // EL.TILE_M) * n_tiles
            grid = min(tiles, sms)
            seen = np.zeros(tiles, np.int64)
            for b in range(grid):
                seen[b::grid] += 1
            assert (seen == 1).all(), (preset, size, name)
            first_round = {t // n_tiles for t in range(grid)}
            assert len(first_round) == -(-grid // n_tiles)


def _rand(rng, shape, dtype, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,C", [(300, 96), (128, 288)])
def test_linear_pieces_compose_to_the_fused_mlp_twin(dtype, N, C):
    rng = np.random.default_rng(3)
    x = _rand(rng, (N, C), dtype)
    g, b = 1 + 0.1 * _rand(rng, (C,), torch.float32), 0.1 * _rand(rng, (C,), torch.float32)
    w1, b1 = _rand(rng, (4 * C, C), torch.float32, C ** -0.5), _rand(rng, (4 * C,), torch.float32)
    w2, b2 = _rand(rng, (C, 4 * C), torch.float32, (4 * C) ** -0.5), _rand(rng, (C,), torch.float32)
    n = EL.layer_norm(x, g, b)
    h = EL.linear(n, w1, b1, None, EL.EPI_BIAS_GELU)
    y = EL.linear(h, w2, b2, x, EL.EPI_RESIDUAL)
    assert torch.equal(y, FM.ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Bn,ws,C,heads", [(4, 4, 96, 1), (2, 4, 288, 4)])
def test_linear_pieces_compose_to_the_fused_block_twin(dtype, Bn, ws, C, heads):
    """LN1 -> qkv -> window attention -> proj + residual -> the MLP tail, as
    csrc/fused_block.cu launches them, equals the block's twin exactly."""
    rng = np.random.default_rng(4)
    x = _rand(rng, (Bn * ws * ws, C), dtype)
    p = FB.BlockParams(
        1 + 0.1 * _rand(rng, (C,), torch.float32), 0.1 * _rand(rng, (C,), torch.float32),
        _rand(rng, (3 * C, C), torch.float32, C ** -0.5), _rand(rng, (3 * C,), torch.float32),
        _rand(rng, (C, C), torch.float32, C ** -0.5), _rand(rng, (C,), torch.float32),
        1 + 0.1 * _rand(rng, (C,), torch.float32), 0.1 * _rand(rng, (C,), torch.float32),
        _rand(rng, (4 * C, C), torch.float32, C ** -0.5), _rand(rng, (4 * C,), torch.float32),
        _rand(rng, (C, 4 * C), torch.float32, (4 * C) ** -0.5), _rand(rng, (C,), torch.float32))
    qkv = EL.linear(EL.layer_norm(x, p.norm1_weight, p.norm1_bias), p.qkv_weight, p.qkv_bias)
    att = WA.window_attention_plain(qkv.reshape(Bn, ws, ws, 3 * C), heads, ws)
    x1 = EL.linear(att.reshape(-1, C), p.proj_weight, p.proj_bias, x, EL.EPI_RESIDUAL)
    y = FM.ln_mlp_residual_plain(x1, p.norm2_weight, p.norm2_bias, p.fc1_weight, p.fc1_bias,
                                 p.fc2_weight, p.fc2_bias)
    assert torch.equal(y, FB.fused_window_block_plain(x, p, heads, ws * ws))


def test_linear_wrapper_checks_its_epilogue():
    a, w, b = torch.zeros(4, 8), torch.zeros(8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="epilogue"):
        EL.linear(a, w, b, None, EL.EPI_RESIDUAL)
    with pytest.raises(ValueError, match="epilogue"):
        EL.linear(a, w, b, a, EL.EPI_BIAS)
    assert math.isclose(float(EL.linear(a, w, b).abs().sum()), 0.0)
