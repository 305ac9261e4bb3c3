"""The port's Hiera encoder kernels at the widths of hiera_b+ (C 112 to 896,
head dim 56) and hiera_l (C 144 to 1152, head dim 72), on CPU: each plain
twin against the JAX package's Pallas kernel run in interpret mode, the
fused-MLP dispatch rule against the JAX package's, and a reduced-depth trunk
of each width (switches on: the twins) against the JAX ``hiera_apply``.
Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.configs import HieraConfig
from medsam2_tpu.core import hiera as JH
from medsam2_tpu.ops import fused_block as JB
from medsam2_tpu.ops import fused_mlp as JM
from medsam2_tpu.ops import window_attention as JW
from medsam2_tpu_torch.core.hiera import Hiera
from medsam2_tpu_torch.ops import attention as A
from medsam2_tpu_torch.ops import fused_block as TB
from medsam2_tpu_torch.ops import fused_mlp as TM
from medsam2_tpu_torch.ops import window_attention as TW
from tests.test_torch_encoder_kernels import (SWITCHES, _block_params, _count_twins, _mlp_params,
                                              _t, _trunk_state_dict)

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py: first CPU exp call


# ---------------------------------------------------------------------------
# The fused-MLP dispatch rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("maxc", [None, "0", "192", "1152"])
def test_fused_mlp_rule_follows_jax(monkeypatch, maxc):
    """``fused_mlp_applies`` against the JAX wrapper's own conditions
    (``ln_mlp_residual``: a row block from ``_pick_block``, C within
    ``MEDSAM2_FUSED_MLP_MAXC``) over the row counts and widths of every
    preset's stages and some that do not tile."""
    monkeypatch.setenv("MEDSAM2_FUSED_MLP", "1")
    if maxc is None:
        monkeypatch.delenv("MEDSAM2_FUSED_MLP_MAXC", raising=False)
    else:
        monkeypatch.setenv("MEDSAM2_FUSED_MLP_MAXC", maxc)
    cap = JM._max_channels()
    for rows in (4, 16, 64, 100, 128, 256, 1000, 1024, 1280, 4096, 16384, 65536):
        for C in (96, 112, 144, 192, 224, 288, 384, 448, 576, 768, 896, 1152):
            want = JM._pick_block(rows) != 0 and (cap == 0 or C <= cap)
            assert TM.fused_mlp_applies(rows, C) == want, (rows, C, maxc)
    monkeypatch.setenv("MEDSAM2_FUSED_MLP", "0")
    assert not TM.fused_mlp_applies(1024, 96)


# 128 px -> 32 x 32 tokens: the tails of blocks 0 (1024 rows, C 16), 1
# (q-pooled, 256 rows, C 32) and 2 (global, 256 rows) tile by 128; those of
# blocks 3-5 (64, 64, 16 rows) do not.
RULE_CFG = HieraConfig(embed_dim=16, stages=(1, 2, 2, 1), window_spec=(4, 2, 2, 2),
                       global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(3, 3))


@pytest.fixture(scope="module")
def rule_trunk():
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: JH.hiera_init(k, RULE_CFG))(jax.random.PRNGKey(2)))
    trunk = Hiera(RULE_CFG, torch.Generator().manual_seed(1))
    trunk.load_state_dict(_trunk_state_dict(params), strict=True)
    return params, trunk.requires_grad_(False)


@pytest.mark.parametrize("maxc,calls", [(None, 3), ("16", 1), ("8", 0)])
def test_hiera_fused_mlp_calls_follow_jax_rule(rule_trunk, monkeypatch, maxc, calls):
    """With only the MLP switch on, the twin runs on the tails whose rows
    tile by 128 (blocks 0-2) and whose C is within the cap; the output
    matches the JAX trunk (which never takes its kernel on CPU)."""
    jtrunk, trunk = rule_trunk
    x = np.random.default_rng(6).standard_normal((1, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: JH.hiera_apply(p, RULE_CFG, a))(jtrunk, jnp.asarray(x))
    counted = _count_twins(monkeypatch)
    for name in SWITCHES:
        monkeypatch.setenv(name, "1" if name == "MEDSAM2_FUSED_MLP" else "0")
    if maxc is None:
        monkeypatch.delenv("MEDSAM2_FUSED_MLP_MAXC", raising=False)
    else:
        monkeypatch.setenv("MEDSAM2_FUSED_MLP_MAXC", maxc)
    with torch.no_grad():
        got = trunk(_t(x))
    assert counted == {"fused_block": 0, "window_attention": 0, "fused_mlp": calls}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Twins against the Pallas kernels at the b+ / l widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws,heads,d,hw", [(14, 2, 56, 16), (7, 3, 56, 8), (8, 2, 72, 12),
                                           (16, 1, 72, 16)], ids=lambda v: str(v))
def test_window_attention_twin_matches_pallas_bl(ws, heads, d, hw):
    rng = np.random.default_rng(7)
    C = d * heads
    qkv = rng.standard_normal((1, hw, hw, 3 * C)).astype(np.float32)
    pad = (-hw) % ws
    qkv = np.pad(qkv, ((0, 0), (0, pad), (0, pad), (0, 0)))
    assert ws in TW.WINDOW_BUILT[d]
    want = JW.window_attention(jnp.asarray(qkv), heads, ws, interpret=True)
    got = TW.window_attention(_t(qkv), heads, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype,N,C,tol", [
    ("float32", 256, 112, 1e-5),
    ("float32", 128, 144, 1e-5),
    ("float32", 128, 1152, 2e-5),
    ("bfloat16", 256, 112, 2e-2),
    ("bfloat16", 128, 1152, 3e-2),
], ids=lambda v: str(v))
def test_fused_mlp_twin_matches_pallas_bl(dtype, N, C, tol):
    rng = np.random.default_rng(8)
    g, b, w1, b1, w2, b2 = _mlp_params(rng, C, 4 * C)
    x = rng.standard_normal((N, C)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = TM.ln_mlp_residual(_t(x).to(tdt), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    want = JM._pallas_fwd(jnp.asarray(x, getattr(jnp, dtype)), g, b, w1, b1, w2, b2, 1e-6,
                          interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,Bn,ws,C,heads,tol", [
    ("float32", 2, 8, 112, 2, 1e-4),     # hiera_b+ stage 1: d 56, n 64
    ("float32", 8, 4, 224, 4, 1e-4),     # hiera_b+ stage 2: n 16
    ("float32", 2, 8, 144, 2, 1e-4),     # hiera_l stage 1: d 72, n 64
    ("float32", 8, 4, 288, 4, 1e-4),     # hiera_l stage 2: n 16
    ("float32", 1, 16, 576, 8, 1e-4),    # hiera_l stage 3: n 256
    ("float32", 1, 8, 1152, 16, 1e-4),   # hiera_l stage 4: n 64
    ("bfloat16", 2, 8, 112, 2, 3e-2),
    ("bfloat16", 1, 16, 576, 8, 3e-2),
], ids=lambda v: str(v))
def test_fused_block_twin_matches_pallas_bl(dtype, Bn, ws, C, heads, tol):
    rng = np.random.default_rng(9)
    jp, tp = _block_params(rng, C)
    wins = rng.standard_normal((Bn, ws, ws, C)).astype(np.float32)
    spec = {"dim": C, "dim_out": C, "num_heads": heads, "window_size": ws, "q_stride": None}
    assert TB.fused_window_block_supported(spec, wins.shape)
    assert JB.fused_window_block_supported(jp, spec, wins.shape)
    assert ws in TW.WINDOW_BUILT[C // heads]     # the window kernel of the card's sequence
    want = JB._pallas_fwd(jnp.asarray(wins.reshape(-1, C), getattr(jnp, dtype)), jp, heads,
                          ws * ws, 1e-6, interpret=True).reshape(wins.shape)
    got = TB.fused_window_block(_t(wins).to(getattr(torch, dtype)), tp, heads)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Reduced-depth trunks at the b+ / l widths, switches on
# ---------------------------------------------------------------------------

# 256 px -> 64 x 64 tokens, every stage at its preset width and heads.
# hiera_b+: blocks 0 (ws 8 on 64) and 2 (ws 4 on 32) run the fused block at
# C 112 / 224; blocks 4 (ws 14 on 16) and 6 (ws 7 on 8) need padding: window
# attention at head dim 56. hiera_l: blocks 0, 2, 4 (ws 16 on 16) and 6 (ws 8
# on 8) run the fused block at C 144 / 288 / 576 / 1152. The MLP tails of the
# q-pooled blocks 1, 3, 5 (1024, 256, 64 rows) and b+'s blocks 4, 6 (256, 64
# rows) run the fused MLP where the rows tile by 128.
BL_CFGS = {
    "hiera_b+": (HieraConfig(embed_dim=112, num_heads=2, stages=(1, 2, 2, 2),
                             global_att_blocks=(), window_pos_embed_bkg_spatial_size=(3, 3)),
                 {"fused_block": 2, "window_attention": 2, "fused_mlp": 3}),
    "hiera_l": (HieraConfig(embed_dim=144, num_heads=2, stages=(1, 2, 2, 2),
                            window_spec=(8, 4, 16, 8), global_att_blocks=(),
                            window_pos_embed_bkg_spatial_size=(3, 3)),
                {"fused_block": 4, "window_attention": 0, "fused_mlp": 2}),
}


@pytest.mark.parametrize("name", list(BL_CFGS))
def test_hiera_bl_widths_switches_on_match_jax(name, monkeypatch):
    cfg, calls = BL_CFGS[name]
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: JH.hiera_init(k, cfg))(jax.random.PRNGKey(3)))
    trunk = Hiera(cfg, torch.Generator().manual_seed(1))
    trunk.load_state_dict(_trunk_state_dict(params), strict=True)
    trunk.requires_grad_(False)
    x = np.random.default_rng(10).standard_normal((1, 256, 256, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: JH.hiera_apply(p, cfg, a))(params, jnp.asarray(x))
    counted = _count_twins(monkeypatch)
    for s in SWITCHES:
        monkeypatch.setenv(s, "1")
    monkeypatch.delenv("MEDSAM2_FUSED_MLP_MAXC", raising=False)
    A.reset_launch_counts()
    with torch.no_grad():
        got = trunk(_t(x))
    assert counted == calls
    assert not any(A.launch_counts().values())       # CPU: twins, no launches
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=0)
