"""The port's Hiera encoder kernels on CPU: each plain twin against the JAX
package's Pallas kernel run in interpret mode, at the JAX tests' own cases
and tolerances; and the Hiera trunk with the three switches on (CPU: the
twins) against the JAX ``hiera_apply`` and against itself with the switches
off. Inputs are made with numpy from a seed."""

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

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py: first CPU exp call


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def reaches(y, name: str) -> bool:
    """True when ``y``'s graph runs the backward node ``name`` (a reshape may
    sit after it)."""
    todo, seen = [y.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == name:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


# ---------------------------------------------------------------------------
# B5 / B6: window attention
# ---------------------------------------------------------------------------

# (ws, heads, extent): pack > 1 at ws 4 / 7 / 8, a padded extent at ws 7,
# one 196-token window at ws 14
WINDOW_CASES = [(4, 1, 8), (4, 2, 16), (7, 2, 12), (8, 1, 16), (14, 1, 14)]


@pytest.mark.parametrize("ws,heads,hw", WINDOW_CASES, ids=lambda v: str(v))
def test_window_attention_twin_matches_pallas(ws, heads, hw):
    rng = np.random.default_rng(0)
    C = 32 * heads
    qkv = rng.standard_normal((2, hw, hw, 3 * C)).astype(np.float32)
    pad = (-hw) % ws
    qkv = np.pad(qkv, ((0, 0), (0, pad), (0, pad), (0, 0)))   # as the Hiera block pads
    want = JW.window_attention(jnp.asarray(qkv), heads, ws, interpret=True)
    got = TW.window_attention(_t(qkv), heads, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    assert TW.window_attention.launches == 0      # CPU tensors take the twin


@pytest.mark.parametrize("ws,heads,hw", [(4, 2, 8), (7, 1, 14)], ids=lambda v: str(v))
def test_window_attention_v2_twin_matches_pallas(ws, heads, hw):
    rng = np.random.default_rng(1)
    C = 32 * heads
    qkv = rng.standard_normal((2, hw, hw, 3 * C)).astype(np.float32)
    want = JW.window_attention_v2(jnp.asarray(qkv), heads, ws, interpret=True)
    got = TW.window_attention_v2(_t(qkv), heads, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# B7: LN -> MLP -> residual
# ---------------------------------------------------------------------------


def _mlp_params(rng, C, H):
    g, b = rng.standard_normal(C), rng.standard_normal(C)
    w1, b1 = rng.standard_normal((C, H)) * 0.05, rng.standard_normal(H) * 0.05
    w2, b2 = rng.standard_normal((H, C)) * 0.05, rng.standard_normal(C) * 0.05
    return [np.asarray(a, np.float32) for a in (g, b, w1, b1, w2, b2)]


@pytest.mark.parametrize("dtype,N,C,H,tol", [
    ("float32", 512, 96, 384, 1e-5),
    ("float32", 1280, 192, 768, 1e-5),
    ("bfloat16", 1024, 96, 384, 2e-2),
    ("float32", 100, 96, 384, 1e-5),       # a row count the Pallas grid cannot tile
])
def test_fused_mlp_twin_matches_pallas(dtype, N, C, H, tol):
    rng = np.random.default_rng(0)
    g, b, w1, b1, w2, b2 = _mlp_params(rng, C, H)
    x = rng.standard_normal((N, C)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = TM.ln_mlp_residual(_t(x).to(tdt), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    assert got.dtype == tdt and got.shape == (N, C)
    if N % 128:
        # the Pallas wrapper has no row block for N; its reference lowering
        # differs from the kernel only in the rounding of (x + y) + b2
        want = JM._reference(jnp.asarray(x), {"scale": g, "bias": b},
                             {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}, 1e-6)
    else:
        want = JM._pallas_fwd(jnp.asarray(x, getattr(jnp, dtype)), g, b, w1, b1, w2, b2, 1e-6,
                              interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# B8: the whole windowed block
# ---------------------------------------------------------------------------


def _block_params(rng, C, mlp_ratio=4.0):
    def lin(i, o):
        return (rng.standard_normal((i, o)) * i ** -0.5, rng.standard_normal(o) * 0.02)

    H = int(C * mlp_ratio)
    (wq, bq), (wp, bp), (w1, b1), (w2, b2) = lin(C, 3 * C), lin(C, C), lin(C, H), lin(H, C)
    g1, be1 = 1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C)
    g2, be2 = 1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C)
    jp = {"norm1": {"scale": g1, "bias": be1}, "attn": {"qkv": {"w": wq, "b": bq},
                                                        "proj": {"w": wp, "b": bp}},
          "norm2": {"scale": g2, "bias": be2},
          "mlp": {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}}
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp)
    tp = TB.BlockParams(*(_t(a) for a in (g1, be1, wq.T, bq, wp.T, bp, g2, be2, w1.T, b1,
                                           w2.T, b2)))
    return jp, tp


@pytest.mark.parametrize("dtype,Bn,ws,C,heads,tol", [
    ("float32", 16, 8, 96, 1, 1e-4),
    ("float32", 48, 4, 192, 2, 1e-4),
    ("bfloat16", 16, 8, 96, 1, 3e-2),
])
def test_fused_block_twin_matches_pallas(dtype, Bn, ws, C, heads, tol):
    rng = np.random.default_rng(0)
    jp, tp = _block_params(rng, C)
    wins = rng.standard_normal((Bn, ws, ws, C)).astype(np.float32)
    spec = {"dim": C, "dim_out": C, "num_heads": heads, "window_size": ws, "q_stride": None}
    assert TB.fused_window_block_supported(spec, wins.shape)
    assert JB.fused_window_block_supported(jp, spec, wins.shape)
    want = JB._pallas_fwd(jnp.asarray(wins.reshape(-1, C), getattr(jnp, dtype)), jp, heads,
                          ws * ws, 1e-6, interpret=True).reshape(wins.shape)
    got = TB.fused_window_block(_t(wins).to(getattr(torch, dtype)), tp, heads)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_fused_block_supported_follows_jax():
    rng = np.random.default_rng(1)
    jp, _ = _block_params(rng, 96)
    cases = [({"dim": 96, "dim_out": 192, "num_heads": 1, "window_size": 8,
               "q_stride": (2, 2)}, (16, 8, 8, 96)),
             ({"dim": 384, "dim_out": 384, "num_heads": 4, "window_size": 14,
               "q_stride": None}, (4, 14, 14, 384)),
             ({"dim": 96, "dim_out": 96, "num_heads": 1, "window_size": 8,
               "q_stride": None}, (3, 8, 8, 96))]
    for spec, shape in cases:
        assert TB.fused_window_block_supported(spec, shape) == \
            JB.fused_window_block_supported(jp, spec, shape)


def test_kernels_raise_under_autograd():
    """B5 raises when a gradient would be taken: the JAX package gives its
    ``window_attention`` no vjp, and ``jax.grad`` through it fails. B7 and
    B8 take their autograd functions, whose backward re-runs the twin (the
    JAX ``custom_vjp``s; ``tests/test_torch_encoder_backward.py`` holds them
    to JAX)."""
    rng = np.random.default_rng(2)
    _, tp = _block_params(rng, 96)
    x = _t(rng.standard_normal((1, 8, 8, 96))).requires_grad_()
    assert reaches(TM.ln_mlp_residual(x, *tp[6:]), "_LnMlpResidualBackward")
    assert reaches(TB.fused_window_block(x, tp, 1), "_FusedWindowBlockBackward")
    with pytest.raises(RuntimeError, match="forward only"):
        TW.window_attention(_t(rng.standard_normal((1, 8, 8, 288))).requires_grad_(), 3, 4)
    with torch.no_grad():
        assert torch.isfinite(TB.fused_window_block(x, tp, 1)).all()
        assert TB.fused_window_block(x, tp, 1).grad_fn is None


# ---------------------------------------------------------------------------
# Hiera with the switches on
# ---------------------------------------------------------------------------

# 64 px -> 16 x 16 tokens. Block 0 (ws 4) divides its extent: fused block;
# block 4 (ws 3 on 4 x 4) needs padding: window attention; blocks 1-5 (q-pooled,
# global, padded) end in the MLP tail, which the JAX rule keeps unfused here:
# none of their row counts (64, 64, 16, 16, 4) tiles by 128.
ENC_CFG = HieraConfig(embed_dim=16, stages=(1, 2, 2, 1), window_spec=(4, 2, 3, 2),
                      global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(3, 3))
SWITCHES = ("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_WINDOW", "MEDSAM2_FUSED_MLP")


def _trunk_state_dict(trunk):
    """The port's Hiera state dict from the JAX trunk parameters (the trunk
    part of ``checkpoint.convert.state_dict_from_jax``)."""
    sd = {"patch_embed.proj.weight": trunk["patch_embed"]["proj"]["w"].transpose(3, 2, 0, 1),
          "patch_embed.proj.bias": trunk["patch_embed"]["proj"]["b"],
          "pos_embed": trunk["pos_embed"].transpose(2, 0, 1)[None],
          "pos_embed_window": trunk["pos_embed_window"].transpose(2, 0, 1)[None]}
    for i, bp in enumerate(trunk["blocks"]):
        lin = {"attn.qkv": bp["attn"]["qkv"], "attn.proj": bp["attn"]["proj"],
               "mlp.layers.0": bp["mlp"]["layers"][0], "mlp.layers.1": bp["mlp"]["layers"][1]}
        if "proj" in bp:
            lin["proj"] = bp["proj"]
        for name, p in lin.items():
            sd[f"blocks.{i}.{name}.weight"], sd[f"blocks.{i}.{name}.bias"] = p["w"].T, p["b"]
        for name in ("norm1", "norm2"):
            sd[f"blocks.{i}.{name}.weight"] = bp[name]["scale"]
            sd[f"blocks.{i}.{name}.bias"] = bp[name]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def encoders():
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: JH.hiera_init(k, ENC_CFG))(jax.random.PRNGKey(0)))
    trunk = Hiera(ENC_CFG, torch.Generator().manual_seed(1))
    trunk.load_state_dict(_trunk_state_dict(params), strict=True)
    return params, trunk.requires_grad_(False)


def _count_twins(monkeypatch):
    """Wrap the three twins to count their calls (launch_counts() counts
    launches only)."""
    calls = {"fused_block": 0, "window_attention": 0, "fused_mlp": 0}
    for mod, name, key in ((TB, "fused_window_block_plain", "fused_block"),
                           (TW, "window_attention_plain", "window_attention"),
                           (TM, "ln_mlp_residual_plain", "fused_mlp")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_hiera_switches_on_match_jax_and_switches_off(encoders, monkeypatch):
    jtrunk, trunk = encoders
    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: JH.hiera_apply(p, ENC_CFG, a))(jtrunk, jnp.asarray(x))
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    with torch.no_grad():
        off = trunk(_t(x))
    calls = _count_twins(monkeypatch)
    for name in SWITCHES:
        monkeypatch.setenv(name, "1")
    A.reset_launch_counts()
    with torch.no_grad():
        on = trunk(_t(x))
    assert calls == {"fused_block": 1, "window_attention": 1, "fused_mlp": 0}
    assert not any(A.launch_counts().values())       # CPU: twins, no launches
    assert len(on) == len(off) == len(want) == 4
    for g, f, w in zip(on, off, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
        np.testing.assert_allclose(g.numpy(), f.numpy(), atol=1e-4, rtol=0)


def test_hiera_switches_dispatch_separately(encoders, monkeypatch):
    """Each switch alone reaches only its own kernel's twin (the fused
    block's MLP half is its own, not a fused-MLP call). The MLP switch alone
    takes block 0's 256 rows, the only row count here that tiles by 128."""
    _, trunk = encoders
    x = _t(np.random.default_rng(5).standard_normal((1, 64, 64, 3)))
    want = {"MEDSAM2_FUSED_BLOCK": {"fused_block": 1, "window_attention": 0, "fused_mlp": 0},
            "MEDSAM2_FUSED_WINDOW": {"fused_block": 0, "window_attention": 1, "fused_mlp": 0},
            "MEDSAM2_FUSED_MLP": {"fused_block": 0, "window_attention": 0, "fused_mlp": 1}}
    for switch, counts in want.items():
        with monkeypatch.context() as m:
            calls = _count_twins(m)
            for name in SWITCHES:
                m.setenv(name, "1" if name == switch else "0")
            with torch.no_grad():
                trunk(x)
            assert calls == counts, (switch, calls)
