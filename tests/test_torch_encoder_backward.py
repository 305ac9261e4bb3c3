"""The backward of the fused MLP (B7) and the fused window block (B8) on the
CPU: the port's autograd functions, whose backward re-runs the plain twin
on the saved inputs, against the JAX package's ``custom_vjp``s
(``fused_mlp._ln_mlp_res``, ``fused_block._fused_block``: the Pallas
forward in interpret mode, ``jax.vjp`` of the unfused lowering backward),
and the Hiera trunk differentiated with the switches on against off. fp32;
gradients relative to their largest |value|, to 1e-4 (the twin and the
unfused lowering round at other points only in bf16)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.ops import fused_block as JB
from medsam2_tpu.ops import fused_mlp as JM
from medsam2_tpu_torch.ops import attention as A
from medsam2_tpu_torch.ops import fused_block as TB
from medsam2_tpu_torch.ops import fused_mlp as TM
from tests.test_torch_encoder_kernels import (SWITCHES, _block_params, _mlp_params, _t,
                                              encoders, reaches)  # noqa: F401  (fixture)

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py: first CPU exp call
TOL = 1e-4


def _interpret(module, fn):
    """Run ``fn`` with ``module._pallas_fwd`` (the custom_vjp's forward) in
    interpret mode."""
    orig = module._pallas_fwd
    try:
        module._pallas_fwd = functools.partial(orig, interpret=True)
        return fn()
    finally:
        module._pallas_fwd = orig


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got.detach().float().numpy() - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("N,C,H", [(256, 96, 384), (128, 64, 256)])
def test_fused_mlp_backward_matches_jax_custom_vjp(N, C, H):
    rng = np.random.default_rng(40 + C)
    g, b, w1, b1, w2, b2 = _mlp_params(rng, C, H)
    x = rng.standard_normal((N, C)).astype(np.float32)
    w = rng.standard_normal((N, C)).astype(np.float32)

    def loss(x_, norm_p, mlp_p):
        return jnp.sum(JM._ln_mlp_res(x_, norm_p, mlp_p, 1e-6) * jnp.asarray(w))

    jargs = (jnp.asarray(x), {"scale": jnp.asarray(g), "bias": jnp.asarray(b)},
             {"layers": [{"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
                         {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}]})
    gx, gn, gm = _interpret(JM, lambda: jax.grad(loss, argnums=(0, 1, 2))(*jargs))
    ts = [_t(a).requires_grad_() for a in (x, g, b, w1.T, b1, w2.T, b2)]
    calls = []
    orig = TM.ln_mlp_residual_plain
    try:
        TM.ln_mlp_residual_plain = lambda *a, **k: calls.append(1) or orig(*a, **k)
        y = TM.ln_mlp_residual(*ts)
        assert reaches(y, "_LnMlpResidualBackward")
        (y * _t(w)).sum().backward()
    finally:
        TM.ln_mlp_residual_plain = orig
    assert len(calls) == 2                  # the forward's twin, then the backward's
    assert TM.ln_mlp_residual.launches == 0
    (l1, l2) = gm["layers"]
    for got, want in ((ts[0].grad, gx), (ts[1].grad, gn["scale"]), (ts[2].grad, gn["bias"]),
                      (ts[3].grad.T, l1["w"]), (ts[4].grad, l1["b"]),
                      (ts[5].grad.T, l2["w"]), (ts[6].grad, l2["b"])):
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("Bn,ws,C,heads", [(4, 8, 96, 1), (12, 4, 64, 2)])
def test_fused_block_backward_matches_jax_custom_vjp(Bn, ws, C, heads):
    rng = np.random.default_rng(50 + C)
    jp, tp = _block_params(rng, C)
    n = ws * ws
    x = rng.standard_normal((Bn * n, C)).astype(np.float32)
    w = rng.standard_normal((Bn * n, C)).astype(np.float32)

    def loss(x_, bp):
        return jnp.sum(JB._fused_block(x_, bp, heads, n, 1e-6) * jnp.asarray(w))

    gx, gp = _interpret(JB, lambda: jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp))
    weights = [t.clone().requires_grad_() for t in tp]
    xt = _t(x).requires_grad_()
    y = TB.fused_window_block(xt.reshape(Bn, ws, ws, C), TB.BlockParams(*weights), heads)
    assert reaches(y, "_FusedWindowBlockBackward")
    (y.reshape(-1, C) * _t(w)).sum().backward()
    assert TB.fused_window_block.launches == 0
    assert _rel(xt.grad, gx) <= TOL
    want = [gp["norm1"]["scale"], gp["norm1"]["bias"], np.asarray(gp["attn"]["qkv"]["w"]).T,
            gp["attn"]["qkv"]["b"], np.asarray(gp["attn"]["proj"]["w"]).T,
            gp["attn"]["proj"]["b"], gp["norm2"]["scale"], gp["norm2"]["bias"],
            np.asarray(gp["mlp"]["layers"][0]["w"]).T, gp["mlp"]["layers"][0]["b"],
            np.asarray(gp["mlp"]["layers"][1]["w"]).T, gp["mlp"]["layers"][1]["b"]]
    for name, got, ref in zip(TB.BlockParams._fields, (t.grad for t in weights), want):
        assert _rel(got, ref) <= TOL, name


def test_fused_block_backward_only_where_needed():
    """Frozen weights get no gradient and the input's is still the twin's;
    under no_grad the call keeps no graph."""
    rng = np.random.default_rng(60)
    _, tp = _block_params(rng, 64)
    x = _t(rng.standard_normal((2, 4, 4, 64))).requires_grad_()
    y = TB.fused_window_block(x, tp, 2)
    y.sum().backward()
    assert all(t.grad is None for t in tp)
    x2 = x.detach().clone().requires_grad_()
    TB.fused_window_block_plain(x2.reshape(-1, 64), tp, 2, 16).sum().backward()
    assert torch.equal(x.grad, x2.grad)


@pytest.mark.parametrize("on", [("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_MLP"),
                                ("MEDSAM2_FUSED_MLP",)], ids=["block_mlp", "mlp"])
def test_hiera_backward_switches_on_matches_off(encoders, monkeypatch, on):  # noqa: F811
    """The trunk differentiated with B8 (block 0) or B7 (block 0's MLP tail)
    on against every switch off: the input's and every weight's gradient."""
    _, trunk = encoders
    x = np.random.default_rng(7).standard_normal((1, 64, 64, 3)).astype(np.float32)

    def grads():
        trunk.zero_grad(set_to_none=True)
        trunk.requires_grad_(True)
        xt = _t(x).requires_grad_()
        outs = trunk(xt)
        loss = sum((o * _t(r.standard_normal(tuple(o.shape)))).sum()
                   for o, r in zip(outs, [np.random.default_rng(8 + i) for i in range(4)]))
        loss.backward()
        got = {"input": xt.grad.clone(), **{n: p.grad.clone() for n, p in
                                             trunk.named_parameters() if p.grad is not None}}
        trunk.requires_grad_(False)
        return got

    for name in SWITCHES:
        monkeypatch.setenv(name, "0")
    off = grads()
    for name in on:
        monkeypatch.setenv(name, "1")
    A.reset_launch_counts()
    got = grads()
    assert not any(A.launch_counts().values())
    assert set(got) == set(off) and len(got) > 10
    for name in off:
        assert _rel(got[name], off[name].numpy()) <= TOL, name
