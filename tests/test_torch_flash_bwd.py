"""The flash backward's plain twins against the JAX package, on CPU.

The JAX side is ``medsam2_tpu.ops.attention.flash_attention`` differentiated
through its ``custom_vjp`` with ``MEDSAM2_FLASH_BWD=pallas`` and
``pallas_call`` in interpret mode, so the two Pallas backward kernels
(``_bwd_dkv_kernel``, ``_bwd_dq_kernel``) run, as ``tests/test_layers.py``
runs them. The port side is ``flash_attention`` on CPU tensors that require
grad: its autograd function runs :func:`flash_attention_lse_plain` forward and
:func:`flash_attention_bwd_plain` backward. Inputs are made with numpy from a
seed; a kv mask, a ragged Nk, Dv != D and the Hiera global blocks' head
dims 96 and 72 (the JAX wrapper pads them to 128 for its kernels) are
covered. Gradients are held
relative to their largest |value|: fp32 to 5e-5, bf16 to 4e-2 (the JAX
package's own tolerances). The LSE of the training forward is compared with
the Pallas forward's ``with_lse`` output."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from medsam2_tpu.ops import attention as J
from medsam2_tpu_torch.ops import attention as T

torch.set_num_threads(2)
# see tests/test_torch_attention.py: one single-threaded exp first keeps
# torch's CPU exp accurate to an ulp in this process
torch.exp(torch.zeros(1))

CASES = [
    # (B, H, Nq, Nk, D, Dv, mask kind, block_q, block_k)
    (1, 2, 128, 256, 64, 64, "random", 64, 128),      # kv mask
    (2, 1, 64, 200, 64, 32, "dead_row", 64, 128),     # ragged Nk, Dv != D, batch 0 masked
    (1, 1, 96, 300, 32, 16, None, 32, 128),           # ragged both, Dv != D
    # the Hiera global-attention head dims 2D training differentiates
    (1, 2, 128, 200, 96, 96, "random", 64, 128),      # hiera_t / s (C 384, 4 heads)
    (2, 1, 64, 150, 72, 72, "dead_row", 64, 128),     # hiera_l (C 576, 8 heads), batch 0 masked
]
IDS = ["mask", "ragged_dead_row", "ragged_dv", "hiera_d96", "hiera_l_d72"]
TOL = {np.float32: 5e-5, jnp.bfloat16: 4e-2}


def _inputs(case, seed=0):
    B, H, Nq, Nk, D, Dv, kind, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, Dv)).astype(np.float32)
    w = rng.standard_normal((B, H, Nq, Dv)).astype(np.float32)
    mask = None
    if kind is not None:
        mask = rng.random((B, Nk)) > 0.3
        if kind == "dead_row":
            mask[0] = False
    return q, k, v, w, mask


def _interpret(fn):
    orig = pl.pallas_call
    with jax.disable_jit():
        try:
            pl.pallas_call = functools.partial(orig, interpret=True)
            return fn()
        finally:
            pl.pallas_call = orig


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_twin_matches_pallas_backward(monkeypatch, case, dtype):
    monkeypatch.setenv("MEDSAM2_FLASH_BWD", "pallas")
    bq, bk = case[7], case[8]
    q, k, v, w, mask = _inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    jw = jnp.asarray(w)

    def loss(q, k, v):
        out = J.flash_attention(q, k, v, kv_mask=jmask, block_q=bq, block_k=bk)
        return jnp.sum(out.astype(jnp.float32) * jw)

    want = _interpret(lambda: jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv))

    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = T.flash_attention(tq, tk, tv, kv_mask=tmask)
    assert out.grad_fn is not None
    before = T.launch_counts()
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert T.launch_counts() == before           # CPU tensors never launch
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref, np.float32)
        scale = max(np.abs(ref).max(), 1e-3)
        err = np.abs(got.float().numpy() - ref).max() / scale
        assert err < TOL[dtype], f"d{name}: {err:.2e}"
    if case[6] == "dead_row":
        assert tq.grad[0].abs().max().item() == 0.0 and tk.grad[0].abs().max().item() == 0.0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_twin_matches_pallas_forward(case):
    B, H, Nq, Nk, D, Dv, kind, bq, bk = case
    q, k, v, _, mask = _inputs(case, seed=1)
    scale = 1.0 / np.sqrt(D)
    Dp, Dvp = max(-(-D // 128) * 128, 128), max(-(-Dv // 128) * 128, 128)

    def pad(a, axis, n):
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, n - a.shape[axis])
        return np.pad(a, widths)

    Nq_p, Nk_p = -(-Nq // bq) * bq, -(-Nk // bk) * bk
    qf = pad(pad(q, 3, Dp).reshape(B * H, Nq, Dp), 1, Nq_p)
    kf = pad(pad(k, 3, Dp).reshape(B * H, Nk, Dp), 1, Nk_p)
    vf = pad(pad(v, 3, Dvp).reshape(B * H, Nk, Dvp), 1, Nk_p)
    m = np.ones((B, Nk), np.float32) if mask is None else mask.astype(np.float32)
    maskf = pad(np.repeat(m[:, None], H, axis=1).reshape(B * H, 1, Nk), 2, Nk_p)
    out, lse = _interpret(lambda: J._flash_call(
        *(jnp.asarray(a) for a in (qf, kf, vf, maskf)), scale, bq, bk, with_lse=True))
    got_out, got_lse = T.flash_attention_lse_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask))
    want_lse = np.asarray(lse)[:, :Nq].reshape(B, H, Nq)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    want_out = np.asarray(out)[:, :Nq, :Dv].reshape(B, H, Nq, Dv)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=2e-5, rtol=0)


def test_cpu_grad_goes_through_the_autograd_function_and_kv_cached_raises():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 1, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 12, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 1, 12, 8)).astype(np.float32))
    before = T.launch_counts()
    assert T.flash_attention(q, k, v).grad_fn is None          # inference call
    out = T.flash_attention(q, k, v.requires_grad_())
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.sum().backward()
    assert v.grad is not None and T.launch_counts() == before
    with torch.no_grad():
        assert T.flash_attention(q, k, v).grad_fn is None

    B, F, L, P, C, Dv, Nptr = 1, 2, 1, 4, 8, 4, 2
    args = [torch.zeros(B, 3, C).requires_grad_(), torch.zeros(B, F, L, P, C),
            torch.zeros(F, L, P, C), torch.arange(F), torch.zeros(B, Nptr, C),
            torch.zeros(B, F, P, Dv), torch.zeros(B, Nptr, Dv),
            torch.ones(B, F * P + Nptr, dtype=torch.bool), 0]
    with pytest.raises(RuntimeError, match="inference only"):
        T.kv_cached_attention(*args)
    with torch.no_grad():
        assert T.kv_cached_attention(*args).shape == (B, 3, Dv)
