"""The port's attention twins against the JAX package's attention, on CPU.

The flash twin is held against ``medsam2_tpu.ops.attention.flash_attention``
with its Pallas kernel run in interpret mode; the kv-cached twin against
``kv_cached_attention(force="interpret")``. Inputs are made with numpy from a
seed. Tolerance 2e-5 (fp32; sums taken in another order)."""

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
# PyTorch's CPU exp (seen with torch 2.13 on an AVX-512 host under load) can
# compute one thread's half of the first multi-threaded call in a process to
# only ~1e-4 relative accuracy; one single-threaded call first makes later
# calls accurate to an ulp, which the 2e-5 tolerance below needs.
torch.exp(torch.zeros(1))
TOL = 2e-5


def _flash_interpret(q, k, v, mask, block_q, block_k):
    orig = pl.pallas_call
    with jax.disable_jit():
        try:
            pl.pallas_call = functools.partial(orig, interpret=True)
            return np.asarray(J.flash_attention(q, k, v, kv_mask=mask,
                                                block_q=block_q, block_k=block_k))
        finally:
            pl.pallas_call = orig


FLASH_CASES = [
    # (B, H, Nq, Nk, D, Dv, mask kind, block_q, block_k)
    (1, 2, 128, 300, 64, 64, "random", 64, 128),     # kv mask, ragged Nk
    (2, 1, 40, 70, 32, 16, "dead_row", 16, 128),     # batch 0 fully masked, Dv != D
    (1, 1, 100, 257, 64, 32, None, 64, 128),         # ragged both, Dv != D
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=["mask", "dead_row", "ragged"])
def test_flash_twin_matches_pallas_interpret(case):
    B, H, Nq, Nk, D, Dv, kind, bq, bk = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, Dv)).astype(np.float32)
    mask = None
    if kind is not None:
        mask = rng.random((B, Nk)) > 0.3
        if kind == "dead_row":
            mask[0] = False
    want = _flash_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if mask is None else jnp.asarray(mask), bq, bk)
    got = T.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            kv_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if kind == "dead_row":
        assert np.all(got[0] == 0)


def test_attention_dispatch_and_sdpa_match_jax_on_cpu():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 10, 32)).astype(np.float32)
    k = rng.standard_normal((2, 4, 20, 32)).astype(np.float32)
    v = rng.standard_normal((2, 4, 20, 16)).astype(np.float32)
    mask = rng.random((2, 20)) > 0.4
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = np.asarray(J.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jm))
        got = T.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          kv_mask=tm).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # a CPU tensor never reaches a kernel
    before = T.launch_counts()
    T.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert T.launch_counts() == before


KV_CASES = [
    # (B, F, L, P, C, Rr, Dv, Nq, Nptr, block, mask kind)
    (2, 4, 2, 16, 8, 5, 4, 16, 4, None, "stale"),        # stale slot + masked ptr block
    (1, 3, 1, 32, 8, 4, 4, 16, 3, 8, "stale"),           # several tiles per slot
    (1, 2, 1, 24, 8, 3, 4, 24, 2, 16, "partial"),        # ragged P (no 16 divisor)
    (2, 2, 1, 16, 8, 3, 4, 8, 40, None, "stale"),        # Nptr larger than a tile
    (2, 2, 1, 16, 8, 3, 4, 8, 4, None, "dead_batch"),    # every key masked in batch 1
]


@pytest.mark.parametrize("case", KV_CASES,
                         ids=["stale", "multitile", "ragged_p", "long_ptr", "dead_batch"])
def test_kv_cached_twin_matches_pallas_interpret(case):
    B, F, L, P, C, Rr, Dv, Nq, Nptr, block, kind = case
    rng = np.random.default_rng(2)
    f32 = np.float32
    arrs = dict(
        q=rng.standard_normal((B, Nq, C)).astype(f32),
        kcache=rng.standard_normal((B, F, L, P, C)).astype(f32),
        pos_rows=rng.standard_normal((Rr, L, P, C)).astype(f32),
        row_of_slot=rng.integers(0, Rr, F).astype(np.int32),
        ptr_k=rng.standard_normal((B, Nptr, C)).astype(f32),
        v_slots=rng.standard_normal((B, F, P, Dv)).astype(f32),
        ptr_v=rng.standard_normal((B, Nptr, Dv)).astype(f32),
    )
    mask = np.ones((B, F * P + Nptr), bool)
    if kind == "stale":
        mask[0, P:2 * P] = False
        mask[0, F * P + 1:] = False
        if B > 1:
            mask[1, F * P:] = False
    elif kind == "partial":
        mask[0, P + 5:P + 11] = False
    else:
        mask[1] = False
    arrs["kv_mask"] = mask
    kw = {} if block is None else dict(block_q=block, block_k=block)
    for layer in range(L):
        want = np.asarray(J.kv_cached_attention(
            *[jnp.asarray(arrs[n]) for n in ("q", "kcache", "pos_rows", "row_of_slot",
                                              "ptr_k", "v_slots", "ptr_v", "kv_mask")],
            layer, force="interpret", **kw))
        got = T.kv_cached_attention(
            *[torch.from_numpy(arrs[n]) for n in ("q", "kcache", "pos_rows", "row_of_slot",
                                                   "ptr_k", "v_slots", "ptr_v", "kv_mask")],
            layer).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
