"""Split-kv attention on the CPU: the flash twin run over kv ranges, then
``attention_merge_plain``, against the JAX package's attention over all keys.

The bf16 kernels on the card split the kv range over blocks and merge the
partial outputs with ``attention_merge``; these tests hold the arithmetic of
that split to ``medsam2_tpu.ops.attention.sdpa_xla`` and
``kv_cached_attention_xla`` (out at 1e-5, fp32) and to the unsplit twin
(LSE at 1e-5). A batch with every key masked gives 0 and LSE -1e30, as the
unsplit kernel does (``sdpa_xla`` averages such a row uniformly, so those
rows are held to the twin instead). Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.ops import attention as J
from medsam2_tpu_torch.ops import attention as T

torch.set_num_threads(2)
# see tests/test_torch_attention.py: one single-threaded exp first keeps the
# later multi-threaded ones accurate to an ulp
torch.exp(torch.zeros(1))
TOL = 1e-5
NEG_INF = -1e30


def _split_and_merge(q, k, v, mask, bounds):
    """The flash twin over each kv range [bounds[i], bounds[i + 1]), then the
    merge of the partial outputs."""
    outs, lses = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        m = None if mask is None else mask[:, a:b]
        o, lse = T.flash_attention_lse_plain(q, k[:, :, a:b], v[:, :, a:b], m)
        outs.append(o.float())
        lses.append(lse)
    return T.attention_merge(torch.stack(outs), torch.stack(lses), torch.float32)


MERGE_CASES = [
    # (B, H, Nq, Nk, D, Dv, range bounds inside (0, Nk), mask kind)
    (1, 2, 33, 100, 32, 16, (40,), None),                       # 2 ranges
    (2, 1, 20, 150, 16, 16, (30, 64, 128), "dead_range"),       # range [30, 64) all masked
    (2, 2, 17, 77, 32, 8, (10, 20, 50, 64), "dead_batch"),      # 5 ranges, batch 0 all masked
    (1, 1, 9, 130, 16, 32, (64, 128), "random"),                # ragged last range of 2 keys
]


@pytest.mark.parametrize("case", MERGE_CASES, ids=["two", "dead_range", "dead_batch", "ragged"])
def test_split_flash_merge_matches_jax(case):
    B, H, Nq, Nk, D, Dv, cuts, kind = case
    rng = np.random.default_rng(len(cuts))
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, Dv)).astype(np.float32)
    mask = None
    if kind is not None:
        mask = rng.random((B, Nk)) > 0.3
        if kind == "dead_range":
            mask[:, cuts[0]:cuts[1]] = False
        elif kind == "dead_batch":
            mask[0] = False
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    bounds = (0, *cuts, Nk)
    out, lse = _split_and_merge(tq, tk, tv, tm, bounds)
    want_out, want_lse = T.flash_attention_lse_plain(tq, tk, tv, tm)
    jax_out = np.asarray(J.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    kv_mask=None if mask is None else jnp.asarray(mask)))
    live = np.ones(B, bool) if mask is None else mask.any(axis=1)
    np.testing.assert_allclose(out.numpy()[live], jax_out[live], atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=TOL, rtol=0)
    if not live.all():
        assert np.all(out.numpy()[~live] == 0) and np.all(lse.numpy()[~live] == NEG_INF)


def test_merge_of_empty_splits_only():
    """Every split empty: out 0, LSE -1e30; one live split among empty ones
    passes through unchanged."""
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.standard_normal((3, 2, 5, 8)).astype(np.float32))
    lse = torch.full((3, 2, 5), NEG_INF)
    out, got = T.attention_merge(torch.zeros_like(o), lse, torch.float32)
    assert torch.all(out == 0) and torch.all(got == NEG_INF)
    lse[1] = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    out, got = T.attention_merge(o * (lse > NEG_INF)[..., None], lse, torch.float32)
    np.testing.assert_allclose(out.numpy(), o[1].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), lse[1].numpy(), atol=1e-6, rtol=0)


def _kv_tile_bounds(F, P, Nptr, tile):
    """Key ranges of the kv-cached kernel's tiles in storage order: each
    slot's P keys in tiles of ``tile`` (the last ragged), then the pointer
    keys."""
    spans = [(f * P + p, f * P + min(P, p + tile)) for f in range(F) for p in range(0, P, tile)]
    return spans + [(F * P + p, F * P + min(Nptr, p + tile)) for p in range(0, Nptr, tile)]


@pytest.mark.parametrize("splits", [2, 3, 7])
def test_kv_cached_split_merge_matches_jax(splits):
    """A small bank (F 3, P 50, Nptr 5, slot 1 stale) split over the kernel's
    tiles (16 keys here) into contiguous tile ranges, as the bf16 kernel
    splits its 64-key tiles."""
    B, Nq, F, L, P, C, Dv, Nptr, Rr, layer = 2, 12, 3, 2, 50, 32, 16, 5, 4, 1
    rng = np.random.default_rng(splits)
    q = rng.standard_normal((B, Nq, C)).astype(np.float32)
    kc = rng.standard_normal((B, F, L, P, C)).astype(np.float32)
    pos = rng.standard_normal((Rr, L, P, C)).astype(np.float32)
    rows = np.array([2, 0, 3], np.int32)
    pk = rng.standard_normal((B, Nptr, C)).astype(np.float32)
    vs = rng.standard_normal((B, F, P, Dv)).astype(np.float32)
    pv = rng.standard_normal((B, Nptr, Dv)).astype(np.float32)
    mask = np.ones((B, F * P + Nptr), bool)
    mask[:, P:2 * P] = False                 # a stale ring slot
    mask[1, F * P + 3:] = False              # pointer padding
    scale = C ** -0.5
    want = np.asarray(J.kv_cached_attention_xla(
        *(jnp.asarray(a) for a in (q, kc, pos, rows, pk, vs, pv, mask)), layer, scale))
    # the keys and values in storage order, as the kernel reads them
    t = {n: torch.from_numpy(a) for n, a in dict(q=q, kc=kc, pos=pos, pk=pk, vs=vs, pv=pv).items()}
    k_all = torch.cat([(t["kc"][:, :, layer] + t["pos"][torch.from_numpy(rows).long(), layer][None])
                       .reshape(B, F * P, C), t["pk"]], dim=1)[:, None]
    v_all = torch.cat([t["vs"].reshape(B, F * P, Dv), t["pv"]], dim=1)[:, None]
    tiles = _kv_tile_bounds(F, P, Nptr, 16)
    per = -(-len(tiles) // splits)
    bounds = [tiles[i][0] for i in range(0, len(tiles), per)] + [F * P + Nptr]
    out, _ = _split_and_merge(t["q"][:, None], k_all, v_all, torch.from_numpy(mask), bounds)
    np.testing.assert_allclose(out[:, 0].numpy(), want, atol=TOL, rtol=0)
    whole = T.kv_cached_attention(t["q"], t["kc"], t["pos"], torch.from_numpy(rows), t["pk"],
                                  t["vs"], t["pv"], torch.from_numpy(mask), layer, scale)
    np.testing.assert_allclose(out[:, 0].numpy(), whole.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("blocks,n_tiles,want", [
    (128, 64, 1),     # Hiera global attention [1,4,4096,*] @1024: the grid fills the card
    (32, 64, 4),      # memory self-attention [1,1,4096,256]: 4 splits, 128 blocks
    (32, 321, 4),     # kv-cached @1024, B = 1: 8 slots of 64 tiles + the pointer tile
    (16, 162, 8),     # training cross-attention [2,1,1024,10316]
    (1, 5, 5),        # one q tile, five kv tiles: one tile a split
    (1, 1, 1),
    (256, 64, 1),     # hiera_l [1,8,4096,72]
])
def test_split_count_fills_one_wave(blocks, n_tiles, want):
    assert T.split_count(blocks, n_tiles, 132) == want
