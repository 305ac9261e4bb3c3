"""The tilings of the Hopper window-attention (B5) and split-kv dQ (B4)
kernels, modelled in plain PyTorch on the CPU, against the JAX package.

- B5: ``csrc/window_attention_sm90.cu`` computes each (window, head, query
  part) in one CTA, with the keys padded to a multiple of 16 (208 at ws 14,
  64 at ws 7) by zero rows whose logits are masked. The model below runs
  exactly that tiling (parts from ``window_query_parts``) and is held to
  ``window_attention_plain`` and the Pallas ``_window_attn_kernel`` in
  interpret mode.
- B4: ``csrc/flash_bwd_dq_sm90.cu`` splits the kv range into contiguous runs
  of 64-key tiles, writes one unscaled fp32 partial dQ per split, and
  ``flash_attention_bwd_dq_sum`` adds them in split order. The model runs
  the backward twin's arithmetic over each split's keys and the sum's twin,
  and is held to ``flash_attention_bwd_plain`` and to the Pallas backward
  (``_bwd_dq_kernel`` in interpret mode) at every split count from 1 to the
  number of tiles, with a ragged Nk, a batch whose keys are all masked and
  an empty split.
- The grid and split rules, as tables.

Inputs are made with numpy from a seed; fp32 unless a case says bf16."""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from medsam2_tpu.ops import attention as J
from medsam2_tpu.ops import window_attention as JW
from medsam2_tpu_torch.ops import attention as A
from medsam2_tpu_torch.ops import window_attention as TW

torch.set_num_threads(2)
torch.exp(torch.zeros(1))   # see tests/test_torch_attention.py: first CPU exp call


def _interpret(fn):
    orig = pl.pallas_call
    with jax.disable_jit():
        try:
            pl.pallas_call = functools.partial(orig, interpret=True)
            return fn()
        finally:
            pl.pallas_call = orig


# ---------------------------------------------------------------------------
# B5: (window, head, query part) CTAs, keys padded to 16 and masked
# ---------------------------------------------------------------------------


def _window_tiled(qkv, heads: int, ws: int):
    """The bf16 kernel's tiling: per (window, head) the keys and values
    padded with zero rows to a multiple of 16, per query part a tile of
    64 x (warpgroups) rows holding the part's whole window rows (the rest
    zero), logits of padded keys -1e30 before the row max, the normalised
    probabilities rounded to the input dtype before P V, fp32 sums."""
    B, Hp, Wp, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    n, nh, nw = ws * ws, Hp // ws, Wp // ws
    nk = -(-n // 16) * 16
    parts, rows_y, wgs = TW.window_query_parts(ws)
    t = qkv.reshape(B, nh, ws, nw, ws, 3, heads, d).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = t.reshape(3, B * nh * nw, heads, n, d)
    kp = torch.zeros(*k.shape[:2], nk, d, dtype=k.dtype)
    vp = torch.zeros_like(kp)
    kp[:, :, :n], vp[:, :, :n] = k, v
    out = torch.empty(*q.shape[:2], n, d, dtype=torch.float32)
    for part in range(parts):
        t0 = part * rows_y * ws
        t1 = min(n, t0 + rows_y * ws)
        qt = torch.zeros(*q.shape[:2], 64 * wgs, d, dtype=q.dtype)
        qt[:, :, :t1 - t0] = q[:, :, t0:t1]
        s = torch.matmul(qt.float(), kp.float().transpose(-1, -2))
        s[..., n:] = -1e30
        e = torch.exp((s - s.amax(-1, keepdim=True)) / math.sqrt(d))
        p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
        out[:, :, t0:t1] = torch.matmul(p.float(), vp.float())[:, :, :t1 - t0]
    out = out.reshape(B, nh, nw, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(B, Hp, Wp, C).to(qkv.dtype)


# (B, Hp, Wp, heads, ws): ws 14 (two query parts of 98 rows, 208 keys),
# ws 7 (one part of 49 rows, 64 keys), and a non-square grid of two images
WINDOW_CASES = [(1, 14, 28, 1, 14), (1, 14, 14, 2, 7), (2, 14, 21, 1, 7)]


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_window_tiling_matches_twin_and_pallas(case):
    B, Hp, Wp, heads, ws = case
    rng = np.random.default_rng(ws)
    qkv = rng.standard_normal((B, Hp, Wp, 3 * 96 * heads)).astype(np.float32)
    got = _window_tiled(torch.from_numpy(qkv), heads, ws)
    twin = TW.window_attention_plain(torch.from_numpy(qkv), heads, ws)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=0, atol=2e-6)
    want = JW.window_attention(jnp.asarray(qkv), heads, ws, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("ws", [14, 7])
def test_window_tiling_matches_twin_bf16(ws):
    """bf16: the padded keys and the part split change no rounding point, so
    the model agrees with the twin to a bf16 ulp of the output."""
    rng = np.random.default_rng(20 + ws)
    qkv = torch.from_numpy(rng.standard_normal((1, 2 * ws, 2 * ws, 3 * 96)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    got = _window_tiled(qkv, 1, ws).float()
    want = TW.window_attention_plain(qkv, 1, ws).float()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


@pytest.mark.parametrize("ws,want", [
    (14, (2, 7, 2)),     # hiera_t blocks 4/6/8 @1024: two parts of 98 rows
    (7, (1, 7, 1)),      # block 11: one 64-row warpgroup for 49 rows
    (8, (1, 8, 1)),
    (4, (1, 4, 1)),
    (11, (1, 11, 2)),    # 121 rows: one part, two warpgroups
    (12, (2, 6, 2)),
    (13, (2, 7, 2)),     # the second part's last window row lies past the window
    (1, (1, 1, 1)),
])
def test_window_query_parts(ws, want):
    parts, rows, wgs = TW.window_query_parts(ws)
    assert (parts, rows, wgs) == want
    assert rows * ws <= 64 * wgs <= 128 and parts * rows >= ws


def test_window_grid_fills_one_wave_at_ws14():
    """hiera_t @1024 ws 14: 25 windows x 4 heads x 2 parts = 200 CTAs, two an
    SM on 132 SMs."""
    parts, _, _ = TW.window_query_parts(14)
    assert 132 < 25 * 4 * parts <= 2 * 132


# ---------------------------------------------------------------------------
# B4: split-kv dQ partials, summed in split order
# ---------------------------------------------------------------------------

TILE = 64   # keys a tile (csrc/hopper_attention.cuh kBK)


def _dq_split(q, k, v, mask, do, lse, dvec, splits: int, scale: float):
    """The split dQ pass: contiguous runs of ceil(n_tiles / splits) tiles,
    one unscaled fp32 partial each (zero for an empty run), then the sum."""
    Nk = k.shape[2]
    n_tiles = -(-Nk // TILE)
    per = -(-n_tiles // splits)
    parts = []
    for s in range(splits):
        a, b = s * per * TILE, min(Nk, (s + 1) * per * TILE)
        if a >= b:
            parts.append(torch.zeros(q.shape, dtype=torch.float32))
            continue
        m = None if mask is None else mask[:, a:b]
        _, ds = A.bwd_scores_plain(q, k[:, :, a:b], v[:, :, a:b], m, lse, do, dvec, scale)
        parts.append(torch.matmul(ds, k[:, :, a:b].float()))
    return A.flash_attention_bwd_dq_sum(torch.stack(parts), scale)


# B 2, Nq 64, Nk 300 (five tiles, the last of 44 keys), D 64, Dv 32; batch 0
# has every key masked, batch 1 has tile 1 fully masked
B, H, NQ, NK, D, DV = 2, 1, 64, 300, 64, 32


@functools.lru_cache(maxsize=4)
def _bwd_case(d=D, dv=DV):
    rng = np.random.default_rng(30)
    q, k = (rng.standard_normal((B, H, n, d)).astype(np.float32) for n in (NQ, NK))
    v = rng.standard_normal((B, H, NK, dv)).astype(np.float32)
    w = rng.standard_normal((B, H, NQ, dv)).astype(np.float32)
    mask = rng.random((B, NK)) > 0.3
    mask[0] = False
    mask[1, TILE:2 * TILE] = False
    # the Pallas backward through the JAX custom_vjp (block_q 64, block_k 128)
    saved = os.environ.get("MEDSAM2_FLASH_BWD")
    os.environ["MEDSAM2_FLASH_BWD"] = "pallas"
    try:
        jmask = jnp.asarray(mask)

        def loss(q_):
            out = J.flash_attention(q_, jnp.asarray(k), jnp.asarray(v), kv_mask=jmask,
                                    block_q=64, block_k=128)
            return jnp.sum(out * jnp.asarray(w))

        want = np.asarray(_interpret(lambda: jax.grad(loss)(jnp.asarray(q))))
    finally:
        if saved is None:
            os.environ.pop("MEDSAM2_FLASH_BWD")
        else:
            os.environ["MEDSAM2_FLASH_BWD"] = saved
    return q, k, v, w, mask, want


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5])
def test_split_dq_matches_twin_and_pallas(splits):
    """Every split count from 1 to the five tiles; at 4 the last run is
    empty (tiles 0-1, 2-3, 4, none), at 5 split 1 holds only masked keys."""
    q, k, v, w, mask, want = _bwd_case()
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    tm = torch.from_numpy(mask)
    scale = D ** -0.5
    o, lse = A.flash_attention_lse_plain(tq, tk, tv, tm)
    dvec = (tw * o).sum(-1)
    before = A.launch_counts()
    got = _dq_split(tq, tk, tv, tm, tw, lse, dvec, splits, scale)
    assert A.launch_counts() == before            # CPU tensors never launch
    twin = A.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse, tw, scale)[0]
    top = twin.abs().max().item()
    assert (got - twin).abs().max().item() <= 1e-6 * top
    assert np.abs(got.numpy() - want).max() <= 5e-5 * np.abs(want).max()
    assert got[0].abs().max().item() == 0.0       # the batch with every key masked


@pytest.mark.parametrize("splits", [1, 3, 5])
@pytest.mark.parametrize("d", [96, 72], ids=["d96", "d72"])
def test_split_dq_at_hiera_head_dims(d, splits):
    """The split dQ pass at the Hiera global blocks' (D, Dv) = (96, 96) and
    (72, 72) (the kernel pads 72 to 80 columns, zero-filled): the same
    model, held to the twin and the Pallas backward."""
    q, k, v, w, mask, want = _bwd_case(d, d)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    tm = torch.from_numpy(mask)
    scale = d ** -0.5
    o, lse = A.flash_attention_lse_plain(tq, tk, tv, tm)
    dvec = (tw * o).sum(-1)
    got = _dq_split(tq, tk, tv, tm, tw, lse, dvec, splits, scale)
    twin = A.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse, tw, scale)[0]
    assert (got - twin).abs().max().item() <= 1e-6 * twin.abs().max().item()
    assert np.abs(got.numpy() - want).max() <= 5e-5 * np.abs(want).max()
    assert got[0].abs().max().item() == 0.0


def test_dq_sum_twin_adds_in_split_order():
    rng = np.random.default_rng(31)
    parts = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    got = A.flash_attention_bwd_dq_sum(parts, 0.5)
    np.testing.assert_array_equal(got.numpy(), ((parts[0] + parts[1]) + parts[2]).numpy() * 0.5)


@pytest.mark.parametrize("bh,nq,nk,dv,want", [
    (2, 1024, 10316, 64, (16, 8)),    # training cross-attention @512: 16 blocks x 8 splits
    (2, 1024, 1024, 256, (32, 4)),    # training self-attention @512: 64-row blocks
    (2, 4096, 4096, 256, (128, 1)),   # @1024 self-attention, two objects: the grid fills
    (2, 100, 77, 64, (2, 2)),         # one query block a head, two kv tiles
    (1, 64, 64, 64, (1, 1)),          # one kv tile
])
def test_dq_split_fills_one_wave(bh, nq, nk, dv, want):
    blocks = bh * -(-nq // A.dq_block_rows(dv))
    assert (blocks, A.split_count(blocks, -(-nk // TILE), 132)) == want


# ---------------------------------------------------------------------------
# B3: split-q dK / dV partials, summed in split order
# ---------------------------------------------------------------------------


def _dkv_split(q, k, v, mask, do, lse, dvec, splits: int, scale: float):
    """The split dK/dV pass (``csrc/flash_bwd_dkv_sm90.cu``): each 64-key
    block walks contiguous runs of ceil(n_q_tiles / splits) 64-row query
    tiles, one unscaled fp32 partial dK and dV each (zero for an empty run),
    then ``flash_attention_bwd_dkv_sum`` adds them in split order and scales
    dK."""
    Nq = q.shape[2]
    n_tiles = -(-Nq // A.DKV_Q_TILE)
    per = -(-n_tiles // splits)
    pk, pv = [], []
    for s in range(splits):
        a, b = s * per * A.DKV_Q_TILE, min(Nq, (s + 1) * per * A.DKV_Q_TILE)
        if a >= b:
            pk.append(torch.zeros(k.shape, dtype=torch.float32))
            pv.append(torch.zeros(v.shape, dtype=torch.float32))
            continue
        p, ds = A.bwd_scores_plain(q[:, :, a:b], k, v, mask, lse[:, :, a:b], do[:, :, a:b],
                                   dvec[:, :, a:b], scale)
        pv.append(torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do[:, :, a:b].float()))
        pk.append(torch.matmul(ds.transpose(-1, -2), q[:, :, a:b].float()))
    return A.flash_attention_bwd_dkv_sum(torch.stack(pk), torch.stack(pv), scale)


@functools.lru_cache(maxsize=4)
def _dkv_case(d=D, dv=DV):
    """B 2, Nq 300 (five q tiles, the last of 44 rows), Nk 100, D 64, Dv
    32 by default; batch 0 has every key masked, batch 1 a third of them.
    The Pallas backward's dK and dV through the JAX custom_vjp."""
    rng = np.random.default_rng(32)
    q = rng.standard_normal((B, H, 300, d)).astype(np.float32)
    k = rng.standard_normal((B, H, 100, d)).astype(np.float32)
    v = rng.standard_normal((B, H, 100, dv)).astype(np.float32)
    w = rng.standard_normal((B, H, 300, dv)).astype(np.float32)
    mask = rng.random((B, 100)) > 0.3
    mask[0] = False
    saved = os.environ.get("MEDSAM2_FLASH_BWD")
    os.environ["MEDSAM2_FLASH_BWD"] = "pallas"
    try:
        jmask = jnp.asarray(mask)

        def loss(k_, v_):
            out = J.flash_attention(jnp.asarray(q), k_, v_, kv_mask=jmask, block_q=64,
                                    block_k=128)
            return jnp.sum(out * jnp.asarray(w))

        want = _interpret(lambda: jax.grad(loss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v)))
        want = tuple(np.asarray(a) for a in want)
    finally:
        if saved is None:
            os.environ.pop("MEDSAM2_FLASH_BWD")
        else:
            os.environ["MEDSAM2_FLASH_BWD"] = saved
    return q, k, v, w, mask, want


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5])
def test_split_dkv_matches_twin_and_pallas(splits):
    """Every split count from 1 to the five q tiles; at 4 the last run is
    empty (tiles 0-1, 2-3, 4, none)."""
    q, k, v, w, mask, (want_k, want_v) = _dkv_case()
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    tm = torch.from_numpy(mask)
    scale = D ** -0.5
    o, lse = A.flash_attention_lse_plain(tq, tk, tv, tm)
    dvec = (tw * o).sum(-1)
    before = A.launch_counts()
    got_k, got_v = _dkv_split(tq, tk, tv, tm, tw, lse, dvec, splits, scale)
    assert A.launch_counts() == before            # CPU tensors never launch
    _, twin_k, twin_v = A.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse, tw, scale)
    for got, twin, want in ((got_k, twin_k, want_k), (got_v, twin_v, want_v)):
        assert (got - twin).abs().max().item() <= 1e-6 * twin.abs().max().item()
        assert np.abs(got.numpy() - want).max() <= 5e-5 * np.abs(want).max()
        assert got[0].abs().max().item() == 0.0   # the batch with every key masked


@pytest.mark.parametrize("splits", [1, 3, 5])
@pytest.mark.parametrize("d", [96, 72], ids=["d96", "d72"])
def test_split_dkv_at_hiera_head_dims(d, splits):
    """The split dK/dV pass at (96, 96) and (72, 72): the same model, held
    to the twin and the Pallas backward (each consumer warpgroup of the
    kernel owns one 64-wide and one narrow column chunk of dK and dV
    there)."""
    q, k, v, w, mask, (want_k, want_v) = _dkv_case(d, d)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    tm = torch.from_numpy(mask)
    scale = d ** -0.5
    o, lse = A.flash_attention_lse_plain(tq, tk, tv, tm)
    dvec = (tw * o).sum(-1)
    got_k, got_v = _dkv_split(tq, tk, tv, tm, tw, lse, dvec, splits, scale)
    _, twin_k, twin_v = A.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse, tw, scale)
    for got, twin, want in ((got_k, twin_k, want_k), (got_v, twin_v, want_v)):
        assert (got - twin).abs().max().item() <= 1e-6 * twin.abs().max().item()
        assert np.abs(got.numpy() - want).max() <= 5e-5 * np.abs(want).max()
        assert got[0].abs().max().item() == 0.0


@pytest.mark.parametrize("bh,nq,nk,want", [
    (16, 4096, 4096, (1024, 1)),    # hiera_s @1024 B 4, 4 heads: one block a 64-key tile
    (32, 4096, 4096, (2048, 1)),    # hiera_l @1024 B 4, 8 heads
    (4, 1024, 1024, (64, 2)),       # hiera_t @512 B 1: 16 key tiles x 4 heads, split in 2
])
def test_hiera_backward_grids(bh, nq, nk, want):
    """The dK/dV grid at the Hiera global blocks' shapes; the dQ pass takes
    128 query rows a block at Dv 96 and 72."""
    blocks = bh * -(-nk // A.DKV_BLOCK_KEYS)
    assert (blocks, A.split_count(blocks, -(-nq // A.DKV_Q_TILE), 132)) == want
    assert A.dq_block_rows(96) == A.dq_block_rows(72) == 128


def test_dkv_sum_twin_adds_in_split_order():
    rng = np.random.default_rng(33)
    pk = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(np.float32))
    dk, dv = A.flash_attention_bwd_dkv_sum(pk, pv, 0.5)
    np.testing.assert_array_equal(dk.numpy(), ((pk[0] + pk[1]) + pk[2]).numpy() * 0.5)
    np.testing.assert_array_equal(dv.numpy(), ((pv[0] + pv[1]) + pv[2]).numpy())


@pytest.mark.parametrize("bh,nq,nk,want", [
    (2, 1024, 1024, (32, 4)),       # training self-attention @512: 16 key blocks x 2
    (2, 1024, 10316, (324, 1)),     # training cross-attention @512: the grid fills
    (2, 4096, 4096, (128, 1)),      # @1024 self-attention, two objects: one wave
    (2, 420, 100, (4, 7)),          # two key blocks a head, seven q tiles
    (1, 64, 64, (1, 1)),            # one q tile
])
def test_dkv_split_fills_one_wave(bh, nq, nk, want):
    blocks = bh * -(-nk // A.DKV_BLOCK_KEYS)
    assert (blocks, A.split_count(blocks, -(-nq // A.DKV_Q_TILE), 132)) == want
