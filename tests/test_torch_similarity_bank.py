"""The 2D similarity bank, JAX package against the PyTorch port, on the CPU.

Inputs are made with numpy from a seed and go through
``medsam2_tpu.state.similarity_bank`` and its port. Held to 1e-6 (the
banks' contents, the logits) or exactly (validity, drawn memories under
injected indices): fill, replacement with the soft-IoU gate, the overshoot
at ``bank_size``, ties and the rows with fewer than two valid slots. The
port's own draws (``torch.multinomial`` from a ``torch.Generator``) are held
to the softmax they sample."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.state import similarity_bank as J
from medsam2_tpu_torch.state import similarity_bank as T

K, P, D, E = 9, 3, 4, 6
TOL = dict(rtol=1e-6, atol=1e-6)


def _both_init(k=K):
    return J.init_similarity_bank(k, P, D, E), T.init_similarity_bank(k, P, D, E, "cpu")


def _same(jb, tb):
    np.testing.assert_array_equal(tb["valid"].numpy(), np.asarray(jb["valid"]))
    for key in ("feats", "iou", "embeds"):
        np.testing.assert_allclose(tb[key].numpy(), np.asarray(jb[key]), **TOL, err_msg=key)


def _batch(rng, B):
    return (rng.standard_normal((B, P, D)).astype(np.float32),
            np.float32(rng.uniform(0.2, 0.9)),
            rng.standard_normal((B, E)).astype(np.float32))


def _write(jb, tb, feats, iou, embeds, bank_size=None):
    jb = J.write_similarity_bank(jb, jnp.asarray(feats), jnp.asarray(iou), jnp.asarray(embeds),
                                 bank_size=bank_size)
    tb = T.write_similarity_bank(tb, torch.from_numpy(feats), torch.tensor(iou),
                                 torch.from_numpy(embeds), bank_size=bank_size)
    return jb, tb


def test_init_matches_jax():
    jb, tb = _both_init()
    for key in jb:
        assert tuple(tb[key].shape) == jb[key].shape, key
        assert str(tb[key].dtype).split(".")[-1] == str(jb[key].dtype)
    _same(jb, tb)


@pytest.mark.parametrize("B,bank_size", [(3, None), (3, 7), (4, 5), (2, 9)],
                         ids=["fill_replace", "overshoot_7_of_9", "overshoot_5_of_9", "B2"])
def test_write_sequence_matches_jax(B, bank_size):
    """Eight steps: the bank appends while it holds fewer than ``bank_size``
    entries at the start of a step (so it overshoots to a multiple of B),
    then replaces by the similarity rule and the IoU gate."""
    rng = np.random.default_rng(B * 10 + (bank_size or 0))
    jb, tb = _both_init()
    counts, replaced = [], 0
    for step in range(8):
        feats, iou, embeds = _batch(rng, B)
        before = tb["feats"].clone()
        jb, tb = _write(jb, tb, feats, iou, embeds, bank_size)
        _same(jb, tb)
        counts.append(int(tb["valid"].sum()))
        if counts[-1] == (counts[-2] if len(counts) > 1 else -1):
            replaced += int(not torch.equal(before, tb["feats"]))
    size = K if bank_size is None else bank_size
    full = min(K, -(-size // B) * B)
    assert counts[-1] == full and counts == sorted(counts)
    assert replaced > 0                               # the replacement rule fired


def test_replacement_iou_gate_and_order_match_jax():
    """A full bank: a new memory unlike every entry replaces the most
    similar pair's partner only when its IoU clears the entry's minus 0.1."""
    rng = np.random.default_rng(3)
    jb, tb = _both_init(4)
    feats, _, embeds = _batch(rng, 4)
    feats[1] = feats[0] + 1e-3                        # entries 0 and 1: a near pair
    jb, tb = _write(jb, tb, feats, np.float32(0.9), embeds)
    far = -feats[2:3] * 5.0                           # least like entry 2
    jb, tb = _write(jb, tb, far, np.float32(0.7), embeds[:1])
    _same(jb, tb)
    assert np.allclose(tb["iou"].numpy(), 0.9)        # 0.7 < 0.9 - 0.1: gated out
    jb, tb = _write(jb, tb, far, np.float32(0.85), embeds[:1])
    _same(jb, tb)
    assert np.isclose(tb["iou"].numpy(), 0.85).sum() == 1


def test_ties_and_short_rows_pick_slot_0_as_jax():
    """Ties in argmin / argmax go to the first index, and a pair-similarity
    row with fewer than two valid slots is all -inf, whose argmax is slot 0
    in both packages."""
    row = np.full(K, -np.inf, np.float32)
    assert int(jnp.argmax(jnp.asarray(row))) == int(torch.argmax(torch.from_numpy(row))) == 0
    rng = np.random.default_rng(4)
    feats, iou, embeds = _batch(rng, 2)
    # one valid slot in replace mode (bank_size 1): nothing clears the rule
    jb, tb = _both_init(3)
    jb, tb = _write(jb, tb, feats[:1], iou, embeds[:1])
    jb, tb = _write(jb, tb, feats[1:], iou, embeds[1:], bank_size=1)
    _same(jb, tb)
    assert int(tb["valid"].sum()) == 1
    # duplicated entries: every similarity ties
    jb, tb = _both_init(3)
    dup = np.repeat(feats[:1], 3, axis=0)
    jb, tb = _write(jb, tb, dup, np.float32(0.5), np.repeat(embeds[:1], 3, axis=0))
    jb, tb = _write(jb, tb, -dup[:1], np.float32(0.9), -embeds[:1])
    _same(jb, tb)


def test_similarity_logits_and_read_with_injected_indices_match_jax():
    rng = np.random.default_rng(5)
    jb, tb = _both_init()
    for _ in range(2):
        jb, tb = _write(jb, tb, *_batch(rng, 3))
    cur = rng.standard_normal((2, E)).astype(np.float32)
    want = np.asarray(J.similarity_logits(jb, jnp.asarray(cur)))
    got = T.similarity_logits(tb, torch.from_numpy(cur)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **TOL)
    idx = rng.integers(0, 6, (2, 4))
    jm, jidx = J.read_similarity_bank(jb, jnp.asarray(cur), None, 4, indices=jnp.asarray(idx))
    tm, tidx = T.read_similarity_bank(tb, torch.from_numpy(cur), None, 4,
                                      indices=torch.from_numpy(idx))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tuple(tm.shape) == jm.shape == (2, 4 * P, D)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


def test_draws_follow_the_softmax():
    """The port's own draws: valid slots only, with frequencies within 0.01
    of the softmax of the logits (20000 draws a row), and one generator seed
    gives one draw."""
    rng = np.random.default_rng(6)
    jb, tb = _both_init()
    for _ in range(2):
        jb, tb = _write(jb, tb, *_batch(rng, 3))
    cur = torch.from_numpy(rng.standard_normal((2, E)).astype(np.float32))
    n = 20000
    _, idx = T.read_similarity_bank(tb, cur, torch.Generator().manual_seed(0), n)
    assert idx.shape == (2, n) and bool(tb["valid"][idx].all())
    probs = torch.softmax(T.similarity_logits(tb, cur), -1)
    freq = torch.stack([torch.bincount(r, minlength=K).float() / n for r in idx])
    assert (freq - probs).abs().max().item() < 0.01
    _, again = T.read_similarity_bank(tb, cur, torch.Generator().manual_seed(0), n)
    assert torch.equal(idx, again)
