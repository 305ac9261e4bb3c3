"""Batched multi-volume streaming, JAX package against the PyTorch port,
on CPU at TINY with the same weights: several volumes against one, the
folded form (volumes on the batch axis of one bank) against JAX's in both
readouts of the roped-key cache, and the unfolded form against the folded.
Low-res logits agree to atol 1e-3 / rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from medsam2_tpu.api import video_predictor as JV
from medsam2_tpu.state import memory_bank as JB
from medsam2_tpu_torch.api import video_predictor as TV
from medsam2_tpu_torch.state import memory_bank as TB
from medsam2_tpu_torch.utils.transforms import IMAGENET_MEAN, IMAGENET_STD
from tests.test_predictors import TINY, moving_square_video
from tests.test_torch_video_session import (TOL, model, no_persistent_cache_writes,  # noqa: F401
                                            params)


def _volumes(V: int, T: int, O: int, F: int, seed: int):
    """V normalised volumes (moving squares and their time reversals) and
    seeded click prompts [V, F, O, 1, 2]."""
    video, _ = moving_square_video(T=T)
    vids = [video if v % 2 == 0 else video[::-1].copy() for v in range(V)]
    videos = ((np.stack(vids) - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    rng = np.random.default_rng(seed)
    coords = (16.0 + 32.0 * rng.random((V, F, O, 1, 2))).astype(np.float32)
    return videos, coords, np.ones((V, F, O, 1), np.int32)


def _jax_volumes(params, spec, videos, coords, labels, **kw):
    """The JAX package's ``propagate_volumes_batched`` under one jit, as
    ``bench.py`` runs it (a third of its eager time on the CPU)."""
    fn = jax.jit(lambda v, c, l: JV.propagate_volumes_batched(params, TINY, spec, v, c, l,
                                                              **kw))
    return np.asarray(fn(jnp.asarray(videos), jnp.asarray(coords), jnp.asarray(labels)))


def test_batched_volumes_match_single_and_jax(params, model):
    """``tests/test_batched_volumes.py:22``: two volumes batched against the
    first alone, the legacy one-prompt-frame form, folded, against JAX."""
    spec_j = JB.BankSpec.from_config(TINY, max_cond_frames=1)
    spec_t = TB.BankSpec.from_config(TINY, max_cond_frames=1)
    videos, coords, labels = _volumes(2, 4, 1, 1, seed=0)
    coords, labels = coords[:, 0], labels[:, 0]                 # [V, O, P, 2]
    got = TV.propagate_volumes_batched(model, spec_t, videos, coords, labels)
    want = _jax_volumes(params, spec_j, videos, coords, labels)
    assert tuple(got.shape) == want.shape == (2, 4, 1, 1, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    single = TV.propagate_volumes_batched(model, spec_t, videos[:1], coords[:1], labels[:1])
    np.testing.assert_allclose(got[0].numpy(), single[0].numpy(), atol=1e-4)


@pytest.mark.parametrize("kv", ["0", "1"])
def test_folded_and_unfolded_volumes_match_jax(params, model, monkeypatch, kv):
    """``tests/test_batched_volumes.py:110``: 2 volumes x 2 objects, 2
    conditioning frames; the folded form in each readout of the cache
    (``MEDSAM2_KV_STORAGE``) against JAX's, and the unfolded form (volume
    after volume, read order over the cache) against the folded one."""
    monkeypatch.setenv("MEDSAM2_KV_STORAGE", kv)
    spec_j = JB.BankSpec.from_config(TINY, max_cond_frames=2)
    spec_t = TB.BankSpec.from_config(TINY, max_cond_frames=2)
    videos, coords, labels = _volumes(2, 6, 2, 2, seed=3)
    folded = TV.propagate_volumes_batched(model, spec_t, videos, coords, labels,
                                          num_objects=2, prompt_frames=(0, 3), fold=True)
    want = _jax_volumes(params, spec_j, videos, coords, labels, num_objects=2,
                        prompt_frames=(0, 3), fold=True)
    assert tuple(folded.shape) == want.shape == (2, 6, 2, 1, 16, 16)
    np.testing.assert_allclose(folded.numpy(), np.asarray(want), **TOL)
    monkeypatch.setenv("MEDSAM2_FOLD", "0")           # fold=None reads it
    unfolded = TV.propagate_volumes_batched(model, spec_t, videos, coords, labels,
                                            num_objects=2, prompt_frames=(0, 3))
    # the JAX package's own folded-vs-vmapped tolerance (test_batched_volumes.py:110)
    np.testing.assert_allclose(unfolded.numpy(), folded.numpy(), rtol=2e-4, atol=2e-4)
