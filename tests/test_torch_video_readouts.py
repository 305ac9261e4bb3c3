"""The three memory readouts of the propagation session, JAX package
against the PyTorch port, on CPU at TINY with the same weights: storage
order over the roped-key cache, read order over the cache
(``MEDSAM2_KV_STORAGE=0``) and read order over raw memory
(``use_kcache=False``), forward and in reverse at the eval stride, and the
sam2.1 object-pointer flags. Low-res logits agree to atol 1e-3 / rtol
1e-3 (``tests/test_torch_video_session.py``'s helpers)."""

import dataclasses

import jax
import numpy as np
import pytest

from medsam2_tpu.core.sam2_model import sam2_init
from tests.test_predictors import TINY, moving_square_video
from tests.test_torch_video_session import (_pair, _port_model, _propagate, _session,  # noqa: F401
                                            model, params)

def test_kcache_and_uncached_match_jax(params, model):
    """``tests/test_predictors.py:298``: ``use_kcache=False`` (read order
    over raw memory) against the default, both against JAX, two prompt
    frames."""
    video, _ = moving_square_video(T=6)
    out = {}
    for flag in (True, False):
        jp, tp = _pair(params, model, use_kcache=flag)
        assert tp.use_kcache == flag
        js, ts = _session(jp, tp, video, [(0, (1, (16.0, 28.0))), (2, (1, (24.0, 28.0)))])
        _, out[flag] = _propagate(jp, js, tp, ts, what=f"use_kcache={flag}")
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("readout", ["storage", "read_kcache", "read_raw"])
@pytest.mark.parametrize("reverse", [False, True])
def test_three_readouts_match_jax(params, model, monkeypatch, readout, reverse):
    """``tests/test_predictors.py:360`` / ``:391``: each readout, forward
    (prompts on frames 0 and 5) and in reverse (a prompt on the last frame),
    at the eval stride 2, over a ring that wraps; the storage order and the
    read order over the cache are chosen by ``MEDSAM2_KV_STORAGE`` in both
    packages, raw memory by ``use_kcache=False``."""
    monkeypatch.setenv("MEDSAM2_KV_STORAGE", "0" if readout == "read_kcache" else "1")
    cfg = dataclasses.replace(TINY, memory_temporal_stride_for_eval=2)
    jp, tp = _pair(params, model, cfg, use_kcache=readout != "read_raw")
    T = 13
    video, _ = moving_square_video(T=T)
    prompts = ([(T - 1, (1, (56.0, 28.0)))] if reverse
               else [(0, (1, (16.0, 28.0))), (5, (1, (36.0, 28.0)))])
    js, ts = _session(jp, tp, video, prompts)
    frames, _ = _propagate(jp, js, tp, ts, what=readout, reverse=reverse)
    assert len(frames) == T


@pytest.mark.parametrize("kv", ["1", "0"])
def test_obj_ptr_tpos_flags_match_jax(monkeypatch, kv):
    """``tests/test_predictors.py:412``: the sam2.1 pointer flags
    (``add_tpos_enc_to_obj_ptrs``, ``proj_tpos_enc_in_obj_ptrs``) in storage
    order and in read order over the cache, forward then reverse."""
    monkeypatch.setenv("MEDSAM2_KV_STORAGE", kv)
    cfg = dataclasses.replace(TINY, add_tpos_enc_to_obj_ptrs=True,
                              proj_tpos_enc_in_obj_ptrs=True)
    params = sam2_init(jax.random.PRNGKey(2), cfg)
    jp, tp = _pair(params, _port_model(params, cfg), cfg)
    video, _ = moving_square_video(T=8)
    js, ts = _session(jp, tp, video, [(3, (1, (28.0, 28.0)))])
    _propagate(jp, js, tp, ts, what="forward")
    _propagate(jp, js, tp, ts, what="reverse", reverse=True)


