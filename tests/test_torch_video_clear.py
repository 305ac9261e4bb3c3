"""``clear_non_cond_mem_around_input``, JAX package against the PyTorch port,
on CPU at TINY with the same weights, in each memory readout: the bank's
``clear_noncond_window`` and every readout's validity after it, the flags
(``tests/test_predictors.py:203``), and the scripts of
``tests/test_video_predictor_differential.py:448`` (two cond frames: the
second one clears the memories tracked before it) and ``:472`` (a correction
pops the retained outputs around it, then a resume past it). The sessions
use a 3-frame memory (``num_maskmem=3``, clear window +/-3 frames, a 3-slot
ring), as the JAX differential does. Low-res logits agree to atol 1e-3 /
rtol 1e-3; the flag-off port is shown to differ, so the cases
discriminate."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu.state import memory_bank as JB
from medsam2_tpu_torch.api import video_predictor as TV
from medsam2_tpu_torch.state import memory_bank as TB
from tests.test_predictors import TINY, moving_square_video
from tests.test_torch_video_corrections import (ONE, click, corr, run_script,  # noqa: F401
                                                use_kcache)
from tests.test_torch_video_session import (_pair, _port_model,  # noqa: F401
                                            no_persistent_cache_writes)

CFG3 = dataclasses.replace(TINY, num_maskmem=3, memory_temporal_stride_for_eval=1)
T = 10


@pytest.fixture(scope="module")
def params3():
    return sam2_init(jax.random.PRNGKey(0), CFG3)


@pytest.fixture(scope="module")
def model3(params3):
    return _port_model(params3, CFG3)


def clearing_pair(params3, model3, use_kcache, multi_obj=False):
    """(JAX predictor, port predictor) with clearing on. The clear flags are
    read only on the host, so the JAX predictor is a copy of the shared one
    (its compiled steps reused) with the flags set."""
    jp, _ = _pair(params3, model3, CFG3, use_kcache=use_kcache)
    jp = copy.copy(jp)
    jp.clear_non_cond_mem_around_input = True
    jp.clear_non_cond_mem_for_multi_obj = multi_obj
    tp = TV.SAM2VideoPredictor(model3, max_cond_frames=2, use_kcache=use_kcache,
                               clear_non_cond_mem_around_input=True,
                               clear_non_cond_mem_for_multi_obj=multi_obj)
    return jp, tp


@pytest.mark.parametrize("reverse", [False, True])
def test_clear_noncond_window_matches_jax(reverse):
    """A bank holding cond frames 0 and 9 and a wrapped ring, cleared around
    frame 5: the stored indices, and every readout's validity at a frame
    whose targets straddle the hole (storage-order slots, read-order spatial
    and pointer masks), equal JAX's; the payloads stay in place."""
    B, P, D, C = 2, 16, 64, 256
    rng = np.random.default_rng(4)
    jspec = JB.BankSpec.from_config(TINY, max_cond_frames=2)
    tspec = TB.BankSpec.from_config(TINY, max_cond_frames=2)
    jbank = JB.init_bank(jspec, B)
    tbank = TB.init_bank(tspec, B, "cpu")
    frames = [(0, True), (9, True)] + [(f, False) for f in range(1, 9)]
    for f, is_cond in frames:
        feats = rng.standard_normal((B, P, D)).astype(np.float32)
        ptr = rng.standard_normal((B, C)).astype(np.float32)
        jbank = JB.write_bank(jspec, jbank, f, jnp.asarray(feats), jnp.asarray(ptr), is_cond)
        with torch.no_grad():
            TB.write_bank(tspec, tbank, f, torch.from_numpy(feats), torch.from_numpy(ptr),
                          is_cond)
    before = tbank["noncond_feats"].clone()
    jbank = JB.clear_noncond_window(jbank, 5, 2)
    with torch.no_grad():
        assert TB.clear_noncond_window(tbank, 5, 2) is tbank          # in place
    for key in jbank:
        np.testing.assert_array_equal(tbank[key].numpy(), np.asarray(jbank[key]), err_msg=key)
    assert (tbank["noncond_frame_idx"][0] == -1).sum() == 5 and torch.equal(
        tbank["noncond_feats"], before)
    cur = 3 if reverse else 8
    rows, valid = TB.kv_storage_layout(tspec, tbank, cur, track_in_reverse=reverse)
    jrows, jvalid = JB.kv_storage_layout(jspec, jbank, cur, track_in_reverse=reverse)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(rows.numpy()[np.asarray(jvalid)[0]],
                                  np.asarray(jrows)[np.asarray(jvalid)[0]])
    assert not valid[:, 2:].all() and valid[:, 2:].any()               # a hole mid-ring
    tpos = np.zeros((TINY.num_maskmem, D), np.float32)
    spatial = np.zeros((P, D), np.float32)
    tread = TB.read_bank(tspec, tbank, cur, torch.from_numpy(tpos), torch.from_numpy(spatial),
                         track_in_reverse=reverse, num_frames=T)
    jread = JB.read_bank(jspec, jbank, cur, jnp.asarray(tpos), jnp.asarray(spatial),
                         track_in_reverse=reverse, num_frames=T)
    np.testing.assert_array_equal(tread[2].numpy(), np.asarray(jread[2]))
    # the cleared frames leave holes in the read-order mask
    assert not tread[2].all()
    # under autograd with a bank that requires grad, the clear is out of place
    grad_bank = {**tbank, "noncond_feats": tbank["noncond_feats"].clone().requires_grad_()}
    stored = grad_bank["ptr_frame_idx"].clone()
    cleared = TB.clear_noncond_window(grad_bank, 2, 1)
    assert cleared is not grad_bank and torch.equal(grad_bank["ptr_frame_idx"], stored)
    assert (cleared["ptr_frame_idx"] == -1).sum() > (stored == -1).sum()


def test_clear_flags_match_jax(params3, model3, use_kcache):
    """``tests/test_predictors.py:203``: the flags are kept, and with both on
    (clearing for several objects too) a two-object session runs end to end
    through ``propagate_in_video``, as JAX's."""
    jp, tp = clearing_pair(params3, model3, use_kcache, multi_obj=True)
    assert tp.clear_non_cond_mem_around_input and tp.clear_non_cond_mem_for_multi_obj
    video, _ = moving_square_video(T=T)
    js, ts = jp.init_state(images=video), tp.init_state(images=video)
    for p, s in ((jp, js), (tp, ts)):
        p.add_new_points(s, 0, 1, click(16.0), ONE)
        p.add_new_points(s, 0, 2, click(48.0, 50.0), ONE)
    got = list(tp.propagate_in_video(ts))
    want = list(jp.propagate_in_video(js))
    assert len(got) == len(want) == T
    for (f, ids, m), (jf, jids, jm) in zip(got, want):
        assert (f, ids) == (jf, jids)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-3, rtol=1e-3,
                                   err_msg=f"frame {f}")


def test_clear_with_two_cond_frames_matches_jax(params3, model3, use_kcache):
    """``tests/test_video_predictor_differential.py:448``: one object, cond
    frames 0 and 5; visiting frame 5 clears the memories of frames 2-4
    tracked in the same run, so frames 6+ re-track without them."""
    jp, tp = clearing_pair(params3, model3, use_kcache)
    video, _ = moving_square_video(T=T)
    script = [("points", 0, 1, click(16.0), ONE), ("points", 5, 1, click(36.0), ONE),
              ("prop", {})]
    _, ts, (on,) = run_script(jp, tp, video, script)
    off = TV.SAM2VideoPredictor(model3, max_cond_frames=2, use_kcache=use_kcache)
    s = off.init_state(images=video)
    for step in script[:2]:
        off.add_new_points(s, *step[1:])
    _, m_off = off.propagate_in_video_batch(s)
    assert not np.allclose(on[6:].numpy(), m_off[6:].numpy(), atol=1e-3)
    # the frames cleared at frame 5 offer no retained output any more
    assert sorted(ts["last_masks"]) == [0, 1, 5, 6, 7, 8, 9]


def test_clear_then_resume_after_correction_matches_jax(params3, model3, use_kcache):
    """``tests/test_video_predictor_differential.py:472``: a full
    propagation, a correction on frame 5, then a resume from frame 8. The
    correction pops the retained outputs of frames 2-8, its own included, so
    the resume re-tracks against cond frame 0 and the surviving early
    pointers, and both packages warn that the correction had no effect. A
    last full propagation then finds the correction without a retained
    output: it takes the memoryless prompt decode, written to the non-cond
    ring (``write_cond=False``) and restored there when the order reaches
    it."""
    jp, tp = clearing_pair(params3, model3, use_kcache)
    video, _ = moving_square_video(T=T)
    script = [("points", 0, 1, click(16.0), ONE), ("prop", {}),
              ("points", 5, 1, *corr(5)), ("prop", dict(start_frame_idx=8)), ("prop", {})]
    _, ts, (_, on, _) = run_script(jp, tp, video, script)
    assert ts["noncond_prompt_frame_idx"] == {5} and ts["corr_consolidated"] == set()
    off = TV.SAM2VideoPredictor(model3, max_cond_frames=2, use_kcache=use_kcache)
    s = off.init_state(images=video)
    off.add_new_points(s, *script[0][1:])
    off.propagate_in_video_batch(s)
    off.add_new_points(s, *script[2][1:])
    with pytest.warns(UserWarning, match="corrections on frames"):
        _, m_off = off.propagate_in_video_batch(s, start_frame_idx=8)
    assert not np.allclose(on.numpy(), m_off.numpy(), atol=1e-3)
