"""Corrections on tracked frames, JAX package against the PyTorch port, on
CPU at TINY with the same weights and the same numpy-seeded inputs, in each
memory readout (storage order over the roped-key cache, read order over the
cache with ``MEDSAM2_KV_STORAGE=0``, read order over raw memory with
``use_kcache=False``). The scenarios mirror ``tests/test_predictors.py``
(non-cond against ``add_all_frames_to_correct_as_cond``, a correction whose
ring slot an earlier frame shares) and the scripts of
``tests/test_video_predictor_differential.py`` (a correction click with
consolidated reuse, a mixed point / mask correction, two fresh corrections in
one round), plus a correction on a frame tracked in reverse, on a 10-frame
video with two objects prompted on different frames. Low-res logits
agree to atol 1e-3 / rtol 1e-3 after every propagation, and the session's
prompt and retention sets equal JAX's after every call.
``clear_non_cond_mem_around_input`` is in
``tests/test_torch_video_clear.py``, which uses this file's helpers."""

import copy
import dataclasses
import warnings

import numpy as np
import pytest

from medsam2_tpu_torch.api import video_predictor as TV
from tests.test_predictors import TINY, moving_square_video
from tests.test_torch_video_session import (_pair, _port_model, _propagate,  # noqa: F401
                                            model, no_persistent_cache_writes, params)

ONE = np.array([1])
# the memory readouts, chosen as the JAX package chooses them:
# (MEDSAM2_KV_STORAGE, use_kcache)
READOUTS = {"storage": ("1", True), "read_kcache": ("0", True), "read_raw": ("1", False)}
STATE_SETS = ("cond_frame_idx", "noncond_prompt_frame_idx", "corr_consolidated",
              "new_prompt_frames")


@pytest.fixture(params=list(READOUTS))
def use_kcache(request, monkeypatch):
    """Select one readout in both packages; returns the predictors'
    ``use_kcache``."""
    env, flag = READOUTS[request.param]
    monkeypatch.setenv("MEDSAM2_KV_STORAGE", env)
    return flag


def click(x: float, y: float = 28.0):
    return np.array([[x, y]], np.float32)


def square_mask(t: int, size: int = 64):
    """The moving square of ``moving_square_video`` on frame t."""
    m = np.zeros((size, size), np.float32)
    m[20:36, 8 + 4 * t:24 + 4 * t] = 1.0
    return m


def same_state(js, ts, what=""):
    for key in STATE_SETS:
        assert ts[key] == js[key], f"{what}: {key} {ts[key]} vs {js[key]}"
    assert set(ts["last_masks"]) == set(js["last_masks"]), what
    assert set(ts["last_ptrs"]) == set(js["last_ptrs"]), what
    assert ts["frames_tracked"] == js["frames_tracked"], what


def run_script(jp, tp, video, script):
    """Apply ``script`` to a JAX and a port session over ``video``: steps
    ("points", frame, obj, coords, labels), ("mask", frame, obj, mask) or
    ("prop", kwargs). Every propagation is compared, and so are the session
    sets after every step, and the frames any warning names. Returns (JAX
    state, port state, [port masks of each propagation])."""
    js, ts = jp.init_state(images=video), tp.init_state(images=video)
    outs = []
    for i, step in enumerate(script):
        if step[0] == "points":
            for p, s in ((jp, js), (tp, ts)):
                p.add_new_points(s, step[1], step[2], step[3], step[4])
        elif step[0] == "mask":
            for p, s in ((jp, js), (tp, ts)):
                p.add_new_mask(s, step[1], step[2], step[3])
        else:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outs.append(_propagate(jp, js, tp, ts, what=f"step {i}", **step[1])[1])
            msgs = sorted(str(w.message).split(" are ")[0] for w in caught
                          if "corrections on frames" in str(w.message))
            assert len(msgs) % 2 == 0 and msgs[::2] == msgs[1::2], msgs
        same_state(js, ts, f"step {i}")
    return js, ts, outs


# One shape for every scenario, so the JAX predictors' compiled steps are
# shared between the tests of a readout: 10 frames, two objects prompted on
# different frames (cond frames 0 and 2, so every bank holds two cond slots,
# the add_all_frames_to_correct_as_cond variant's too), two-click
# corrections placed so that the runs between spliced frames repeat lengths.
T = 10
START = [("points", 0, 1, click(16.0), ONE), ("points", 2, 2, click(48.0, 50.0), ONE),
         ("prop", {})]


def corr(f: int):
    """A positive click on the square of frame f and a negative one off it."""
    return np.array([[16.0 + 4 * f, 28.0], [56.0, 6.0]], np.float32), np.array([1, 0])


def test_correction_noncond_vs_cond_matches_jax(params, model, use_kcache):  # noqa: F811
    """``tests/test_predictors.py:225``: by default a click on a tracked
    frame stays a non-cond correction, decoded memory-conditioned (not the
    memoryless preview), changing the frame and leaving the frames before
    it as they were; with ``add_all_frames_to_correct_as_cond`` it becomes a
    conditioning frame. That flag is read only on the host, so the second
    JAX predictor shares the first one's compiled steps."""
    video, _ = moving_square_video(T=T)
    jp, tp = _pair(params, model, use_kcache=use_kcache)
    script = START + [("points", 5, 1, *corr(5)), ("prop", {})]
    js, ts, (m1, m2) = run_script(jp, tp, video, script)
    assert ts["cond_frame_idx"] == {0, 2} and ts["noncond_prompt_frame_idx"] == {5}
    np.testing.assert_allclose(m2[:5].numpy(), m1[:5].numpy(), rtol=1e-4, atol=1e-5)
    preview = tp._preview(ts, 5)[2]
    assert not np.allclose(m2[5, 0].numpy(), preview[0].numpy(), rtol=1e-3, atol=1e-4)
    assert not np.allclose(m2[5, 0].numpy(), m1[5, 0].numpy(), rtol=1e-3, atol=1e-4)

    cfg = dataclasses.replace(TINY, add_all_frames_to_correct_as_cond=True)
    jp_cond = copy.copy(jp)
    jp_cond.cfg = cfg
    tp = TV.SAM2VideoPredictor(_port_model(params, cfg), max_cond_frames=2,
                               use_kcache=use_kcache)
    js, ts, _ = run_script(jp_cond, tp, video, script)
    assert ts["cond_frame_idx"] == {0, 2, 5} and ts["noncond_prompt_frame_idx"] == set()


def test_correction_survives_ring_clobber_matches_jax(params, model, use_kcache):  # noqa: F811
    """``tests/test_predictors.py:274``: a correction on frame 8 shares its
    ring slot (7 slots) with frame 1; the re-propagation writes frame 1
    first, and the correction's memory must still be the one read after
    frame 8. A third propagation reuses the consolidated decode and gives
    the second one's masks."""
    video, _ = moving_square_video(T=T)
    jp, tp = _pair(params, model, use_kcache=use_kcache)
    assert 8 - tp._session_spec({"cond_frame_idx": {0}}).noncond_ring == 1
    script = START + [("points", 8, 1, *corr(8)), ("prop", {}), ("prop", {})]
    _, ts, (_, m2, m3) = run_script(jp, tp, video, script)
    assert ts["corr_consolidated"] == {8}
    np.testing.assert_allclose(m3.numpy(), m2.numpy(), rtol=1e-5, atol=1e-6)


def test_correction_click_with_consolidated_reuse_matches_jax(params, model,  # noqa: F811
                                                               use_kcache):
    """``tests/test_video_predictor_differential.py:280``: a positive and a
    negative click on object 1 at frame 5, re-propagation, then a third
    propagation that reuses the stored decode (idempotent); object 2 keeps
    its tracked output on frame 5. A new click re-opens the consolidated
    frame."""
    video, _ = moving_square_video(T=T)
    jp, tp = _pair(params, model, use_kcache=use_kcache)
    script = START + [("points", 5, 1, *corr(5)), ("prop", {}), ("prop", {})]
    js, ts, (m1, m2, m3) = run_script(jp, tp, video, script)
    assert not np.allclose(m2[5, 0].numpy(), m1[5, 0].numpy(), atol=1e-3)
    np.testing.assert_allclose(m2[5, 1].numpy(), m1[5, 1].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m3.numpy(), m2.numpy(), rtol=1e-5, atol=1e-6)
    assert ts["corr_consolidated"] == {5}
    for p, s in ((jp, js), (tp, ts)):
        p.add_new_points(s, 5, 1, *corr(5))
    same_state(js, ts, "re-opened")
    assert ts["corr_consolidated"] == set() and ts["new_prompt_frames"] == {5}
    _propagate(jp, js, tp, ts, what="after the re-opening click")


def test_mixed_point_and_mask_correction_matches_jax(params, model, use_kcache):  # noqa: F811
    """``tests/test_video_predictor_differential.py:343``: on one tracked
    frame, points for object 1 (the memory-conditioned decode) and a mask
    for object 2 (mask as output)."""
    video, _ = moving_square_video(T=T)
    jp, tp = _pair(params, model, use_kcache=use_kcache)
    script = START + [("points", 5, 1, *corr(5)), ("mask", 5, 2, square_mask(5)), ("prop", {})]
    _, ts, _ = run_script(jp, tp, video, script)
    assert ts["noncond_prompt_frame_idx"] == {5}


def test_two_fresh_corrections_one_round_match_jax(params, model, use_kcache):  # noqa: F811
    """``tests/test_video_predictor_differential.py:378``: corrections on
    frames 5 and 8 added between two propagations; each decodes against the
    bank of its own tracking, so neither sees the other."""
    video, _ = moving_square_video(T=T)
    jp, tp = _pair(params, model, use_kcache=use_kcache)
    script = START + [("points", 5, 1, *corr(5)), ("points", 8, 1, *corr(8)), ("prop", {})]
    _, ts, _ = run_script(jp, tp, video, script)
    assert ts["corr_consolidated"] == {5, 8}


def test_reverse_tracked_correction_matches_jax(params, model, use_kcache):  # noqa: F811
    """The objects prompted on frames 9 and 7 and tracked in reverse; a
    correction on frame 4 (tracked in reverse, so it decodes reading the
    frames after it) and reverse re-propagation; then a forward propagation
    from frame 0, whose order holds the consolidated correction."""
    video, _ = moving_square_video(T=T)
    jp, tp = _pair(params, model, use_kcache=use_kcache)
    script = [("points", 9, 1, click(52.0), ONE), ("points", 7, 2, click(48.0, 50.0), ONE),
              ("prop", dict(reverse=True)), ("points", 4, 1, *corr(4)),
              ("prop", dict(reverse=True)), ("prop", dict(start_frame_idx=0))]
    _, ts, _ = run_script(jp, tp, video, script)
    assert ts["frames_tracked"][4] is False and ts["corr_consolidated"] == {4}
