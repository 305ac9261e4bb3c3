"""The whole slice, JAX package against the PyTorch port, on CPU at TINY:
``init_state`` -> prompts on frame 0 -> ``propagate_in_video_batch`` over a
10-frame moving-square video (the 7-slot non-conditioning ring wraps), and
the video-resolution masks of ``propagate_in_video``. Per-frame low-res logits
agree to atol 1e-3 / rtol 1e-3."""

import jax
import numpy as np
import pytest
import torch

from medsam2_tpu.api.video_predictor import SAM2VideoPredictor as JaxPredictor
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu_torch.api.video_predictor import (SAM2VideoPredictor,
                                                   propagate_volumes_batched)
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.state import memory_bank as mb
from tests.test_predictors import TINY, moving_square_video

torch.set_num_threads(2)
TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def models():
    params = sam2_init(jax.random.PRNGKey(0), TINY)
    model = SAM2Model(TINY, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), TINY))
    return params, model


def _both(models, video, **kw):
    params, model = models
    jp = JaxPredictor(params, TINY, max_cond_frames=2, **kw)
    tp = SAM2VideoPredictor(model, max_cond_frames=2, **kw)
    return jp, jp.init_state(images=video), tp, tp.init_state(images=video)


def test_single_object_propagation_matches_jax(models):
    video, _ = moving_square_video(T=10)
    jp, js, tp, ts = _both(models, video)
    np.testing.assert_allclose(ts["images"].numpy(), np.asarray(js["images"]), atol=1e-6)
    pts, lab = np.array([[16.0, 28.0]]), np.array([1])
    jf, jids, jprev = jp.add_new_points(js, 0, 1, pts, lab)
    tf, tids, tprev = tp.add_new_points(ts, 0, 1, pts, lab)
    assert (tf, tids) == (jf, jids)
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), **TOL)

    jframes, jmasks = jp.propagate_in_video_batch(js)
    tframes, tmasks = tp.propagate_in_video_batch(ts)
    assert tframes == jframes == list(range(10))
    assert tuple(tmasks.shape) == jmasks.shape == (10, 1, 1, 16, 16)
    for i in range(10):
        np.testing.assert_allclose(tmasks[i].numpy(), np.asarray(jmasks[i]), **TOL,
                                   err_msg=f"frame {i}")

    jvid = list(jp.propagate_in_video(js))
    tvid = list(tp.propagate_in_video(ts))
    assert len(tvid) == len(jvid) == 10
    for (f, ids, m), (jf_, jids_, jm) in zip(tvid, jvid):
        assert (f, ids) == (jf_, jids_)
        assert tuple(m.shape) == (1, 1, 64, 64)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)


def test_two_objects_second_cond_frame_match_jax(models):
    """Box + points on frame 0, a second conditioning frame where only
    object 1 is prompted (object 2 takes the empty-mask path), 80-px video
    resized to the 64-px model and back, with the cross-object non-overlap
    constraint on the video-resolution masks."""
    video, _ = moving_square_video(T=10, size=80)
    jp, js, tp, ts = _both(models, video, non_overlap_masks=True)
    for p, s in ((jp, js), (tp, ts)):
        p.add_new_bbox(s, 0, obj_id=1, bbox=np.array([[10, 25], [30, 45]]))
        p.add_new_points(s, 0, obj_id=2, points=np.array([[60.0, 10.0], [50.0, 70.0]]),
                         labels=np.array([1, 0]))
        p.add_new_points(s, 4, obj_id=1, points=np.array([[35.0, 35.0]]),
                         labels=np.array([1]))
    jframes, jmasks = jp.propagate_in_video_batch(js)
    tframes, tmasks = tp.propagate_in_video_batch(ts)
    assert tframes == jframes
    assert tuple(tmasks.shape) == jmasks.shape == (10, 2, 1, 16, 16)
    for i in range(10):
        np.testing.assert_allclose(tmasks[i].numpy(), np.asarray(jmasks[i]), **TOL,
                                   err_msg=f"frame {i}")
    for (f, ids, m), (_, jids, jm) in zip(tp.propagate_in_video(ts),
                                          jp.propagate_in_video(js)):
        assert ids == jids == [1, 2]
        assert tuple(m.shape) == (2, 1, 80, 80)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL, err_msg=f"frame {f}")


def test_out_of_scope_paths_raise(models):
    """What the port still leaves out raises NotImplementedError with a
    pointer to ROADMAP.md: ``propagate_volumes_batched`` over a mesh.
    Everything else of the session runs (the parity tests of
    ``tests/test_torch_video_session.py``, ``test_torch_video_corrections.py``
    and ``test_torch_video_clear.py``)."""
    _, model = models
    video, _ = moving_square_video(T=6)
    spec = mb.BankSpec.from_config(TINY, max_cond_frames=1)
    videos = np.stack([video, video])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        propagate_volumes_batched(model, spec, videos, np.full((2, 1, 1, 2), 20.0, np.float32),
                                  np.ones((2, 1, 1), np.int32), mesh=object())


def test_mask_prompts_match_jax(models):
    """``add_new_mask`` on conditioning frames (an 80-px mask resized to the
    64-px model and re-binarised, and the empty mask that validation gives an
    absent object) beside a click, then propagation; and ``reset_state``."""
    video, gt = moving_square_video(T=8, size=80)
    jp, js, tp, ts = _both(models, video)
    previews = []
    for p, s in ((jp, js), (tp, ts)):
        p.add_new_mask(s, 0, obj_id=1, mask=gt[0])
        previews.append(p.add_new_points(s, 0, obj_id=2, points=np.array([[60.0, 10.0]]),
                                         labels=np.array([1]))[2])
        p.add_new_mask(s, 4, obj_id=1, mask=np.zeros((80, 80), np.float32))
        p.add_new_points(s, 4, obj_id=2, points=np.array([[60.0, 12.0]]), labels=np.array([1]))
    np.testing.assert_allclose(previews[1].numpy(), np.asarray(previews[0]), **TOL)
    jframes, jmasks = jp.propagate_in_video_batch(js)
    tframes, tmasks = tp.propagate_in_video_batch(ts)
    assert tframes == jframes == list(range(8))
    for i in range(8):
        np.testing.assert_allclose(tmasks[i].numpy(), np.asarray(jmasks[i]), **TOL,
                                   err_msg=f"frame {i}")
    tp.reset_state(ts)
    assert ts["obj_ids"] == [] and not ts["cond_frame_idx"] and not ts["tracked"]
    assert ts["images"].shape[0] == 8


def test_train_init_state_mixed_prompts_match_jax(models):
    """``train_init_state`` (the session with ``is_eval`` off: no dynamic
    multimask fallback, no binarised memory masks) from a [T, 3, S, S]
    video, the mixed prompts of ``tests/test_predictors.py``: a box and a
    mask on frame 0, a click on frame 2 for object 1 only (object 2 takes
    the empty-mask path there); low-res logits of every frame to 1e-3."""
    params, model = models
    video, gt = moving_square_video(T=4)
    jp = JaxPredictor(params, TINY, max_cond_frames=2)
    tp = SAM2VideoPredictor(model, max_cond_frames=2)
    js = jp.train_init_state(video.transpose(0, 3, 1, 2))
    ts = tp.train_init_state(video.transpose(0, 3, 1, 2))
    assert ts["is_eval"] is False and js["is_eval"] is False
    assert tp.val_init_state(video)["is_eval"] is True
    for p, s in ((jp, js), (tp, ts)):
        p.add_new_bbox(s, 0, obj_id=1, bbox=np.array([[8, 20], [24, 36]]))
        p.add_new_mask(s, 0, obj_id=2, mask=gt[0])
        p.add_new_points(s, 2, obj_id=1, points=np.array([[24.0, 28.0]]), labels=np.array([1]))
    jframes, jmasks = jp.propagate_in_video_batch(js)
    tframes, tmasks = tp.propagate_in_video_batch(ts)
    assert tframes == jframes == [0, 1, 2, 3]
    assert tuple(tmasks.shape) == jmasks.shape == (4, 2, 1, 16, 16)
    for i in range(4):
        np.testing.assert_allclose(tmasks[i].numpy(), np.asarray(jmasks[i]), **TOL,
                                   err_msg=f"frame {i}")
