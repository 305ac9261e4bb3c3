"""The rest of the 3D propagation session, JAX package against the PyTorch
port, on CPU at TINY with the same weights (``export_state_dict`` /
``state_dict_from_jax``) and the same numpy-seeded inputs: reverse tracking
over a wrapping ring, the eval stride, segmented edge cases, resumed and
bidirectional sessions, the eval predictor (hole filling, non-overlap) and
sessions from a JPEG directory (async, offloaded). Low-res logits agree to
atol 1e-3 / rtol 1e-3, the tolerance of
``tests/test_torch_video_predictor.py``.

The weights are the port's seeded init, read into a JAX tree by the JAX
package's own reference-checkpoint converter (``convert_state_dict``): no
JAX init compiles in a worker. Under the driver's ``--dist load`` the tests
of this file spread over workers, and each worker that takes one builds the
module fixtures (this file's and those of the files that import them); the
eager JAX ``sam2_init`` they ran before cost ~30 s of op-by-op compiles per
worker and module. The three memory readouts are in
``tests/test_torch_video_readouts.py``, batched volumes in
``tests/test_torch_batched_volumes.py``; both use this file's helpers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsam2_tpu.api import video_predictor as JV
from medsam2_tpu.checkpoint.convert import convert_state_dict
from medsam2_tpu_torch.api import video_predictor as TV
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.state import memory_bank as TB
from tests.test_predictors import TINY, moving_square_video

torch.set_num_threads(2)
TOL = dict(atol=1e-3, rtol=1e-3)
PT = np.array([[16.0, 28.0]])
ONE = np.array([1])


@pytest.fixture(scope="module", autouse=True)
def no_persistent_cache_writes():
    """Keep the module's JAX compiles out of the persistent compilation
    cache. ``tests/conftest.py`` writes every compile that takes 30 s or
    more; under the driver's load a mid-size compile of the JAX predictor's
    steps (or train step) passes 30 s, and XLA:CPU aborts the worker while
    it serialises the executable (the traceback ends in
    ``compilation_cache.put_executable_and_time``). Files that compile such
    programs import this fixture."""
    key = "jax_persistent_cache_min_compile_time_secs"
    before = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, before)


def _port_model(params, cfg):
    model = SAM2Model(cfg, seed=1, device="cpu")
    load_reference_state_dict(
        model, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


@pytest.fixture(scope="module")
def model():
    return SAM2Model(TINY, seed=0, device="cpu")


@pytest.fixture(scope="module")
def params(model):
    """The port model's weights as JAX parameters."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray, convert_state_dict(sd, TINY))


_JAX_PREDICTORS = {}


def _pair(params, model, cfg=TINY, max_cond_frames=2, **kw):
    """(JAX predictor, port predictor) over the same weights; ``cfg`` may
    change fields that hold no weights. JAX predictors are shared across
    the tests of a file, so their compiled steps are reused."""
    if cfg is not TINY:
        model = _port_model(params, cfg)
    key = (id(params), repr(cfg), max_cond_frames, tuple(sorted(kw.items())))
    if key not in _JAX_PREDICTORS:
        _JAX_PREDICTORS[key] = JV.SAM2VideoPredictor(params, cfg,
                                                     max_cond_frames=max_cond_frames, **kw)
    return _JAX_PREDICTORS[key], TV.SAM2VideoPredictor(model, max_cond_frames=max_cond_frames,
                                                       **kw)


def _same(got_frames, got, want_frames, want, what=""):
    assert got_frames == want_frames, what
    assert tuple(got.shape) == tuple(np.shape(want)), what
    for i, f in enumerate(got_frames):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), **TOL,
                                   err_msg=f"{what} frame {f}")


def _session(jp, tp, video, prompts):
    """Both sessions with the same click prompts {frame: (obj_id, point)}."""
    js, ts = jp.init_state(images=video), tp.init_state(images=video)
    for f, (obj, pt) in prompts:
        jp.add_new_points(js, f, obj, np.array([pt]), ONE)
        tp.add_new_points(ts, f, obj, np.array([pt]), ONE)
    return js, ts


def _propagate(jp, js, tp, ts, what="", **kw):
    jf, jm = jp.propagate_in_video_batch(js, **kw)
    tf, tm = tp.propagate_in_video_batch(ts, **kw)
    _same(tf, tm, jf, jm, what)
    return tf, tm


def test_reverse_ring_wraparound_matches_jax(params, model):
    """``tests/test_predictors.py:138`` run in reverse: a prompt on the last
    frame, tracked backwards over more than twice the 7-slot ring, so the
    reverse target arithmetic (the ceiling division) meets wrapped slots."""
    jp, tp = _pair(params, model)
    ring = TB.BankSpec.from_config(TINY, 2).noncond_ring
    T = ring * 2 + 3
    video, _ = moving_square_video(T=T)
    js, ts = _session(jp, tp, video, [(T - 1, (1, (60.0, 28.0)))])
    frames, _ = _propagate(jp, js, tp, ts, reverse=True)
    assert frames == list(range(T - 1, -1, -1))
    assert ts["frames_tracked"] == {f: True for f in range(T)}


@pytest.mark.parametrize("reverse", [False, True])
def test_eval_stride_matches_jax(params, model, reverse):
    """``tests/test_predictors.py:152``: memory_temporal_stride_for_eval
    r = 2 (an 11-slot ring), forward from frame 0 and reverse from the last
    frame."""
    cfg = dataclasses.replace(TINY, memory_temporal_stride_for_eval=2)
    jp, tp = _pair(params, model, cfg)
    assert tp._session_spec({"cond_frame_idx": {0}}).temporal_stride == 2
    T = 14
    video, _ = moving_square_video(T=T)
    start = T - 1 if reverse else 0
    js, ts = _session(jp, tp, video, [(start, (1, (16.0 + 3 * start, 28.0)))])
    frames, _ = _propagate(jp, js, tp, ts, reverse=reverse)
    assert len(frames) == T


def test_reset_and_reverse_matches_jax(params, model):
    """``tests/test_predictors.py:168``: a prompt on the last of 4 frames,
    reverse, then ``reset_state`` forgets objects, prompts and outputs."""
    jp, tp = _pair(params, model)
    video, _ = moving_square_video(T=4)
    js, ts = _session(jp, tp, video, [(3, (7, (52.0, 28.0)))])
    frames, masks = _propagate(jp, js, tp, ts, reverse=True)
    assert frames == [3, 2, 1, 0] and tuple(masks.shape) == (4, 1, 1, 16, 16)
    tp.reset_state(ts)
    assert ts["obj_ids"] == [] and not ts["frames_tracked"] and not ts["last_masks"]
    assert not ts["tracked"] and not ts["cond_frame_idx"]


def test_segmented_edge_cases_match_jax(params, model):
    """``tests/test_predictors.py:318``: consecutive cond frames 2, 3 and 0;
    reverse from a mid-video prompt; ``max_frame_num_to_track`` forward (the
    order spans max + 1 frames) and in reverse; reverse from frame 0 is
    empty."""
    jp, tp = _pair(params, model, max_cond_frames=3)
    video, _ = moving_square_video(T=7)
    js, ts = _session(jp, tp, video, [(f, (1, (16.0 + 4 * f, 28.0))) for f in (0, 2, 3)])
    frames, _ = _propagate(jp, js, tp, ts, what="cond 0, 2, 3")
    assert frames == list(range(7))

    js, ts = _session(jp, tp, video, [(4, (1, (32.0, 28.0)))])
    frames, _ = _propagate(jp, js, tp, ts, what="reverse from 4", reverse=True)
    assert frames == [4, 3, 2, 1, 0]

    js, ts = _session(jp, tp, video, [(1, (1, (20.0, 28.0)))])
    frames, _ = _propagate(jp, js, tp, ts, what="max 3", max_frame_num_to_track=3)
    assert frames == [1, 2, 3, 4]

    js, ts = _session(jp, tp, video, [(5, (1, (36.0, 28.0)))])
    frames, _ = _propagate(jp, js, tp, ts, what="reverse max 2", reverse=True,
                           max_frame_num_to_track=2)
    assert frames == [5, 4, 3]

    js, ts = _session(jp, tp, video, [(0, (1, (16.0, 28.0)))])
    frames, masks = tp.propagate_in_video_batch(ts, reverse=True)
    assert frames == [] and masks.shape[0] == 0
    assert jp.propagate_in_video_batch(js, reverse=True)[0] == []


def test_bidirectional_and_resumed_sessions_match_jax(params, model):
    """A prompt on frame 4 of 10: forward, then reverse from frame 4 (the
    frames tracked forward are re-encoded into the ring first); and a
    session tracked to frame 3 that resumes at frame 4 (its ring rebuilt from
    frames 1-3), with the retained outputs offloaded to the host."""
    jp, tp = _pair(params, model)
    video, _ = moving_square_video(T=10)
    js, ts = _session(jp, tp, video, [(4, (1, (32.0, 28.0)))])
    frames, _ = _propagate(jp, js, tp, ts, what="forward")
    assert frames == list(range(4, 10))
    frames, _ = _propagate(jp, js, tp, ts, what="reverse", reverse=True)
    assert frames == [4, 3, 2, 1, 0]
    assert ts["frames_tracked"] == {**{f: True for f in range(5)},
                                    **{f: False for f in range(5, 10)}}
    bank, window = tp._reconstruct_ring(ts, ts["images"], tp._make_bank(
        tp._session_spec(ts), 1), 4, True, tp._session_spec(ts))
    assert window == [5, 6, 7, 8, 9]

    js = jp.init_state(images=video, offload_state_to_cpu=True)
    ts = tp.init_state(images=video, offload_state_to_cpu=True)
    for p, s in ((jp, js), (tp, ts)):
        p.add_new_points(s, 0, 1, PT, ONE)
    frames, _ = _propagate(jp, js, tp, ts, what="to frame 3", max_frame_num_to_track=3)
    assert frames == [0, 1, 2, 3]
    assert isinstance(ts["last_masks"][2][0], np.ndarray)
    frames, _ = _propagate(jp, js, tp, ts, what="resume", start_frame_idx=4)
    assert frames == list(range(4, 10))


def test_for_eval_fills_holes_and_separates_objects_like_jax(params, model):
    """``for_eval``: binarised interacted-frame masks for the memory
    encoder, holes up to area 8 filled, the cross-object non-overlap
    constraint; two objects, video-resolution masks of
    ``propagate_in_video`` against JAX's, and hole filling seen to act."""
    jp = JV.SAM2VideoPredictor.for_eval(params, TINY, max_cond_frames=2)
    tp = TV.SAM2VideoPredictor.for_eval(model, max_cond_frames=2)
    assert tp.cfg.binarize_mask_from_pts_for_mem_enc and tp.model.cfg is tp.cfg
    assert not model.cfg.binarize_mask_from_pts_for_mem_enc       # the caller's model kept
    assert tp.fill_hole_area == 8 and tp.non_overlap_masks
    video, _ = moving_square_video(T=5, size=80)
    js, ts = _session(jp, tp, video, [(0, (1, (20.0, 35.0))), (0, (2, (60.0, 60.0)))])
    got = list(tp.propagate_in_video(ts))
    want = list(jp.propagate_in_video(js))
    assert len(got) == len(want) == 5
    for (f, ids, m), (jf, jids, jm) in zip(got, want):
        assert (f, ids) == (jf, jids) and ids == [1, 2]
        assert tuple(m.shape) == (2, 1, 80, 80)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL, err_msg=f"frame {f}")
    # a 3-pixel hole inside a positive region is filled, a 9-pixel one is not
    logits = torch.ones(1, 1, 12, 12)
    logits[0, 0, 2, 2:5] = -1.0
    logits[0, 0, 6:9, 6:9] = -1.0
    filled = TV.fill_holes_in_mask_scores(logits, tp.fill_hole_area)
    assert (filled[0, 0, 2, 2:5] == 0.1).all() and (filled[0, 0, 6:9, 6:9] == -1.0).all()


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    Image = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("frames")
    video, _ = moving_square_video(T=5, size=72)
    for t in range(video.shape[0]):
        Image.fromarray((video[t] * 255).astype(np.uint8)).save(d / f"{t}.jpg")
    return str(d)


def test_frame_directory_sessions_match_jax(params, model, jpeg_dir):
    """``tests/test_video_loading.py:30-60``: a JPEG directory loaded
    synchronously, asynchronously (the session starts before the frames are
    decoded) and with the video offloaded to the host, against JAX's
    synchronous session."""
    jp, tp = _pair(params, model)
    js = jp.init_state(video_path=jpeg_dir)
    jp.add_new_points(js, 0, 1, PT, ONE)
    jf, jm = jp.propagate_in_video_batch(js)
    for kw in (dict(), dict(async_loading_frames=True), dict(offload_video_to_cpu=True),
               dict(async_loading_frames=True, offload_video_to_cpu=True)):
        ts = tp.init_state(video_path=jpeg_dir, **kw)
        assert (ts["num_frames"], ts["video_height"], ts["video_width"]) == (5, 72, 72)
        if kw.get("async_loading_frames"):
            assert ts["images"] is None and ts["async_loader"] is not None
        tp.add_new_points(ts, 0, 1, PT, ONE)
        tf, tm = tp.propagate_in_video_batch(ts)
        _same(tf, tm, jf, jm, str(kw))
        assert ts["async_loader"] is None
        assert isinstance(ts["images"], np.ndarray) == bool(kw.get("offload_video_to_cpu"))
    np.testing.assert_allclose(
        TV._load_video_frames_dir(jpeg_dir, 64)[0], np.asarray(js["images"]), atol=1e-6)
