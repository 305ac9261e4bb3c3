"""The port's host C++ (``medsam2_tpu_torch/native``) against the JAX
package's native functions and against the port's numpy versions, on seeded
inputs (mirrors ``tests/test_native.py``). Indices, counts and histograms
are integers: equal, not close. AJI / AJI+ / PQ through the port's metrics
(which take the C++ histogram) against the JAX package's, to 1e-12."""

import numpy as np
import pytest

from medsam2_tpu import native as jax_native
from medsam2_tpu.metrics import instance as JI
from medsam2_tpu_torch import native
from medsam2_tpu_torch.metrics import instance as TI
from medsam2_tpu_torch.ops import nms as TN
from medsam2_tpu_torch.postproc import amg_utils as TA

SEEDS = (0, 1, 2)


def test_build_goes_to_the_build_directory():
    path = native.build()
    assert path.parent.parent == native.BUILD_ROOT
    assert path.name == native.LIB_NAME
    assert not list(native.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("seed", SEEDS)
def test_rle_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(5, 40, 2)
    masks = rng.random((3, h, w)) > rng.random()
    masks[0, 0, 0] = True       # a leading zero count
    masks[1, 0, 0] = False
    got = TA.mask_to_rle(masks)
    assert got == TA.mask_to_rle_np(masks)
    for m, rle in zip(masks, got):
        assert rle["counts"] == jax_native.rle_encode(m)
        np.testing.assert_array_equal(native.rle_decode(rle["counts"], h, w), m)
        np.testing.assert_array_equal(TA.rle_to_mask(rle), m)
    assert TA.mask_to_rle(np.zeros((0, h, w), bool)) == []


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_nms_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    n = 60
    boxes = rng.uniform(0, 50, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 25, (n, 2))
    scores = rng.random(n).astype(np.float32)
    scores[::7] = scores[0]     # ties keep index order
    for thr in (0.3, 0.5, 0.7):
        got = TN.nms(boxes, scores, thr)
        np.testing.assert_array_equal(got, TN.nms_np(boxes, scores, thr))
        np.testing.assert_array_equal(got, jax_native.greedy_nms(boxes, scores, thr))
        idxs = rng.integers(0, 3, n)
        np.testing.assert_array_equal(TN.batched_nms(boxes, scores, idxs, thr),
                                      TN.batched_nms_np(boxes, scores, idxs, thr))
    assert TN.nms(np.zeros((0, 4)), np.zeros(0), 0.5).shape == (0,)
    assert TN.batched_nms(np.zeros((0, 4)), np.zeros(0), np.zeros(0), 0.5).shape == (0,)


@pytest.mark.parametrize("seed", SEEDS)
def test_point_nms_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (80, 2)).astype(np.float32)
    pts[5] = pts[4] + np.float32(12.0)     # on the threshold's edge
    scores = rng.random(80).astype(np.float32)
    for dist in (6.0, 12.0):
        got = TN.point_nms(pts, scores, dist)
        np.testing.assert_array_equal(got, TN.point_nms_np(pts, scores, dist))
        np.testing.assert_array_equal(got, jax_native.point_nms(pts, scores, dist))
    assert TN.point_nms(np.zeros((0, 2)), np.zeros(0), 6.0).shape == (0,)


def _instance_maps(rng, size=64, n=9):
    def paint():
        m = np.zeros((size, size), np.int32)
        for i in range(1, n + 1):
            y, x = rng.integers(0, size - 12, 2)
            h, w = rng.integers(4, 12, 2)
            m[y:y + h, x:x + w] = i
        return m
    return paint(), paint()


@pytest.mark.parametrize("seed", SEEDS)
def test_instance_overlap_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    t, p = (TI.remap_label(m) for m in _instance_maps(rng))
    n_t, n_p = int(t.max()), int(p.max())
    got = native.instance_overlap(t, p, n_t, n_p)
    want = jax_native.instance_overlap(t, p, n_t, n_p)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the numpy loop over the same maps (ids shifted off 1..n takes it)
    inter, _, ta, pa = TI._pairwise_inter_union(t * 2, p * 2)
    for a, b in zip((inter, ta, pa), got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_instance_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    t, p = (TI.remap_label(m) for m in _instance_maps(rng))
    assert abs(TI.get_fast_aji(t, p) - JI.get_fast_aji(t, p)) <= 1e-12
    assert abs(TI.get_fast_aji_plus(t, p) - JI.get_fast_aji_plus(t, p)) <= 1e-12
    (got, _), (want, _) = TI.get_fast_pq(t, p), JI.get_fast_pq(t, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
