"""The nuclei data, NMS and metrics, JAX package against the PyTorch port,
on the CPU: numpy-seeded inputs through both, compared exactly (floats to
1e-6 where a metric sums in another order).

- ``point_nms_np`` (random points, ties, an empty set);
- ``synthetic_nuclei`` from one ``np.random.Generator`` state;
- ``cell_centers``, and ``MONUSEG`` / ``CPM`` reading a directory the test
  writes (PIL images, scipy ``.mat`` labels) in test and train mode;
- ``pack_nuclei_batch`` at the image size and with a resize (the JAX
  function calls ``ndarray.ptp``, gone in numpy 2: its images go in as an
  ndarray subclass that has it);
- ``metrics.instance`` (AJI, AJI+, PQ at both matching rules, Dice 1 / 2,
  ``remap_label``, ``pair_coordinates``) and ``metrics.detection``
  (``average_precision``, ``tpfp_points``, ``eval_map``)."""

import os

import numpy as np
import pytest

from medsam2_tpu.data import monuseg as JM
from medsam2_tpu.data import synthetic as JS
from medsam2_tpu.metrics import detection as JDET
from medsam2_tpu.metrics import instance as JI
from medsam2_tpu.ops.nms import point_nms_np as jax_point_nms
from medsam2_tpu_torch.data import monuseg as TM
from medsam2_tpu_torch.data import synthetic as TS
from medsam2_tpu_torch.metrics import detection as TDET
from medsam2_tpu_torch.metrics import instance as TI
from medsam2_tpu_torch.ops.nms import point_nms_np


def _same(a, b):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("seed,n,dist", [(0, 50, 12.0), (1, 200, 12.0), (2, 120, 30.0),
                                         (3, 1, 12.0), (4, 0, 12.0)])
def test_point_nms_matches_jax(seed, n, dist):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 256, (n, 2)).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    want = jax_point_nms(pts, scores, dist)
    got = point_nms_np(pts, scores, dist)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_point_nms_ties_and_lattice():
    """Equal scores keep the first index; points on a 12-px lattice (exactly
    the threshold apart) are not suppressed."""
    pts = np.array([[0, 0], [5, 0], [12, 0], [24, 0], [30, 0]], np.float32)
    scores = np.full(5, 0.5, np.float32)
    for dist in (12.0, 6.0):
        np.testing.assert_array_equal(point_nms_np(pts, scores, dist),
                                      jax_point_nms(pts, scores, dist))
    np.testing.assert_array_equal(point_nms_np(pts, scores, 12.0), [0, 2, 3])


@pytest.mark.parametrize("size,cells", [(64, 6), (256, 24), (96, 40)])
def test_synthetic_nuclei_matches_jax(size, cells):
    ja, ta = np.random.default_rng(size), np.random.default_rng(size)
    for _ in range(2):
        _same(JS.synthetic_nuclei(ja, size, cells), TS.synthetic_nuclei(ta, size, cells))


def test_cell_centers_match_jax():
    s = TS.synthetic_nuclei(np.random.default_rng(0), 128, 20)
    inst = s["inst_map"].copy()
    inst[40:60, 40:44] = 99                     # a bar: its center lies inside it
    yy, xx = np.mgrid[0:128, 0:128]
    ring = (((yy - 100) ** 2 + (xx - 30) ** 2) < 100) & (((yy - 100) ** 2 + (xx - 30) ** 2) > 40)
    inst[ring] = 77                             # a ring: its center snaps to the nearest pixel
    pids = np.unique(inst)[1:]
    np.testing.assert_array_equal(TM.cell_centers(inst, pids), JM.cell_centers(inst, pids))
    assert TM.cell_centers(inst, pids[:0]).shape == (0, 2)


def _write_monuseg(root, mode, image_dir, label_dir, n=2, size=48):
    import scipy.io as sio
    from PIL import Image

    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, mode, image_dir))
    os.makedirs(os.path.join(root, mode, label_dir))
    for i in range(n):
        s = TS.synthetic_nuclei(rng, size, 8)
        img = (s["image"] * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, mode, image_dir, f"case{i}.png"))
        sio.savemat(os.path.join(root, mode, label_dir, f"case{i}.mat"),
                    {"inst_map": s["inst_map"]})


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("kind", ["MONUSEG", "CPM"])
def test_monuseg_reader_matches_jax(tmp_path, mode, kind):
    jcls, tcls = getattr(JM, kind), getattr(TM, kind)
    _write_monuseg(str(tmp_path), mode, tcls.image_dirname, tcls.label_dirname)
    jds = jcls(str(tmp_path), mode, 48, 48, num_mask_per_img=5, seed=3)
    tds = tcls(str(tmp_path), mode, 48, 48, num_mask_per_img=5, seed=3)
    assert len(tds) == len(jds) == 2
    for i in range(2):
        _same(jds[i], tds[i])
    if mode == "train":
        # the training augmentation (crop 32 of the 48-px tiles), drawn
        # from the reader's generator in the same order
        jds = jcls(str(tmp_path), mode, 32, 32, num_mask_per_img=5, seed=4, augment=True)
        tds = tcls(str(tmp_path), mode, 32, 32, num_mask_per_img=5, seed=4, augment=True)
        for i in range(2):
            got = tds[i]
            assert got["image"].shape == (32, 32, 3)
            _same(jds[i], got)


class _PtpArray(np.ndarray):
    """An ndarray with numpy 1's ``ptp`` method, for the JAX package's
    resize branch."""

    def ptp(self, *a, **k):
        return np.ptp(np.asarray(self), *a, **k)


@pytest.mark.parametrize("image_size,out_size,max_cells", [(48, 48, 8), (64, 32, 3)])
def test_pack_nuclei_batch_matches_jax(image_size, out_size, max_cells):
    rng = np.random.default_rng(11)
    samples = []
    for _ in range(2):
        s = TS.synthetic_nuclei(rng, 48, 6)
        samples.append(s)
    jsamples = [{**s, "image": s["image"].view(_PtpArray)} for s in samples]
    _same(JM.pack_nuclei_batch(jsamples, image_size, out_size, max_cells),
          TM.pack_nuclei_batch(samples, image_size, out_size, max_cells))


def _maps(seed):
    """A GT instance map and a prediction that shifts, merges, splits and
    misses cells, with non-contiguous ids."""
    rng = np.random.default_rng(seed)
    gt = TS.synthetic_nuclei(rng, 96, 14)["inst_map"]
    pred = np.roll(gt, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))), axis=(0, 1)) * 3
    ids = np.unique(pred)[1:]
    pred[pred == ids[0]] = 0                          # a missed cell
    if len(ids) > 2:
        pred[pred == ids[1]] = ids[2]                 # two cells merged
    ys, xs = np.nonzero(pred == ids[-1])
    pred[ys[: len(ys) // 2], xs[: len(xs) // 2]] = 500  # one split in two
    pred[5:12, 80:90] = 777                           # a false positive
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instance_metrics_match_jax(seed):
    gt, pred = _maps(seed)
    for remap in (False, True):
        g, p = (JI.remap_label(gt), JI.remap_label(pred)) if remap else (gt, pred)
        for fn in ("get_fast_aji", "get_fast_aji_plus", "get_fast_dice_2", "get_dice_1"):
            want, got = getattr(JI, fn)(g, p), getattr(TI, fn)(g, p)
            assert abs(got - want) <= 1e-6, (fn, got, want)
        for match_iou in (0.5, 0.3):
            (wq, wl), (gq, gl) = JI.get_fast_pq(g, p, match_iou), TI.get_fast_pq(g, p, match_iou)
            np.testing.assert_allclose(gq, wq, atol=1e-6)
            assert gl == wl
    for by_size in (False, True):
        np.testing.assert_array_equal(TI.remap_label(pred, by_size), JI.remap_label(pred, by_size))


def test_instance_metrics_empty_maps_match_jax():
    gt, pred = _maps(3)
    empty = np.zeros_like(gt)
    for a, b in ((gt, empty), (empty, pred), (empty, empty)):
        for fn in ("get_fast_aji", "get_fast_aji_plus", "get_fast_dice_2", "get_dice_1"):
            assert getattr(TI, fn)(a, b) == getattr(JI, fn)(a, b)
        assert TI.get_fast_pq(a, b) == JI.get_fast_pq(a, b)


@pytest.mark.parametrize("radius", [4.0, 12.0])
def test_pair_coordinates_matches_jax(radius):
    rng = np.random.default_rng(int(radius))
    a, b = rng.uniform(0, 64, (15, 2)), rng.uniform(0, 64, (12, 2))
    for x, y in ((a, b), (a, b[:0]), (a[:0], b)):
        for got, want in zip(TI.pair_coordinates(x, y, radius), JI.pair_coordinates(x, y, radius)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_average_precision_matches_jax(mode):
    rng = np.random.default_rng(5)
    rec = np.sort(rng.random((3, 20)), axis=1).astype(np.float32)
    prec = rng.random((3, 20)).astype(np.float32)
    np.testing.assert_allclose(TDET.average_precision(rec, prec, mode),
                               JDET.average_precision(rec, prec, mode), atol=1e-6)
    np.testing.assert_allclose(TDET.average_precision(rec[0], prec[0], mode),
                               JDET.average_precision(rec[0], prec[0], mode), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_tpfp_and_eval_map_match_jax(seed):
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for n_det, n_gt in ((30, 20), (12, 0), (0, 5), (25, 25)):
        gt = rng.uniform(0, 200, (n_gt, 2))
        near = gt[rng.integers(0, max(n_gt, 1), n_det)] if n_gt else np.zeros((n_det, 2))
        det = np.concatenate([near + rng.normal(0, 12, (n_det, 2)),
                              rng.random((n_det, 1))], axis=1)
        dets.append(det)
        gts.append(gt)
        for got, want in zip(TDET.tpfp_points(det, gt), JDET.tpfp_points(det, gt)):
            np.testing.assert_array_equal(got, want)
    (gap, gstats), (wap, wstats) = TDET.eval_map(dets, gts), JDET.eval_map(dets, gts)
    assert abs(gap - wap) <= 1e-6 and wap > 0
    assert set(gstats) == set(wstats)
    for k in wstats:
        np.testing.assert_allclose(gstats[k], wstats[k], atol=1e-6, err_msg=k)
