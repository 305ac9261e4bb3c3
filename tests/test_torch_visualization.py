"""The port's figures (``medsam2_tpu_torch/utils/visualization.py``) against
the JAX package's (mirrors ``tests/test_visualization.py``): the numpy
helpers give equal arrays on seeded inputs; the matplotlib dumps write
files, and the vis_compare_point image equals JAX's byte for byte (both
draw the same uint8 array through ``plt.imsave``)."""

import numpy as np
import pytest

from medsam2_tpu.utils import visualization as JV
from medsam2_tpu_torch.utils import visualization as TV

SEEDS = (0, 1)


def _inputs(seed, size=24):
    rng = np.random.default_rng(seed)
    img = rng.random((size, size, 3)).astype(np.float32)
    pred = rng.random((size, size)) > 0.6
    gt = rng.random((size, size)) > 0.5
    inst = rng.integers(0, 7, (size, size))
    pts = rng.uniform(-4, size + 4, (6, 2))
    return img, pred, gt, inst, pts


@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_helpers_equal_jax(seed):
    img, pred, gt, inst, pts = _inputs(seed)
    np.testing.assert_array_equal(TV.instance_colormap(inst, seed=seed),
                                  JV.instance_colormap(inst, seed=seed))
    np.testing.assert_array_equal(TV.instance_colormap(np.zeros((4, 4), int)),
                                  JV.instance_colormap(np.zeros((4, 4), int)))
    for image in (img, img * 255.0):
        np.testing.assert_array_equal(TV.overlay_mask(image, pred, alpha=0.3),
                                      JV.overlay_mask(image, pred, alpha=0.3))
    np.testing.assert_array_equal(TV.compare_color(pred[None, None], gt),
                                  JV.compare_color(pred[None, None], gt))
    canvas = TV.compare_color(pred, gt)
    for radius in (1, 3):
        np.testing.assert_array_equal(TV.draw_points(canvas, pts, radius=radius),
                                      JV.draw_points(canvas, pts, radius=radius))


def test_compare_color_quadrants():
    pred = np.zeros((4, 4), np.float32)
    gt = np.zeros((4, 4), np.float32)
    pred[0, 0] = 1
    gt[1, 1] = 1
    pred[2, 2] = gt[2, 2] = 1
    out = TV.compare_color(pred, gt)
    assert [tuple(out[i, i]) for i in range(4)] == [(255, 0, 0), (0, 0, 255), (0, 255, 0),
                                                    (0, 0, 0)]


def test_dumps_write_files(tmp_path):
    pytest.importorskip("matplotlib")
    img, pred, gt, inst, pts = _inputs(0)
    got, want = tmp_path / "port_cmp.png", tmp_path / "jax_cmp.png"
    TV.vis_compare_point(pred, gt, pts, str(got))
    JV.vis_compare_point(pred, gt, pts, str(want))
    assert got.read_bytes() == want.read_bytes()
    p2 = tmp_path / "a" / "img.png"
    TV.vis_image(img.transpose(2, 0, 1) * 255.0, pred, gt, str(p2), points=pts)
    p3 = tmp_path / "inst.png"
    TV.vis_inst_image(img, inst, str(p3), points=pts)
    for p in (p2, p3):
        assert p.exists() and p.stat().st_size > 0
