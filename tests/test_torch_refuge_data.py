"""The REFUGE data path, JAX package against the PyTorch port, on the CPU:
``synthetic_fundus`` from one ``np.random.Generator`` seed gives identical
arrays, and ``REFUGE`` + ``pack_refuge_batch`` read a two-case
``Training-400`` directory that the test writes with PIL (image and seven
rater cup masks per case) into identical samples and batches, at the image
size and at a smaller output size. Compared exactly."""

import os

import numpy as np
import pytest

from medsam2_tpu.data import refuge as JR
from medsam2_tpu.data import synthetic as JS
from medsam2_tpu_torch.data import refuge as TR
from medsam2_tpu_torch.data import synthetic as TS


def _same_sample(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            assert a[key] == b[key]
        else:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("size", [64, 96])
def test_synthetic_fundus_matches_jax(size):
    ja, ta = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        _same_sample(JS.synthetic_fundus(ja, size), TS.synthetic_fundus(ta, size))


def _write_refuge(root, n_cases=2, size=40):
    from PIL import Image

    rng = np.random.default_rng(11)
    base = os.path.join(root, "Training-400")
    for c in range(n_cases):
        name = f"g{c:04d}"
        d = os.path.join(base, name)
        os.makedirs(d)
        img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, name + "_cropped.jpg"))
        yy, xx = np.mgrid[0:size, 0:size]
        for r in range(1, 8):
            rad = size * (0.15 + 0.02 * r)
            cup = ((yy - size / 2 - c) ** 2 + (xx - size / 2) ** 2) <= rad ** 2
            Image.fromarray((cup * 255).astype(np.uint8)).save(
                os.path.join(d, f"{name}_seg_cup_{r}_cropped.jpg"))


@pytest.mark.parametrize("image_size,out_size", [(64, 64), (64, 32)])
def test_refuge_reader_and_pack_match_jax(tmp_path, image_size, out_size):
    _write_refuge(str(tmp_path))
    jds = JR.REFUGE(str(tmp_path), "Training", image_size, out_size, seed=5)
    tds = TR.REFUGE(str(tmp_path), "Training", image_size, out_size, seed=5)
    assert len(tds) == len(jds) == 2
    js, ts = [jds[i] for i in range(2)], [tds[i] for i in range(2)]
    for a, b in zip(js, ts):
        _same_sample(a, b)
        assert b["image"].shape == (3, image_size, image_size)
        assert b["mask"].shape == (1, out_size, out_size)
        assert b["multi_rater"].shape == (7, 1, image_size, image_size)
        assert b["p_label"] == 1 and b["mask_ori"].sum() > 0
    jb = JR.pack_refuge_batch(js, image_size, out_size)
    tb = TR.pack_refuge_batch(ts, image_size, out_size)
    _same_sample(jb, tb)
    assert tb["labels"][:, 1:].max() == -1 and tb["images"].shape == (2, image_size, image_size, 3)
