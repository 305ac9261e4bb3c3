"""The port's NIfTI reader / writer and raw-CT dataset
(``medsam2_tpu_torch/data/nifti.py``) against the JAX package's (mirrors
``tests/test_nifti.py``): files written by either package read equal by the
other, big-endian files with intensity scaling, ``ct_window``, and
``NiftiVolumes`` samples equal to JAX's with the same seed (images, masks
and prompts, exactly). Then ``-dataset btcv_nifti`` (and ``-vis``) through
the port's ``cli/train_3d`` on a two-case directory at TINY, one step."""

import os
import struct

import numpy as np
import pytest
import torch

from medsam2_tpu.data import nifti as JN
from medsam2_tpu_torch.data import nifti as TN
from tests.test_predictors import TINY

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype,suffix", [(np.int16, ".nii"), (np.float32, ".nii.gz"),
                                          (np.uint8, ".nii.gz"), (np.float64, ".nii")])
def test_files_cross_read(tmp_path, dtype, suffix):
    rng = np.random.default_rng(0)
    vol = (rng.random((7, 6, 5)) * 100).astype(dtype)
    for write, read, tag in ((JN.save_nifti, TN.load_nifti, "j2t"),
                             (TN.save_nifti, JN.load_nifti, "t2j")):
        p = str(tmp_path / f"{tag}{suffix}")
        write(p, vol, pixdim=(1.5, 1.5, 3.0))
        back, hdr = read(p)
        np.testing.assert_array_equal(back, vol)
        assert back.dtype == vol.dtype
        assert hdr["shape"] == vol.shape
        assert hdr["pixdim"][2] == pytest.approx(3.0)
    if suffix == ".nii":          # gzip stamps the time, so only plain files equal
        assert (tmp_path / "j2t.nii").read_bytes() == (tmp_path / "t2j.nii").read_bytes()


def test_big_endian_and_scaling(tmp_path):
    rng = np.random.default_rng(1)
    vol = (rng.random((4, 3, 2)) * 50).astype(np.int16)
    hdr = bytearray(352)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, 4, 3, 2, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 4)
    struct.pack_into(">h", hdr, 72, 16)
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">f", hdr, 112, 2.0)
    struct.pack_into(">f", hdr, 116, -10.0)
    hdr[344:348] = b"n+1\x00"
    p = str(tmp_path / "be.nii")
    with open(p, "wb") as f:
        f.write(bytes(hdr) + vol.astype(">i2").tobytes(order="F"))
    got, h = TN.load_nifti(p)
    want, _ = JN.load_nifti(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, vol.astype(np.float32) * 2.0 - 10.0)
    assert h["byteorder"] == ">"
    raw, _ = TN.load_nifti(p, apply_scaling=False)
    np.testing.assert_array_equal(raw, vol)
    with open(p, "wb") as f:
        f.write(b"\0" * 400)
    with pytest.raises(ValueError, match="sizeof_hdr"):
        TN.load_nifti(p)


def test_ct_window():
    v = np.linspace(-1200.0, 3000.0, 97)
    for center, width in ((40.0, 400.0), (50.0, 350.0), (-600.0, 1500.0)):
        np.testing.assert_array_equal(TN.ct_window(v, center, width),
                                      JN.ct_window(v, center, width))
    w = TN.ct_window(np.array([-1000.0, -160.0, 240.0, 3000.0]))
    assert w.tolist() == [0, 0, 255, 255]


def _write_cases(root, rng, cases=("a", "b"), test_split=True):
    splits = [("imagesTr", "labelsTr")] + ([("imagesTs", "labelsTs")] if test_split else [])
    for imgs, lbls in splits:
        os.makedirs(root / imgs)
        os.makedirs(root / lbls)
    for case in cases:
        vol = (rng.random((24, 24, 10)) * 400 - 160).astype(np.float32)
        seg = np.zeros((24, 24, 10), np.uint8)
        seg[6:18, 6:18, 2:8] = 1
        seg[18:22, 2:8, 3:6] = 2
        for imgs, lbls in splits:
            TN.save_nifti(str(root / imgs / f"{case}.nii.gz"), vol)
            TN.save_nifti(str(root / lbls / f"{case}.nii.gz"), seg)


def _same_sample(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["image"], want["image"])
    for key in ("label", "pt", "p_label", "bbox"):
        if key not in want:
            continue
        assert set(got[key]) == set(want[key]), key
        for t in want[key]:
            assert set(got[key][t]) == set(want[key][t]), (key, t)
            for obj in want[key][t]:
                np.testing.assert_array_equal(got[key][t][obj], want[key][t][obj])
    assert got["image_meta_dict"] == want["image_meta_dict"]


@pytest.mark.parametrize("prompt", ["click", "bbox"])
def test_nifti_volumes_match_jax(tmp_path, prompt):
    _write_cases(tmp_path, np.random.default_rng(2), test_split=False)
    kw = dict(mode="Training", image_size=32, video_length=4, prompt=prompt, seed=3)
    got = TN.NiftiVolumes(str(tmp_path), **kw)
    want = JN.NiftiVolumes(str(tmp_path), **kw)
    assert got.name_list == want.name_list == ["a.nii.gz", "b.nii.gz"]
    for i in (0, 1, 0):           # the shared generator advances alike
        _same_sample(got[i], want[i])
    imgs, seg = got._load_volume("a.nii.gz")
    assert imgs.shape == (6, 32, 32, 3) and seg.shape[-1] == 6   # slices 2..7
    # evaluation needs an imagesTs split: no silent fall back to training volumes
    with pytest.raises(FileNotFoundError, match="imagesTs"):
        TN.NiftiVolumes(str(tmp_path), mode="Test", image_size=32)


def test_train_3d_cli_btcv_nifti(tmp_path, monkeypatch):
    """One step and one validation from raw .nii.gz volumes, with the
    validation figures of ``-vis``."""
    import medsam2_tpu_torch.cli.train_3d as t3

    root = tmp_path / "data"
    _write_cases(root, np.random.default_rng(4))
    monkeypatch.setattr(t3, "get_config", lambda name, **kw: TINY)
    args = ["-dataset", "btcv_nifti", "-data_path", str(root), "-image_size", "64",
            "-video_length", "4", "-prompt_freq", "2", "-prompt", "bbox", "-max_objects", "2",
            "-epochs", "1", "-steps_per_epoch", "1", "-val_freq", "0", "-b", "1",
            "-print_freq", "1", "-sam_config", "sam2_hiera_t", "-device", "cpu",
            "-logdir", str(tmp_path / "log"), "-vis", "1"]
    model = t3.main(args)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    figures = sorted(tmp_path.glob("log/**/Samples/**/*.png"))
    # one figure per (frame, object) of each validation volume
    assert figures and {f.parent.parent.name for f in figures} == {"a.nii.gz", "b.nii.gz"}
    # amos_nifti reads the same layout
    ds = t3.build_dataset(t3.parse_args(["-dataset", "amos_nifti", "-data_path", str(root),
                                         "-image_size", "64"]), "Test")
    assert isinstance(ds, TN.NiftiVolumes) and len(ds) == 2
