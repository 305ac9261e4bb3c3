"""Minimal numpy NIfTI-1 reader / writer and the raw-CT volume dataset
(counterpart of ``medsam2_tpu/data/nifti.py``).

The BTCV / AMOS raw distributions ship as ``imagesTr/<case>.nii.gz`` +
``labelsTr/<case>.nii.gz`` CT volumes (the reference repo consumes a
preprocessed jpg/npy slice-dir export instead, ``func_3d/dataset/btcv.py``).
NIfTI-1 is a 348-byte header and raw Fortran-order voxels, optionally
gzipped, so the reader needs only numpy, ``struct`` and ``gzip``.

Supports: .nii and .nii.gz single-file NIfTI-1, both endiannesses, the
common datatypes, and scl_slope/scl_inter intensity scaling. 4-D volumes
return the first timepoint. PIL is imported when a volume's slices are
resized.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from medsam2_tpu_torch.data.btcv import BTCV

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
}


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def load_nifti(path: str, apply_scaling: bool = True) -> Tuple[np.ndarray, Dict]:
    """Read a NIfTI-1 file -> (voxels [X, Y, Z] (or [X, Y, Z, T]), header dict).

    Voxels keep the on-disk Fortran axis order (X fastest), matching nibabel's
    ``get_fdata`` axis convention.
    """
    raw = _read_bytes(path)
    if len(raw) < 352:
        raise ValueError(f"{path}: not a NIfTI-1 file (too short)")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    bo = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack(">i", raw[0:4])
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: bad sizeof_hdr")
        bo = ">"
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(bo + "8h", raw[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(max(int(d), 1) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack(bo + "h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype code {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    (scl_slope,) = struct.unpack(bo + "f", raw[112:116])
    (scl_inter,) = struct.unpack(bo + "f", raw[116:120])
    (vox_offset,) = struct.unpack(bo + "f", raw[108:112])
    pixdim = struct.unpack(bo + "8f", raw[76:108])

    offset = int(vox_offset) if magic[:3] == b"n+1" else 0
    if magic[:3] == b"ni1":
        raise ValueError(f"{path}: two-file (.hdr/.img) NIfTI not supported")
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    vol = data.reshape(shape, order="F")
    # NIfTI-1 rule: scl_slope == 0 means NO scaling at all (inter included)
    if (apply_scaling and scl_slope != 0.0
            and (scl_slope != 1.0 or scl_inter != 0.0)):
        vol = vol.astype(np.float32) * scl_slope + scl_inter
    header = {
        "shape": shape, "datatype": datatype, "pixdim": pixdim[1:1 + ndim],
        "scl_slope": scl_slope, "scl_inter": scl_inter, "byteorder": bo,
    }
    return np.asarray(vol), header


def save_nifti(path: str, vol: np.ndarray, pixdim=None):
    """Write a minimal single-file NIfTI-1 (.nii or .nii.gz), for tests and
    fixtures (no orientation/affine metadata)."""
    code = {np.dtype(v): k for k, v in _DTYPES.items()}[np.dtype(vol.dtype)]
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)
    pd = [1.0] + list(pixdim or [1.0] * vol.ndim) + [0.0] * (7 - vol.ndim)
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.asfortranarray(vol).tobytes(order="F")
    if path.endswith(".gz"):
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(payload)


def ct_window(vol: np.ndarray, center: float = 40.0, width: float = 400.0) -> np.ndarray:
    """Hounsfield windowing -> uint8 [0, 255] (default: soft-tissue window)."""
    lo, hi = center - width / 2.0, center + width / 2.0
    v = np.clip(vol.astype(np.float32), lo, hi)
    return ((v - lo) / max(hi - lo, 1e-6) * 255.0).astype(np.uint8)


class NiftiVolumes(BTCV):
    """BTCV-contract dataset over raw ``imagesTr/<case>.nii.gz`` +
    ``labelsTr/<case>.nii.gz`` CT volumes: slices the axial (last spatial)
    axis into frames, Hounsfield-windows intensities, and inherits the
    reference's trimming / windowing / prompt sampling from :class:`BTCV`.
    """

    def __init__(self, data_path: str, mode: str = "Training",
                 image_size: int = 1024, video_length: Optional[int] = None,
                 prompt: str = "click", variation: float = 0.0,
                 seed: Optional[int] = None,
                 images_dir: Optional[str] = None,
                 labels_dir: Optional[str] = None,
                 window_center: float = 40.0, window_width: float = 400.0):
        self.data_path = data_path
        self.mode = mode
        self.image_size = image_size
        self.prompt = prompt
        self.variation = variation
        self.rng = np.random.default_rng(seed)
        self.video_length = video_length if mode == "Training" else None
        if images_dir is None:
            # decathlon-style split: imagesTr/labelsTr for training,
            # imagesTs/labelsTs for test WHEN present. Falling back to the
            # training directories for eval would silently report metrics on
            # the training volumes, so a missing test split is an error.
            if mode == "Training":
                images_dir, labels_dir = "imagesTr", "labelsTr"
            elif os.path.isdir(os.path.join(data_path, "imagesTs")):
                images_dir, labels_dir = "imagesTs", "labelsTs"
            else:
                raise FileNotFoundError(
                    f"{data_path}: no imagesTs/ split for mode={mode!r}; pass "
                    "images_dir/labels_dir explicitly to evaluate on another "
                    "directory")
        self.images_dir = os.path.join(data_path, images_dir)
        self.labels_dir = os.path.join(data_path, labels_dir or "labelsTr")
        self.window_center = window_center
        self.window_width = window_width
        self.name_list = sorted(
            n for n in os.listdir(self.images_dir)
            if n.endswith((".nii", ".nii.gz")))

    def _load_volume(self, name):
        from PIL import Image

        vol, _ = load_nifti(os.path.join(self.images_dir, name))
        seg, _ = load_nifti(os.path.join(self.labels_dir, name))

        def _to_3d(a, role):
            # 5-D+ files (e.g. time x vector dims) pass the reader's ndim<=7
            # check; squeeze trailing singletons, take the first component of
            # a 4th axis, and reject anything still above 3-D with a clear
            # message instead of a confusing slicing shape error downstream.
            while a.ndim > 3 and a.shape[-1] == 1:
                a = a[..., 0]
            if a.ndim == 4:
                a = a[..., 0]
            if a.ndim != 3:
                raise ValueError(
                    f"{name}: unsupported {role} ndim {a.ndim} "
                    f"(shape {a.shape}); expected a 3-D volume")
            return a

        vol = _to_3d(vol, "image")
        seg = _to_3d(seg, "label")
        seg = seg.astype(np.int32)                      # [X, Y, Z]
        gray = ct_window(vol, self.window_center, self.window_width)

        # trim empty leading/trailing slices (reference btcv.py:49-57)
        nz = [i for i in range(seg.shape[-1]) if seg[..., i].sum() > 0]
        start, end = (nz[0], nz[-1]) if nz else (0, seg.shape[-1] - 1)
        seg = seg[..., start:end + 1]
        imgs = []
        for i in range(start, end + 1):
            img = Image.fromarray(gray[..., i]).convert("RGB")
            img = img.resize((self.image_size, self.image_size))
            imgs.append(np.asarray(img, np.float32))
        return np.stack(imgs), seg
