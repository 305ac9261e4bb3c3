"""The port's host C++ (counterpart of ``medsam2_tpu/native``): RLE encode /
decode, greedy box NMS, greedy point NMS and the instance-overlap histogram,
bound with :mod:`ctypes`.

``postproc.cpp`` is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use into ``build/native/<hash>/`` at the root of the checkout, keyed
by a hash of the source and flags (never its mtime, which a fresh checkout
resets), and never into the package directory. A missing ``g++`` or a
failed build raises, as the CUDA build does: nothing falls back to numpy.
The numpy versions beside the callers (``ops/nms.nms_np``,
``point_nms_np``, ``postproc/amg_utils.mask_to_rle_np``) are the tests'
oracles. No machine-specific flags (``-march=native``): the library may be
cached across machines.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "postproc.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libpostproc.so"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build() -> Path:
    """Compile ``postproc.cpp`` unless this source was built already;
    returns the library path."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host C++ (native/postproc.cpp) needs it")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
    res = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    L = ctypes.CDLL(str(build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i, f = ctypes.c_int, ctypes.c_float
    L.rle_encode.restype = i
    L.rle_encode.argtypes = [u8p, i, i, i32p]
    L.rle_decode.restype = None
    L.rle_decode.argtypes = [i32p, i, i, i, u8p]
    L.greedy_nms.restype = i
    L.greedy_nms.argtypes = [f32p, f32p, i, f, i32p]
    L.point_nms.restype = i
    L.point_nms.argtypes = [f32p, f32p, i, f, i32p]
    L.instance_overlap.restype = None
    L.instance_overlap.argtypes = [i32p, i32p, ctypes.c_int64, i, i, f64p, f64p, f64p]
    return L


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rle_encode(mask: np.ndarray) -> list:
    """Fortran-order RLE counts of one [h, w] mask, starting with the
    background run."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    counts = np.empty(h * w + 2, np.int32)
    n = lib().rle_encode(_ptr(mask, ctypes.c_uint8), h, w, _ptr(counts, ctypes.c_int32))
    return counts[:n].tolist()


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Inverse of :func:`rle_encode`: a bool [h, w] mask."""
    c = np.ascontiguousarray(counts, np.int32)
    out = np.empty((h, w), np.uint8)
    lib().rle_decode(_ptr(c, ctypes.c_int32), len(c), h, w, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """Kept box indices by descending score (stable), suppressing IoU >
    ``iou_thr``; boxes [n, 4] xyxy."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(boxes), np.int32)
    n = lib().greedy_nms(_ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
                         len(boxes), iou_thr, _ptr(keep, ctypes.c_int32))
    return keep[:n].astype(np.int64)


def point_nms(points: np.ndarray, scores: np.ndarray, dist_thr: float) -> np.ndarray:
    """Kept point indices by descending score (stable), suppressing points
    strictly closer than ``dist_thr`` (squared fp32 distances)."""
    points = np.ascontiguousarray(points, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(points), np.int32)
    n = lib().point_nms(_ptr(points, ctypes.c_float), _ptr(scores, ctypes.c_float),
                        len(points), dist_thr, _ptr(keep, ctypes.c_int32))
    return keep[:n].astype(np.int64)


def instance_overlap(true_map: np.ndarray, pred_map: np.ndarray, n_t: int, n_p: int):
    """One pass over two label maps with ids in [0, n_t] / [0, n_p]:
    (intersections [n_t, n_p], true areas [n_t], predicted areas [n_p]),
    float64."""
    t = np.ascontiguousarray(true_map, np.int32)
    p = np.ascontiguousarray(pred_map, np.int32)
    inter = np.zeros((n_t, n_p), np.float64)
    ta = np.zeros(n_t, np.float64)
    pa = np.zeros(n_p, np.float64)
    lib().instance_overlap(_ptr(t, ctypes.c_int32), _ptr(p, ctypes.c_int32), t.size, n_t, n_p,
                           _ptr(inter, ctypes.c_double), _ptr(ta, ctypes.c_double),
                           _ptr(pa, ctypes.c_double))
    return inter, ta, pa
