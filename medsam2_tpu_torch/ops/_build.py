"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes` (pointers and the
stream pass as ``c_void_p``). The build runs at first use, into
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of the
sources and flags, so an unchanged tree reuses its library. ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is kept
beside the library as ``ptxas.log``.

A missing ``nvcc`` or a failed build raises; nothing falls back to the plain
PyTorch twins.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmedsam2_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc on PATH or /usr/local/cuda/bin/nvcc)")


def _sources():
    cu = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu, headers


def _source_hash(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this tree's sources were not built yet; returns
    the library path. Each ``.cu`` compiles in its own ``nvcc`` process, in
    parallel, then one link."""
    cu, headers = _sources()
    out_dir = BUILD_ROOT / _source_hash(cu + headers)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = []
    failed = []
    for src, _, p in procs:
        out, err = p.communicate()
        logs.append(f"== {src.name}\n{out}{err}")
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{err}")
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(str(build()))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.medsam2_flash_attention_fwd
    fn.argtypes = [vp] * 8 + [i] * 6 + [f, i, i, vp]
    fn.restype = i
    fn = lib.medsam2_attention_merge
    fn.argtypes = [vp] * 4 + [i] * 3 + [vp]
    fn.restype = i
    fn = lib.medsam2_flash_attention_bwd_dkv
    fn.argtypes = [vp] * 11 + [i] * 7 + [f, i, i, vp]
    fn.restype = i
    fn = lib.medsam2_flash_attention_bwd_dkv_sum
    fn.argtypes = [vp] * 4 + [i] * 4 + [f, vp]
    fn.restype = i
    fn = lib.medsam2_flash_attention_bwd_dq
    fn.argtypes = [vp] * 9 + [i] * 7 + [f, i, i, vp]
    fn.restype = i
    fn = lib.medsam2_flash_attention_bwd_dq_sum
    fn.argtypes = [vp, vp, i, i, i, f, vp]
    fn.restype = i
    fn = lib.medsam2_kv_cached_attention_fwd
    fn.argtypes = [vp] * 11 + [i] * 10 + [f, i, i, vp]
    fn.restype = i
    fn = lib.medsam2_window_attention_fwd
    fn.argtypes = [vp, vp, i, i, i, i, i, i, f, i, vp]
    fn.restype = i
    fn = lib.medsam2_fused_mlp_fwd
    fn.argtypes = [vp] * 9 + [i, i, i, f, i, vp]
    fn.restype = i
    fn = lib.medsam2_fused_mlp_launches
    fn.argtypes = [i, i, i]
    fn.restype = i
    fn = lib.medsam2_encoder_layer_norm
    fn.argtypes = [vp] * 4 + [i, i, f, i, vp]
    fn.restype = i
    fn = lib.medsam2_linear_tile_n
    fn.argtypes = [i] * 4
    fn.restype = i
    fn = lib.medsam2_encoder_linear
    fn.argtypes = [vp] * 5 + [i] * 5 + [vp]
    fn.restype = i
    fn = lib.medsam2_fused_block_fwd
    fn.argtypes = [vp] * 15 + [i, i, i, i, f, i, vp]
    fn.restype = i
    return lib
