"""Drive the PyTorch port's 3D volume propagation on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``medsam2_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch twin at the propagation path's
     shapes, bf16 and fp32, with CUDA-event times of both;
  4. sam2_hiera_t @512 fp32 propagation on the card (kernels) against the same
     seeded model on the CPU (plain twins), low-res logits to 1e-3;
  5. sam2_hiera_t @1024 bf16, 8 frames, 1 object: init_state -> add_new_points
     -> propagate_in_video_batch, exact kernel launch counts, ms per tracked
     frame and peak memory.
Then one JSON line of per-kernel results and, last, the device line. Any
failure raises and exits non-zero; without a CUDA device nothing runs.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

from medsam2_tpu_torch.api.video_predictor import SAM2VideoPredictor  # noqa: E402
from medsam2_tpu_torch.configs import sam2_hiera_t  # noqa: E402
from medsam2_tpu_torch.core.sam2_model import SAM2Model  # noqa: E402
from medsam2_tpu_torch.ops import _build  # noqa: E402
from medsam2_tpu_torch.ops import attention as A  # noqa: E402

DEV = torch.device("cuda")
# fp32 (TF32 off): absolute. bf16: relative to the largest |output|, since
# the kernel rounds probabilities and outputs to bf16; measured on an H100,
# max_abs_err / max|output| stays under 3.2e-3 (about one bf16 ulp), while a
# kernel that drops the pointer tiles misses by 2.8e-2.
TOL_F32 = 1e-4
TOL_BF16_REL = 1e-2


def tolerance(want: torch.Tensor, dtype) -> float:
    if dtype == torch.bfloat16:
        return TOL_BF16_REL * want.abs().max().item()
    return TOL_F32
KERNELS = {
    "flash_attention": dict(source="medsam2_tpu_torch/csrc/flash_attention.cu",
                            replaces="medsam2_tpu/ops/attention.py:49"),
    "kv_cached_attention": dict(source="medsam2_tpu_torch/csrc/kv_cached_attention.cu",
                                replaces="medsam2_tpu/ops/attention.py:454"),
}


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rand(rng, shape, dtype, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(DEV, dtype)


def phase_device() -> str:
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 device] {line} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    log = (lib.parent / "ptxas.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spilled = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log) if int(s)]
    print(f"[2 build] {secs:.1f} s -> {lib} | {len(regs)} kernel instantiations, "
          f"max {max(regs)} registers, {len(spilled)} with spill stores "
          f"(max {max(spilled, default=0)} bytes)")


def phase_kernels():
    """Kernel vs twin at the slice's shapes. Returns the bf16 main-shape
    results per kernel for the JSON line."""
    rng = np.random.default_rng(0)
    best = {}
    flash_cases = [("hiera global attention @1024", (1, 4, 4096, 96)),
                   ("memory self-attention @1024", (1, 1, 4096, 256))]
    for dtype in (torch.bfloat16, torch.float32):
        set_tf32(False)
        for label, (B, H, N, D) in flash_cases:
            q, k, v = (rand(rng, (B, H, N, D), dtype) for _ in range(3))
            got = A.flash_attention(q, k, v)
            want = A.flash_attention_plain(q.float(), k.float(), v.float())
            err = (got.float() - want).abs().max().item()
            tol = tolerance(want, dtype)
            ms = cuda_ms(lambda: A.flash_attention(q, k, v), reps=10)
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v), reps=5)
            ok = err <= tol
            print(f"[3 kernel] flash_attention {label} {[B, H, N, D]} {dtype} "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.3f} ms "
                  f"plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention {label} {dtype}: err {err}")
            if dtype == torch.bfloat16 and H == 4:
                best["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        # memory cross-attention @1024: 1 cond slot + 7-slot ring, P = 64*64,
        # 4 layers, C = 256, 64-wide values, 64 pointer tokens
        F, L, P, C, Dv, Nptr, Nq = 8, 4, 4096, 256, 64, 64, 4096
        # Unit-scale inputs keep the logits O(1), so the softmax is far from
        # uniform and a kernel that dropped keys, skipped pos_rows or read the
        # wrong row fails the tolerance; slot f reads its own row perm[f].
        perm = np.array([3, 0, 6, 1, 7, 2, 5, 4], np.int32)
        for B in (1, 2):
            q = rand(rng, (B, Nq, C), dtype)
            kc = rand(rng, (B, F, L, P, C), dtype)
            pos = rand(rng, (F, L, P, C), dtype)
            rows = torch.from_numpy(perm).to(DEV)
            pk = rand(rng, (B, Nptr, C), dtype)
            vs = rand(rng, (B, F, P, Dv), dtype)
            pv = rand(rng, (B, Nptr, Dv), dtype)
            m = np.ones((B, F * P + Nptr), bool)
            m[:, 5 * P:] = False                   # three stale ring slots
            m[0, F * P:] = True                    # sixteen object pointers, the most kept
            if B > 1:
                m[1, 2 * P:3 * P] = False          # another stale slot
                m[1, F * P:F * P + 32] = True      # eight object pointers
            mask = torch.from_numpy(m).to(DEV)
            args = (q, kc, pos, rows, pk, vs, pv, mask, 2)
            got = A.kv_cached_attention(*args)
            # the twin sums kcache + pos in the cache dtype, as the kernel does
            want = A.kv_cached_attention_plain(q.float(), kc, pos, rows, pk, vs.float(),
                                               pv.float(), mask, 2)
            err = (got.float() - want).abs().max().item()
            tol = tolerance(want, dtype)
            ms = cuda_ms(lambda: A.kv_cached_attention(*args), reps=10)
            plain_ms = cuda_ms(lambda: A.kv_cached_attention_plain(*args), reps=3)
            ok = err <= tol
            print(f"[3 kernel] kv_cached_attention memory cross-attention @1024 B={B} "
                  f"{[B, Nq, F, L, P, C, Dv, Nptr]} {dtype} max_abs_err {err:.3e} "
                  f"(tol {tol:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kv_cached_attention B={B} {dtype}: err {err}")
            if dtype == torch.bfloat16 and B == 1:
                best["kv_cached_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            del q, kc, pos, pk, vs, pv, got, want
    torch.cuda.empty_cache()
    return best


def volume(T: int, size: int, seed: int) -> np.ndarray:
    """A CT-like test volume: a bright disc drifting over textured noise."""
    rng = np.random.default_rng(seed)
    vol = (rng.random((T, size, size, 3)) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for t in range(T):
        cy, cx = size * 0.45, size * (0.3 + 0.03 * t)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (size * 0.12) ** 2
        vol[t][disc] = 200
    return vol


def run_slice(model, video, point):
    pred = SAM2VideoPredictor(model, max_cond_frames=1)
    state = pred.init_state(images=video)
    pred.add_new_points(state, frame_idx=0, obj_id=1, points=np.array([point]),
                        labels=np.array([1]))
    return pred.propagate_in_video_batch(state)


def phase_e2e_parity():
    cfg = sam2_hiera_t(image_size=512, compute_dtype="float32")
    video = volume(4, 512, seed=1)
    point = [0.3 * 512 + 10, 0.45 * 512]
    set_tf32(False)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        frames, cuda_masks = run_slice(SAM2Model(cfg, seed=0, device=DEV), video, point)
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    counts = A.launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, cpu_masks = run_slice(SAM2Model(cfg, seed=0, device="cpu"), video, point)
    t_cpu = time.perf_counter() - t0
    err = (cuda_masks.cpu() - cpu_masks).abs().max().item()
    scale = cpu_masks.abs().max().item()
    ok = err <= 1e-3 and all(counts.values()) and torch.isfinite(cuda_masks).all()
    print(f"[4 e2e parity] sam2_hiera_t @512 fp32 TF32 off, 4 frames, 1 object: cuda "
          f"(kernels, launches {counts}) vs cpu (plain): low-res logits max_abs_err {err:.3e} "
          f"(tol 1e-3, |logits| max {scale:.2f}) | cuda {t_cuda:.1f} s cpu {t_cpu:.1f} s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"e2e parity: err {err}, launches {counts}")


def phase_full_width(power_line: str):
    cfg = sam2_hiera_t()                      # 1024 px, bf16 compute
    T = 8
    video = volume(T, 512, seed=2)            # CT slices are 512 px, resized to 1024
    point = [0.3 * 512 + 10, 0.45 * 512]
    set_tf32(False)                           # fp32 products stay fp32, as in JAX
    model = SAM2Model(cfg, seed=0, device=DEV)
    with torch.no_grad():
        run_slice(model, video, point)        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        pred = SAM2VideoPredictor(model, max_cond_frames=1)
        state = pred.init_state(images=video)
        pred.add_new_points(state, frame_idx=0, obj_id=1, points=np.array([point]),
                            labels=np.array([1]))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frames, masks = pred.propagate_in_video_batch(state)
        end.record()
        torch.cuda.synchronize()
    counts = A.launch_counts()
    prop_ms = start.elapsed_time(end)
    tracked = T - 1
    encoded = 1 + 1 + tracked                 # preview + preflight + tracked frames
    n_global = len(cfg.trunk.global_att_blocks)
    n_layers = cfg.memory_attention.num_layers
    want = {"flash_attention": n_global * encoded + n_layers * tracked,
            "kv_cached_attention": n_layers * tracked}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(masks).all())
    shape_ok = tuple(masks.shape) == (T, 1, 1, 256, 256) and frames == list(range(T))
    ok = counts == want and finite and shape_ok
    print(f"[5 full width] sam2_hiera_t @1024 bf16, {T} frames, 1 object | launches {counts} "
          f"expected {want} | finite {finite} shape {tuple(masks.shape)} | "
          f"propagate_in_video_batch {prop_ms:.2f} ms = {prop_ms / tracked:.2f} ms per tracked "
          f"frame (preflight prompt step included) | peak memory {peak:.2f} GiB | "
          f"{power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full width: launches {counts} vs {want}, finite {finite}, "
                             f"shape {tuple(masks.shape)}")
    return counts


def main() -> None:
    power_line = phase_device()
    phase_build()
    best = phase_kernels()
    phase_e2e_parity()
    counts = phase_full_width(power_line)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **KERNELS[name], launches=counts[name], **best[name])
        for name in KERNELS]}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
