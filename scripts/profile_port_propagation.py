"""Where a tracked frame's time goes in the PyTorch port, on one GPU.

    python3 scripts/profile_port_propagation.py [--objects 1 2] [--out FILE.json]

For sam2_hiera_t @1024 bf16 with seeded random weights: fills the memory bank
the way propagation does (prompt frame 0, then tracked frames 1..7), then on
frame 8 times each stage of ``track_step`` with CUDA events (image encoder,
memory attention, SAM heads, memory encoder + roped-key cache + bank write),
the whole tracked frame, a tracked run of 7 frames, and whole
``propagate_in_video_batch`` calls over 8 frames (host clock). One tracked frame is
also traced with ``torch.profiler``: device time by kernel, the time of the
port's attention kernels (flash forward, kv-cached, split-kv merge), and the
device's busy share of the frame's wall time. Prints one line per measurement and, last,
a JSON summary (also written to ``--out``).
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from medsam2_tpu_torch.api.video_predictor import (SAM2VideoPredictor, _encode_frame,  # noqa: E402
                                                   _track_run)
from medsam2_tpu_torch.configs import sam2_hiera_t  # noqa: E402
from medsam2_tpu_torch.core.sam2_model import SAM2Model, compute_dtype, kcache_shape  # noqa: E402
from medsam2_tpu_torch.state import memory_bank as mb  # noqa: E402

DEV = torch.device("cuda")
# kernel-name fragments of the port's attention kernels on the propagation path
ATTENTION_KERNELS = ("flash_sm90_kernel", "flash_fwd_f32_kernel", "kv_cached_sm90_kernel",
                     "kv_cached_f32_kernel", "attention_merge_kernel")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def volume(T: int, size: int, n_obj: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vol = (rng.random((T, size, size, 3)) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for t in range(T):
        for o in range(n_obj):
            cy, cx = size * (0.3 + 0.4 * o), size * (0.3 + 0.03 * t)
            vol[t][(yy - cy) ** 2 + (xx - cx) ** 2 < (size * 0.1) ** 2] = 200
    return vol


def trace_frame(fn):
    """Device time by kernel name and the busy share of one call's wall."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    attn = {k: sum(us for n, us in by_name.items() if k in n) / 1e3 for k in ATTENTION_KERNELS}
    return wall_us, busy_us, top, {k: ms for k, ms in attn.items() if ms}


def profile(n_obj: int) -> dict:
    cfg = sam2_hiera_t()
    T = 9
    model = SAM2Model(cfg, seed=0, device=DEV)
    video = volume(T, 512, n_obj)
    pred = SAM2VideoPredictor(model, max_cond_frames=1)
    state = pred.init_state(images=video)
    for o in range(n_obj):
        pred.add_new_points(state, 0, obj_id=o + 1, labels=np.array([1]),
                            points=np.array([[0.3 * 512 + 10, (0.3 + 0.4 * o) * 512]]))
    spec = pred._session_spec(state)
    bank = mb.init_bank(spec, n_obj, DEV, kcache_shape=kcache_shape(cfg),
                        kcache_dtype=compute_dtype(cfg))
    pos_kcache = model.make_pos_kcache(spec)
    images = state["images"]
    trunk_pe = model.image_encoder.trunk.get_pos_embed(images.shape[1] // 4,
                                                       images.shape[2] // 4)
    kw = dict(spec=spec, pos_kcache=pos_kcache, trunk_pe=trunk_pe, num_frames=T, is_eval=True)
    out = {}

    def propagate():
        s2 = pred.init_state(images=video)
        for o in range(n_obj):
            pred.add_new_points(s2, 0, obj_id=o + 1, labels=np.array([1]),
                                points=np.array([[0.3 * 512 + 10, (0.3 + 0.4 * o) * 512]]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.propagate_in_video_batch(s2, max_frame_num_to_track=7)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        propagate()
        out["propagate_8_frames_ms"] = sorted(propagate() for _ in range(3))
        t0 = time.perf_counter()
        _, bank = pred._run_prompt_frame(state, bank, 0, spec)
        torch.cuda.synchronize()
        out["prompt_step_ms_host"] = (time.perf_counter() - t0) * 1e3
        out["tracked_run_7_frames_ms"] = cuda_ms(
            lambda: _track_run(model, images, bank, list(range(1, 8)), **kw), reps=3, warmup=1)
        out["ms_per_tracked_frame"] = out["tracked_run_7_frames_ms"] / 7

        f = 8
        feats, pos = _encode_frame(model, images[f:f + 1], trunk_pos_embed=trunk_pe)
        feats = [x.expand(n_obj, *x.shape[1:]) for x in feats]
        pos = [x.expand(n_obj, *x.shape[1:]) for x in pos]
        pix = model.prepare_memory_conditioned_features(
            spec, bank, f, False, feats[-1], pos[-1], num_frames=T, is_eval=True,
            pos_kcache=pos_kcache)
        sam = model.forward_sam_heads(pix, high_res_features=feats[:-1], multimask_output=True,
                                      eval_dynamic_multimask=True)

        def memory_write():
            mem, _ = model.encode_new_memory(feats[-1], sam.high_res_masks, False, binarize=True)
            kc = model.memory_kcache(mem, bank["kcache"].dtype)
            mb.write_bank(spec, bank, f, mem, sam.obj_ptr, is_cond=False, kcache=kc)

        out["stage_ms"] = {
            "image_encoder": cuda_ms(lambda: _encode_frame(model, images[f:f + 1],
                                                           trunk_pos_embed=trunk_pe)),
            "memory_attention": cuda_ms(lambda: model.prepare_memory_conditioned_features(
                spec, bank, f, False, feats[-1], pos[-1], num_frames=T, is_eval=True,
                pos_kcache=pos_kcache)),
            "sam_heads": cuda_ms(lambda: model.forward_sam_heads(
                pix, high_res_features=feats[:-1], multimask_output=True,
                eval_dynamic_multimask=True)),
            "memory_encoder_kcache_write": cuda_ms(memory_write),
        }
        out["track_one_frame_ms"] = cuda_ms(lambda: _track_run(model, images, bank, [f], **kw))
        wall_us, busy_us, top, attn = trace_frame(
            lambda: _track_run(model, images, bank, [f], **kw))
    out["traced_frame"] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                           "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
                           "attention_kernels_ms": attn,
                           "top_kernels_ms": [(n[:90], us / 1e3) for n, us in top]}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--objects", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port_propagation: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "torch": torch.__version__, "runs": {}}
    for n in args.objects:
        r = profile(n)
        result["runs"][str(n)] = r
        print(f"[{n} object(s)] {card} | {r['ms_per_tracked_frame']:.2f} ms per tracked frame "
              f"(7-frame run) | one frame {r['track_one_frame_ms']:.2f} ms | propagate_in_video"
              f"_batch of 8 frames {r['propagate_8_frames_ms']} ms | prompt step "
              f"{r['prompt_step_ms_host']:.2f} ms | stages "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in r["stage_ms"].items()))
        tf = r["traced_frame"]
        attn_ms = sum(tf["attention_kernels_ms"].values())
        print(f"[{n} object(s)] traced frame: wall {tf['wall_ms']:.2f} ms, device busy "
              f"{tf['device_busy_ms']:.2f} ms, idle share {tf['device_idle_share']} | attention "
              f"kernels {attn_ms:.3f} ms ({attn_ms / tf['device_busy_ms']:.1%} of device time): "
              f"{tf['attention_kernels_ms']}")
        for name, ms in tf["top_kernels_ms"]:
            print(f"    {ms:8.3f} ms  {name}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
