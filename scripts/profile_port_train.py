"""Where a 3D training step's time goes in the PyTorch port, on one GPU.

    python3 scripts/profile_port_train.py [--size 512] [--frames 8] [--objects 2] [--out FILE.json]

For sam2_hiera_t bf16 with seeded random weights and the JAX package's
``bench.py`` train_3d batch (random images, one square per object, box
prompts every 2nd frame, ``max_cond_frames=4``): after a warm-up step, times
the stages of 3 train steps with CUDA events (the forward over the volume,
the memory-path pull d(non_prompt)/d(mem), the decoder pull
d(prompt + non_prompt)/d(sam), the two Adam updates) and the whole step on
the host clock; then traces one step with ``torch.profiler``: device time by
kernel, the count of kernel launches, and the device's busy share of the
traced step's wall time (the profiler slows the host, so this share is low).
The busy share of an untraced step is derived, not measured: the traced
step's device busy time over the median untraced step's host-clock time.
Prints one line per measurement and, last, a JSON summary (also written to
``--out``).
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

from medsam2_tpu_torch.configs import sam2_hiera_t  # noqa: E402
from medsam2_tpu_torch.core.sam2_model import SAM2Model  # noqa: E402
from medsam2_tpu_torch.state import memory_bank as mb  # noqa: E402
from medsam2_tpu_torch.train import recipe_3d  # noqa: E402

DEV = torch.device("cuda")


def bench_batch(T: int, O: int, S: int, n_prompt: int, P: int = 8):
    """``bench.py``'s train_3d batch (seed 0), on the card but for the host
    array ``prompt_use_mask``, as ``recipe_3d.make_train_step`` passes it."""
    rng = np.random.default_rng(0)
    gt = np.zeros((T, O, S, S), np.float32)
    gt[:, :, S // 4: S // 2, S // 4: S // 2] = 1.0
    coords = np.zeros((n_prompt, O, P, 2), np.float32)
    labels = -np.ones((n_prompt, O, P), np.int32)
    coords[:, :, 0] = [S // 4, S // 4]
    coords[:, :, 1] = [S // 2, S // 2]
    labels[:, :, 0] = 2
    labels[:, :, 1] = 3
    batch = {"images": rng.random((T, S, S, 3)).astype(np.float32), "gt_masks": gt,
             "prompt_coords": coords, "prompt_labels": labels,
             "prompt_use_mask": np.zeros((n_prompt, O), bool), "obj_valid": np.ones(O, bool)}
    return {k: v if k == "prompt_use_mask" else torch.from_numpy(v).to(DEV)
            for k, v in batch.items()}


def staged_step(model, spec, rcfg, opts, params, batch, gen):
    """One train step (``recipe_3d.make_train_step`` for one volume) with a
    CUDA event between stages; returns the events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    prompt_loss, non_prompt_loss = recipe_3d.volume_losses(model, spec, rcfg, batch,
                                                           generator=gen)
    ev[1].record()
    g_mem = recipe_3d._grads(non_prompt_loss, params["mem"], retain_graph=True)
    ev[2].record()
    g_sam = recipe_3d._grads(prompt_loss + non_prompt_loss, params["sam"], retain_graph=False)
    ev[3].record()
    for group, grads in (("mem", g_mem), ("sam", g_sam)):
        for p, g in zip(params[group], grads):
            p.grad = g
        opts[group].step()
    ev[4].record()
    return ev


def trace(fn):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = defaultdict(float), 0
    for e in prof.events():
        # a user range (e.g. ``Optimizer.step#Adam.step``) also shows on the
        # device and overlaps the kernels it encloses: only kernels count
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] += e.time_range.elapsed_us()
            count += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return wall_us, busy_us, count, top


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = sam2_hiera_t(image_size=args.size)
    rcfg = recipe_3d.Recipe3DConfig(video_length=args.frames, prompt_freq=2,
                                    num_objects=args.objects, max_cond_frames=4)
    model = SAM2Model(cfg, seed=0, device=DEV)
    opts = recipe_3d.make_optimizers(model, rcfg)
    params = {g: [p for grp in o.param_groups for p in grp["params"]] for g, o in opts.items()}
    spec = mb.BankSpec.from_config(cfg, max_cond_frames=rcfg.max_cond_frames)
    batch = bench_batch(args.frames, args.objects, args.size, len(rcfg.prompt_frames))
    gen = torch.Generator(device=DEV).manual_seed(0)

    def step():
        return staged_step(model, spec, rcfg, opts, params, batch, gen)

    step()
    torch.cuda.synchronize()
    stages = defaultdict(list)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        ev = step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for i, name in enumerate(("forward", "mem_pull", "sam_pull", "adam")):
            stages[name].append(ev[i].elapsed_time(ev[i + 1]))
    wall_us, busy_us, count, top = trace(step)
    result = {
        "card": card, "torch": torch.__version__,
        "config": {"preset": "sam2_hiera_t", "image_size": args.size, "frames": args.frames,
                   "objects": args.objects, "max_cond_frames": 4, "dtype": "bfloat16"},
        "step_ms_host": walls,
        "stage_ms": {k: v for k, v in stages.items()},
        "traced_step": {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                        "device_idle_share": 1 - busy_us / wall_us, "kernel_launches": count,
                        "top_kernels_ms": [(n[:90], us / 1e3) for n, us in top]},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    result["untraced_busy_share_derived"] = (busy_us / 1e3) / float(np.median(walls))
    print(f"[train step] {card} | hiera_t @{args.size} bf16, {args.frames} frames, "
          f"{args.objects} objects | step {walls} ms (host clock) | stages (ms, 3 steps) "
          + ", ".join(f"{k} {[round(x, 2) for x in v]}" for k, v in stages.items()))
    ts = result["traced_step"]
    print(f"[traced step] wall {ts['wall_ms']:.2f} ms, device busy {ts['device_busy_ms']:.2f} ms, "
          f"idle share {ts['device_idle_share']:.3f}, {count} kernel launches, peak memory "
          f"{result['peak_memory_gib']:.2f} GiB")
    print(f"[derived] untraced busy share = traced busy {ts['device_busy_ms']:.2f} ms / "
          f"median untraced step {float(np.median(walls)):.2f} ms = "
          f"{result['untraced_busy_share_derived']:.3f}")
    for name, ms in ts["top_kernels_ms"]:
        print(f"    {ms:8.3f} ms  {name}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
