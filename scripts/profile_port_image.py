"""Where one ``set_image`` of the PyTorch port's image predictor spends its
time, on one GPU, with the three encoder switches off and on.

    python3 scripts/profile_port_image.py [--preset sam2_hiera_t] [--size 1024] [--out FILE.json]

For the preset in bf16 with seeded random weights and ``chip_smoke.py``'s
1024² test image: ``set_image`` on the host clock (synchronised; medians of
5 calls each, switches off / on / on / off after a warm-up), then one traced
call each way with ``torch.profiler``: device time by kernel, the count of
kernel launches, and the device's busy share of the traced call's wall time
(the profiler slows the host, so this share is low). The busy share of an
untraced call is derived, not measured: traced busy time over the median
untraced call. Prints one line per measurement and, last, a JSON summary
(also written to ``--out``).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from medsam2_tpu_torch import configs  # noqa: E402
from medsam2_tpu_torch.api.image_predictor import SAM2ImagePredictor  # noqa: E402
from medsam2_tpu_torch.core.sam2_model import SAM2Model  # noqa: E402
from medsam2_tpu_torch.ops import attention as A  # noqa: E402
from profile_port_train import trace  # noqa: E402

SWITCHES = ("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_WINDOW", "MEDSAM2_FUSED_MLP")


def test_image(size: int, seed: int) -> np.ndarray:
    """``chip_smoke.test_image``: 24 flat-coloured discs over black, plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.zeros((size, size, 3), np.float32)
    for _ in range(24):
        cy, cx = rng.integers(0, size, 2)
        r = rng.integers(size // 50, size // 8)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)[..., None]
        img = np.where(blob, rng.random(3, np.float32) * 255, img)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def set_switches(value: str) -> None:
    os.environ.update({k: value for k in SWITCHES})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="sam2_hiera_t",
                    choices=["sam2_hiera_t", "sam2_hiera_s", "sam2_hiera_b_plus", "sam2_hiera_l"])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port_image: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = getattr(configs, args.preset)(image_size=args.size)
    pred = SAM2ImagePredictor(SAM2Model(cfg, seed=0, device=torch.device("cuda")))
    img = test_image(args.size, seed=0)

    def call():
        pred.set_image(img)

    walls = {"0": [], "1": []}
    for value in ("0", "1", "1", "0"):
        set_switches(value)
        call()
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[value].append((time.perf_counter() - t0) * 1e3)
    result = {"card": card, "torch": torch.__version__,
              "config": {"preset": args.preset, "image_size": args.size, "dtype": "bfloat16"},
              "set_image_ms_host": walls, "traced": {}}
    for value in ("0", "1"):
        set_switches(value)
        A.reset_launch_counts()
        wall_us, busy_us, count, top = trace(call)
        median = float(np.median(walls[value]))
        result["traced"][value] = {
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / wall_us, "kernel_launches": count,
            "port_kernel_launches": {k: n for k, n in A.launch_counts().items() if n},
            "untraced_busy_share_derived": (busy_us / 1e3) / median,
            "top_kernels_ms": [(n[:90], us / 1e3) for n, us in top]}
        t = result["traced"][value]
        print(f"[set_image switches {'on' if value == '1' else 'off'}] {card} | {args.preset} "
              f"@{args.size} bf16 | host clock {[round(x, 2) for x in walls[value]]} ms, median "
              f"{median:.2f} | traced: wall {t['wall_ms']:.2f} ms, device busy "
              f"{t['device_busy_ms']:.3f} ms, idle share {t['device_idle_share']:.3f}, {count} "
              f"kernel launches (port kernels {t['port_kernel_launches']}) | derived untraced "
              f"busy share {t['untraced_busy_share_derived']:.3f}")
        for name, ms in t["top_kernels_ms"][:10]:
            print(f"    {ms:8.3f} ms  {name}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
