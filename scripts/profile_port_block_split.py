"""Split the fused window block (B8) into its launches and time each alone,
on one GPU, at ``chip_smoke.py``'s ``BLOCK_CASES`` (bf16, the widths of
1024 rows or more).

    python3 scripts/profile_port_block_split.py [--out FILE]

For each width, ``chip_smoke.block_split``: LN1, the qkv linear, the window
attention (B5) on the qkv rows as [windows, ws, ws, 3C], the proj linear
with its residual, and the MLP tail (B7's one kernel, or LN2, fc1 and fc2
where it takes three launches), each captured alone in a CUDA graph and
timed by replays, beside the whole block timed the same way; then one
graph of 10 blocks replayed under ``torch.profiler``: the kernels' own
durations by name, and the share of the replays' span in which no kernel
ran (the gaps between launches). Prints one line per width and, with
``--out``, writes the numbers as JSON.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port_block_split: needs a CUDA device")
    import chip_smoke as s

    power = s.phase_device()
    s._build.build()
    s._build.load_library()
    rows = []
    for Bn, ws, C, heads in s.BLOCK_CASES:
        if Bn * ws * ws >= 1024:
            rows.append(dict(N=Bn * ws * ws, C=C, ws=ws, heads=heads,
                             **s.block_split(Bn, ws, C, heads)))
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=power, cases=rows), indent=1))


if __name__ == "__main__":
    main()
