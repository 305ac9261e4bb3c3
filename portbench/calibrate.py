"""Readings that set a cell's limits: the program's compared numbers over many
seeds, and the control's (the plain reference in a lower precision standing
in the program's place), in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 13 [--control fp8]

Each seed draws its own weights and inputs, warms the program up, runs
one unit of the cell's traffic and compares the sampled outputs
with the reference, as a benchmark run does after its window. With
``--control`` the control's numbers for the same samples follow. One JSON
line per seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "portbench", _sub)
sys.path.insert(0, ROOT)


def _slices(loop):
    """Per-sample, per-slice readings a loop kept, for the record."""
    return {k: [[round(float(x), 6) for x in row] for row in getattr(loop, k)]
            for k in ("per_slice", "per_slice_gap") if hasattr(loop, k)}


def readings(workload: str, seeds, control, root=ROOT, device=None,
             patch=None):
    """Yield one dict of readings per seed."""
    import torch

    from portbench.lib import bench

    device = torch.device(device or "cuda")
    root = Path(root)
    b = bench.load_benchmark(root)
    cell = bench.find_cell(b, workload)
    cfg_doc = bench.load_config(b, cell["config"], root)
    traffic = bench.load_json("traffic", cell["traffic"], root)
    limits = bench.load_json("limits", cell["name"], root)
    Loop = bench.load_loop(traffic)
    for seed in seeds:
        t0 = time.perf_counter()
        loop = Loop(cfg_doc, traffic, seed, device)
        loop.setup(bench.build_port_model)
        if patch is not None:
            patch(loop)
        loop.warm()
        loop.run_unit()
        loop.release()
        t1 = time.perf_counter()
        out = {"seed": seed, "program": {c["name"]: c["value"] for c in loop.check(limits)}}
        out["program_slices"] = _slices(loop)
        t2 = time.perf_counter()
        if control:
            out["control"] = {c["name"]: c["value"]
                              for c in loop.check(limits, control=control)}
            out["control_slices"] = _slices(loop)
        out["seconds"] = {"program": t1 - t0, "check": t2 - t1,
                          "control": time.perf_counter() - t2}
        del loop
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default=None, help="the control's precision, e.g. fp8")
    args = p.parse_args(argv)
    for r in readings(args.workload, args.seeds, args.control):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
