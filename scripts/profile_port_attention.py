"""Time the bf16 attention wrappers (B1 flash forward, B2 kv-cached, the
B3/B4 backward pair, B5 window attention) of one copy of the port at the
main path's shapes, on one GPU; with ``--block``, the fused window block
(B8) at phase 8's shapes instead, and with ``--mlp`` the fused MLP (B7) at
phase 8's shapes of three launches (C > 224).

    python3 scripts/profile_port_attention.py [ROOT ...] [--graph] [--block] [--mlp]

Each ROOT is a directory holding a ``medsam2_tpu_torch`` package (default:
this checkout); each runs in its own process, in the order given, so
``parent change change parent`` compares two trees on one card in turns.
The shapes, inputs and timers are ``chip_smoke.py``'s of this checkout
(phase 3's flash and kv-cached cases, phase 3b's training cases with LSE
and their backward passes, phase 8's window-attention cases, or phase 8's
``BLOCK_CASES``),
run against each ROOT's package. Times are CUDA-event milliseconds per
wrapper call over an eager loop of calls (host work included once the host
falls behind the card), or with ``--graph`` over replays of a CUDA graph of
the calls (device time only).
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CHECKOUT = Path(__file__).resolve().parents[1]


def measure(root: str, graph: bool, block: bool, mlp: bool) -> None:
    # chip_smoke's own imports of the package then resolve to ROOT's copy
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", CHECKOUT / "chip_smoke.py")
    s = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(s)
    A = s.A
    timed = s.graph_ms if graph else (lambda fn: s.cuda_ms(fn, reps=20))
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    res = {}
    if block or mlp:
        for Bn, ws, C, heads in s.BLOCK_CASES if block else ():
            wins = s.rand(rng, (Bn, ws, ws, C), bf16)
            p = s.block_params(rng, C, bf16)
            res[f"fused_block N {Bn * ws * ws} C {C} ws {ws} heads {heads}"] = timed(
                lambda: s.FB.fused_window_block(wins, p, heads))
        for N, C in s.MLP_CASES if mlp else ():
            if C <= 224:
                continue
            x = s.rand(rng, (N, C), bf16)
            g, b = 1 + 0.1 * s.rand(rng, (C,), bf16), 0.1 * s.rand(rng, (C,), bf16)
            (w1, b1), (w2, b2) = (s.linear_params(rng, 4 * C, C, bf16),
                                  s.linear_params(rng, C, 4 * C, bf16))
            res[f"fused_mlp {N}x{C}x{4 * C}"] = timed(
                lambda: s.FM.ln_mlp_residual(x, g, b, w1, b1, w2, b2))
        for name, ms in res.items():
            print(f"{root:>16} {name:48s} {ms:.4f} ms", flush=True)
        return
    for label, (B, H, N, D) in s.FLASH_CASES:
        q, k, v = (s.rand(rng, (B, H, N, D), bf16) for _ in range(3))
        res[f"flash {label}"] = timed(lambda: A.flash_attention(q, k, v))
    for label, B, H, Nq, Nk, D, Dv, kind in s.TRAIN_CASES[:2]:
        q, k, v = (s.rand(rng, (B, H, n, d), bf16) for n, d in ((Nq, D), (Nk, D), (Nk, Dv)))
        mask = s.train_mask(kind, B, Nk)
        res[f"flash+lse {label}"] = timed(
            lambda: A._flash_forward(q, k, v, mask, D ** -0.5, True))
        do = s.rand(rng, (B, H, Nq, Dv), bf16)
        o, lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(), mask)
        dvec = (do.float() * o.to(bf16).float()).sum(-1)
        res[f"bwd dkv {label}"] = timed(
            lambda: A.flash_attention_bwd_dkv(q, k, v, mask, do, lse, dvec))
        res[f"bwd dq {label}"] = timed(
            lambda: A.flash_attention_bwd_dq(q, k, v, mask, do, lse, dvec))
    for B in (1, 2):
        args, _ = s.kv_inputs(rng, B, bf16)
        res[f"kv_cached @1024 B={B}"] = timed(lambda: A.kv_cached_attention(*args))
    for Hp, heads, ws in ((70, 4, 14), (35, 8, 7)):
        qkv = s.rand(rng, (1, Hp, Hp, 3 * 96 * heads), bf16)
        res[f"window [1,{Hp},{Hp},{3 * 96 * heads}] ws {ws}"] = timed(
            lambda: s.WA.window_attention(qkv, heads, ws))
    for name, ms in res.items():
        print(f"{root:>16} {name:48s} {ms:.4f} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(CHECKOUT)])
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--mlp", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port_attention: needs a CUDA device")
    if args.one:
        measure(args.one, args.graph, args.block, args.mlp)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    for root in args.roots:
        cmd = ([sys.executable, __file__, "--one", root] + (["--graph"] if args.graph else [])
               + (["--block"] if args.block else []) + (["--mlp"] if args.mlp else []))
        subprocess.run(cmd, check=True, timeout=600)


if __name__ == "__main__":
    main()
