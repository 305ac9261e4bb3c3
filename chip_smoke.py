"""Drive the PyTorch port's 3D propagation (the whole session: reverse and
resumed propagation, corrections on tracked frames, clearing around new
prompts, the three memory readouts, batched volumes), 3D training (over raw
memory and over the roped-key cache), 2D image serving, REFUGE 2D training,
nuclei instance serving and nuclei training on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``medsam2_tpu_torch/csrc``, and
     count the HGMMA (wgmma) instructions of every bf16 flash, kv-cached,
     dQ, dK/dV, window-attention and encoder-linear instantiation in the
     library's SASS, with their registers and spills (none, or a spilling
     dQ, dK/dV, window or linear instantiation, fails the phase);
  3. the propagation kernels (flash forward, kv-cached, and the split-kv
     merge) against their plain PyTorch twins at the propagation path's
     shapes and hiera_l's global attention, bf16 and fp32: device times of
     kernel and library call from CUDA-graph replays (a split launch's time
     includes its merge), what the wrapper's host work adds to an eager
     call, the twin's time per eager call, TF/s, the share of the bound, the
     ratio to the library call and the grid (blocks, kv splits);
  3c. B2 at the folded-volume batch B = 4 (hiera_t @512) with the slot ->
     row maps a bank gives forward and in reverse, and B1 at the read-order
     inference shape @1024 (D 256 / Dv 64, a kv mask, no LSE), against their
     twins, bf16 and fp32, timed as phase 3;
  3d. the kernel cases that clearing makes (@1024, bf16 and fp32): B1 at the
     read-order inference shape with two kv splits left without a valid key,
     B2 with a hole in ring slots 1-3 forward and in reverse (one split
     without a valid key), masks from the bank's own readouts, against the
     twins, timed as phase 3;
  3b. the training kernels (flash forward with LSE, the dK/dV and dQ backward
     passes, the dQ pass at forced kv split counts and the dK/dV pass at
     forced q split counts, and the two split sums)
     against their twins at the training path's shapes, bf16 and fp32, with
     a kv mask holding stale frames, a ragged Nk and a batch whose keys are
     all masked, and at the Hiera global blocks that 2D training
     differentiates (hiera_s [4,4,4096,96] and hiera_l [4,8,4096,72] @1024
     batch 4); times of kernel, twin and
     ``F.scaled_dot_product_attention`` forward and backward (kernels and
     library calls by CUDA-graph replay; the library backward is its
     captured forward + backward less its forward);
  4. sam2_hiera_t @512 fp32 propagation on the card (kernels) against the same
     seeded model on the CPU (plain twins), low-res logits to 1e-3;
  5. sam2_hiera_t @1024 bf16, 8 frames, 1 object: init_state -> add_new_points
     -> propagate_in_video_batch, exact kernel launch counts, ms per tracked
     frame and peak memory;
  6. sam2_hiera_t @512 fp32 (TF32 off), 4 frames, 1 object: one train step
     on the card (kernels) against the same seeded model and batch on the CPU
     (plain path): both losses and every trainable gradient;
  7. sam2_hiera_t @512 bf16, 8 frames, 2 objects (the JAX package's
     ``bench.py`` train_3d default): a warm-up step and 3 timed steps, finite
     losses, both groups updated, frozen tensors bit-identical, exact launch
     counts of the three training kernels, seconds per step, frames per
     second, peak memory;
  8. the Hiera encoder kernels (window attention and its rank-3 form, fused
     LN-MLP, fused window block) against their twins at the hiera_t @1024
     shapes and the hiera_b+ / hiera_l widths, bf16 and fp32, with kernel,
     twin, library and bound times (kernels and library calls by CUDA-graph
     replay); the persistent bf16 encoder linear at every B7 / B8 linear of
     the four presets @1024 and at a ragged N, against the plain product
     rounded as its epilogue, beside ``F.linear``; the fused block split
     into its launches at every ``BLOCK_CASES`` width (each alone by graph
     replay, and the chain's kernels and idle share in a replayed graph
     under ``torch.profiler``); eight fused blocks captured in one CUDA
     graph against the twin, block by block;
  9. sam2_hiera_t @512 fp32 (TF32 off), the three encoder switches on:
     ``SAM2ImagePredictor.set_image`` + ``predict`` (points, box) on the card
     against the same seeded model on the CPU, low-res logits to 1e-3;
  10. sam2_hiera_t @1024 bf16 image serving: ``set_image`` with the switches
     off and on (the A/B), ``predict``, the 64-prompt grid decode (masks/s),
     ``SAM2AutomaticMaskGenerator.generate`` at 32 points per side with the
     default and the loaded thresholds and its stage split, peak memory, and
     the exact launch counts of one ``set_image`` with the switches on;
  11. sam2_hiera_b+ and sam2_hiera_l @1024 bf16 at full depth: ``set_image``
     with the switches on against off (exact launch counts from the JAX
     dispatch rules, image embeddings within tolerance), and sam2_hiera_l
     @512 fp32 (TF32 off) with the switches on, card against the CPU;
  12. the rest of the 3D session: at @512 fp32 (TF32 off) the bidirectional
     session (a click on frame 4 of 8, forward, then ``reverse=True``) in each
     memory readout (storage order, read order over the roped-key cache, read
     order over raw memory) and folded volumes, card against the CPU, logits
     to 1e-3; at @1024 bf16, 16 frames, a click on frame 8, forward then
     reverse in each readout: exact launch counts, ms per tracked frame, peak
     memory, storage order against read order over the cache
     (``TOL_READOUT``); ``propagate_volumes_batched`` at ``bench.py``'s
     3d_batch shape (@512 bf16, 4 volumes x 16 frames), folded and unfolded:
     exact counts, frames/s, peak memory, folded against unfolded;
  13. corrections and clearing: at @512 fp32 (TF32 off), card against the
     CPU in each readout, a correction session (12 frames, two objects, a
     point correction on frame 9, whose ring slot is frame 2's, and a mask
     correction on frame 5, then two re-propagations), a correction on a
     frame tracked in reverse, and a ``clear_non_cond_mem_around_input``
     session (cond frames 0 and 6, a correction, a resume), logits to 1e-3;
     at @1024 bf16, 16 frames, the correction round (clicks on frames 5 and
     12 and the re-propagation) in each readout: its wall time and ms per
     tracked frame, exact launch counts (``correction_launches``), peak
     memory;
  14. training over the roped-key cache: phase 6 with ``use_kcache=True``,
     and phase 7's step with the cache on against off in turns (seconds per
     step, exact launch counts, first-step losses within
     ``TOL_KCACHE_LOSS``);
  15. REFUGE 2D training at @512 fp32 (TF32 off, memory-attention dropout
     0), sam2_hiera_t batch 2: two steps (the empty bank, then the bank the
     first wrote with injected draws) on the card against the CPU: losses,
     every clipped gradient and the bank, with the encoder switches off and
     with B8 + B7 on (their backward re-runs the twin), exact launch counts;
  16. the REFUGE step at ``bench.py``'s train_2d shape, sam2_hiera_s @1024
     bf16 batch 4: a warm-up step on the empty bank and 3 timed steps,
     finite losses, every tensor with a gradient updated, exact launch counts
     of B1 / B3 / B4 (B3 / B4 by head dims), seconds per step, images/s,
     peak memory, one traced step (device busy time, idle share); the step
     with B8 + B7 on; two hiera_l @512 steps (B3 / B4 at head dim 72); and
     ``cli.train_2d -dataset synthetic`` for 2 steps and 1 validation sample;
  17. nuclei serving: 17k, B5 / B7 / B8 at the nuclei_256 shapes (B7 / B8
     also at nuclei training's batch-4 shapes) against
     their twins (times as phase 8); 17a, TINY SAM2 @64 fp32 (TF32 off) with
     resnet18 and pvt_v2_b0 prompters, card against the CPU: the prompter's
     outputs, a 70-point decode, ``predict_instances`` on a 64-px and a
     9-crop 128-px image (instance maps equal, or, where a mask logit within
     ``NEAR_ZERO`` of 0 took the other sign, AJI >= 0.99; the bank), and one
     nuclei_256 crop's image embedding bf16 with B5 / B7 / B8 on against fp32
     off (phase 11's rule) with exact counts; 17b, nuclei_256 bf16 with the
     pvt_v2_b2 prompter (``bench.py``'s nuclei mode): images/s over 8
     256-px images and seconds per 1000 x 1000 image (25 crops), switches
     off and on, the stage split (prompter, encode, decode, bank write,
     merge, the rest), exact launch counts per decoded crop, peak memory, a
     traced image's busy share, and the resnet50 prompter once;
  18. nuclei training (``recipe_nuclei``): 18a, two steps card against the
     CPU at fp32 (TF32 off) with the resnet18 prompter, at TINY @64 with
     the encoder switches off and at sam2_hiera_t @256 with them off and
     with B8 + B7 on: the six losses, the gradients, the parameters after
     AdamW, the mask head's running statistics, the bank, exact counts;
     18b, nuclei_256 bf16 with the resnet50 prompter, batch 4, 64 cell
     slots, switches off and on: s/step and images/s over 3 steps after a
     warm-up, exact B7 / B8 counts, peak memory, one step's stage split
     and one traced step's busy share; and ``cli.train_2d -net prompter``
     for 2 steps and 1 validation image.
Then one JSON line of per-kernel results (B8 also once per phase-8 width,
``fused_block C<width>``, with its launches in phases 10, 11, 17 and 18; B3
and B4 also once per Hiera head dim, ``flash_attention_bwd_dkv (96, 96)``
..., with their phase 3b numbers and phase 16 launches; B5 / B7 / B8 with
their phase-17k shapes under ``nuclei_shapes``), the card's
name and power limit,
and, last, the device line. Any failure raises and exits non-zero; without a
CUDA device nothing runs.
"""

import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

import torch.nn.functional as F  # noqa: E402

from medsam2_tpu_torch.api import automatic_mask_generator as amg_api  # noqa: E402
from medsam2_tpu_torch.api import nuclei_inference as NI  # noqa: E402
from medsam2_tpu_torch.api.image_predictor import SAM2ImagePredictor  # noqa: E402
from medsam2_tpu_torch.api.video_predictor import (SAM2VideoPredictor,  # noqa: E402
                                                   propagate_volumes_batched)
from medsam2_tpu_torch.cli import train_2d as train_2d_cli  # noqa: E402
from medsam2_tpu_torch.configs import (FpnNeckConfig, HieraConfig, SAM2Config,  # noqa: E402
                                       nuclei_256, sam2_hiera_b_plus, sam2_hiera_l,
                                       sam2_hiera_s, sam2_hiera_t)
from medsam2_tpu_torch.core.sam2_model import TRAINABLE_GROUPS, SAM2Model  # noqa: E402
from medsam2_tpu_torch.ops import _build  # noqa: E402
from medsam2_tpu_torch.ops import attention as A  # noqa: E402
from medsam2_tpu_torch.ops import encoder_linear as EL  # noqa: E402
from medsam2_tpu_torch.ops import fused_block as FB  # noqa: E402
from medsam2_tpu_torch.ops import fused_mlp as FM  # noqa: E402
from medsam2_tpu_torch.ops import window_attention as WA  # noqa: E402
from medsam2_tpu_torch.data.monuseg import pack_nuclei_batch  # noqa: E402
from medsam2_tpu_torch.data.refuge import pack_refuge_batch  # noqa: E402
from medsam2_tpu_torch.data.synthetic import synthetic_fundus, synthetic_nuclei  # noqa: E402
from medsam2_tpu_torch.metrics.instance import get_fast_aji, remap_label  # noqa: E402
from medsam2_tpu_torch.prompter.dpa_p2pnet import Prompter, PrompterConfig  # noqa: E402
from medsam2_tpu_torch.state import similarity_bank as SB  # noqa: E402
from medsam2_tpu_torch.train import recipe_2d, recipe_3d, recipe_nuclei  # noqa: E402

DEV = torch.device("cuda")
# fp32 (TF32 off): absolute. bf16: relative to the largest |output|, since
# the kernel rounds probabilities and outputs to bf16; measured on an H100,
# max_abs_err / max|output| stays under 3.2e-3 (about one bf16 ulp), while a
# kernel that drops the pointer tiles misses by 2.8e-2.
TOL_F32 = 1e-4
TOL_BF16_REL = 1e-2
# gradients, relative to the largest |gradient| of each: fp32 as the JAX
# package's grad test (5e-5); bf16 against the twin run on the same bf16
# values with the same roundings of P and dS
TOL_GRAD_F32 = 5e-5
TOL_GRAD_BF16 = 1e-2
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 without
# tensor cores (the fp32 kernels use plain FMA), HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

KERNELS = {
    "flash_attention": dict(source="medsam2_tpu_torch/csrc/flash_attention.cu",
                            replaces="medsam2_tpu/ops/attention.py:49"),
    "flash_attention_bwd_dkv": dict(source="medsam2_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
                                    replaces="medsam2_tpu/ops/attention.py:227"),
    # the split-q second pass of B3: the TPU kernel carried the dK/dV sums
    # over q tiles across its sequential grid, the card splits them over blocks
    "flash_attention_bwd_dkv_sum": dict(source="medsam2_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                                        replaces="medsam2_tpu/ops/attention.py:227"),
    "flash_attention_bwd_dq": dict(source="medsam2_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                                   replaces="medsam2_tpu/ops/attention.py:271"),
    # B3 / B4 at the Hiera global blocks' head dims, which 2D training
    # differentiates (hiera_t / s: 96; hiera_l: 72): rows of their own, with
    # the launches of those widths
    **{f"flash_attention_bwd_{p} ({d}, {d})": dict(
        source=f"medsam2_tpu_torch/csrc/flash_bwd_{p}_sm90.cu",
        replaces=f"medsam2_tpu/ops/attention.py:{line}")
       for d in (96, 72) for p, line in (("dkv", 227), ("dq", 271))},
    # the split-kv second pass of B4: the TPU kernel carried the dQ sum over
    # kv tiles across its sequential grid, the card splits it over blocks
    "flash_attention_bwd_dq_sum": dict(source="medsam2_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                                       replaces="medsam2_tpu/ops/attention.py:271"),
    "kv_cached_attention": dict(source="medsam2_tpu_torch/csrc/kv_cached_attention.cu",
                                replaces="medsam2_tpu/ops/attention.py:454"),
    # the split-kv second pass of B1 and B2: the TPU kernels carried the sum
    # over kv tiles across their sequential grid, the card splits it over blocks
    "attention_merge": dict(source="medsam2_tpu_torch/csrc/flash_attention.cu",
                            replaces="medsam2_tpu/ops/attention.py:49"),
    "window_attention": dict(source="medsam2_tpu_torch/csrc/window_attention_sm90.cu",
                             replaces="medsam2_tpu/ops/window_attention.py:45"),
    # B6 has its own Pallas kernel; the port serves it with B5's CUDA kernel
    # (launches counted under window_attention), and no path calls it
    "window_attention_v2": dict(source="medsam2_tpu_torch/csrc/window_attention_sm90.cu",
                                replaces="medsam2_tpu/ops/window_attention.py:85"),
    "fused_mlp": dict(source="medsam2_tpu_torch/csrc/encoder_gemm.cu",
                      replaces="medsam2_tpu/ops/fused_mlp.py:58"),
    "fused_block": dict(source="medsam2_tpu_torch/csrc/fused_block.cu",
                        replaces="medsam2_tpu/ops/fused_block.py:90"),
}
ENCODER_SWITCHES = ("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_WINDOW", "MEDSAM2_FUSED_MLP")
NO_ENCODER_LAUNCHES = {"window_attention": 0, "fused_mlp": 0, "fused_block": 0}
# bf16 kernels whose SASS must hold HGMMA (wgmma): (mangled-name pattern,
# instantiations): B1 (25 (D, Dv) pairs), B2, B4 and B3 (4 pairs each:
# (256, 256), (256, 64), (96, 96), (72, 72)), B5
# (ws 1 to 14 at d 96, 4 at d 56, 3 at d 72), the persistent encoder linear of
# B7 / B8 (column tiles 16 to 192 in steps of 16) and B7's one-kernel form
# (C 96, 112, 144, 192, 224)
SM90_KERNELS = (("flash_sm90_kernel", 25), ("kv_cached_sm90_kernel", 1),
                ("flash_bwd_dq_sm90_kernel", 4), ("flash_bwd_dkv_sm90_kernel", 4),
                ("window_sm90_kernel", 21), ("linear_persistent_sm90_kernel", 12),
                ("mlp_fused_sm90_kernel", 5))
# the ones a spill fails
NO_SPILL = ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel", "window_sm90_kernel",
            "linear_persistent_sm90_kernel", "mlp_fused_sm90_kernel")


def tolerance(want: torch.Tensor, dtype) -> float:
    if dtype == torch.bfloat16:
        return TOL_BF16_REL * want.abs().max().item()
    return TOL_F32


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-12)).item()


def bound(flops: float, nbytes: float, dtype):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate of their type and the bytes over HBM."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def bf16_grid(bh: int, nq: int, n_keys: int):
    """(blocks, kv splits) of a bf16 flash / kv-cached launch: one block
    per 128 query rows and head, the wrapper's split count."""
    q_tiles = bh * -(-nq // 128)
    splits = A.split_count(q_tiles, -(-n_keys // 64), sm_count())
    return q_tiles * splits, splits


def merges(bh: int, nq: int, n_keys: int) -> int:
    """1 if a bf16 launch of this shape splits its kv range (and so runs
    the merge kernel once), else 0: it splits when its blocks (one per 128
    query rows and head) fill at most half the SMs, so that a second split
    still fits in one wave, and it has more than one 64-key tile. ``bh`` is
    batch x heads: for the kv-cached call and the memory attention of folded
    volumes the batch is the bank's rows, volumes x objects. Worked out here
    apart from the wrapper's ``split_count``, so that a change to that rule
    fails the exact launch counts of phases 5, 7 and 12."""
    blocks = bh * -(-nq // 128)
    return int(2 * blocks <= sm_count() and n_keys > 64)


def dq_sums(bh: int, nq: int, n_keys: int, dv: int) -> int:
    """1 if a bf16 dQ launch of this shape splits its kv range (and so runs
    the split sum once), else 0: its blocks hold 64 query rows at Dv = 256
    and 128 otherwise, and it splits as the forward does (2 blocks per SM
    fit in one wave and more than one 64-key tile). Worked out here apart
    from the wrapper's ``dq_block_rows`` and ``split_count``."""
    blocks = bh * -(-nq // (64 if dv == 256 else 128))
    return int(2 * blocks <= sm_count() and n_keys > 64)


def dkv_sums(bh: int, nq: int, n_keys: int) -> int:
    """1 if a bf16 dK/dV launch of this shape splits its q range (and so
    runs the split sum once), else 0: one block per 64 keys and head, split
    as the forward does (2 blocks per SM fit in one wave and more than one
    64-row q tile). Worked out here apart from the wrapper's constants and
    ``split_count``."""
    blocks = bh * -(-n_keys // 64)
    return int(2 * blocks <= sm_count() and nq > 64)


def encoder_launches(cfg, batch: int = 1) -> dict:
    """Launches of the three encoder kernels in one ``set_image`` with the
    switches on, from the JAX package's dispatch rules restated here apart
    from the wrappers (``hiera._block_apply`` / ``_block_apply_windows``,
    ``fused_block.fused_window_block_supported``, ``fused_mlp.ln_mlp_residual``,
    MEDSAM2_FUSED_MLP_MAXC unset): a plain windowed block (no q-pooling, no
    width change) whose extent the window divides, with a row block r of
    1024 ... 16 rows (r a multiple of the window's n rows dividing the
    block's rows, r * r * 4 <= 4 MiB), runs whole as the fused block; a
    windowed block without q-pooling whose extent needs padding takes the
    window attention; every block but a fused one ends in the MLP tail, fused
    where its rows tile by 128. ``batch`` images share each call, so a
    block's rows are batch x its tokens."""
    hw = cfg.image_size // cfg.trunk.patch_stride[0]
    counts = {"window_attention": 0, "fused_mlp": 0, "fused_block": 0}
    for spec in cfg.trunk.block_schedule():
        ws, qs, C = spec["window_size"], spec["q_stride"], spec["dim_out"]
        if qs is not None:
            hw //= qs[0]
        rows, n = batch * hw * hw, ws * ws
        if (qs is None and spec["dim"] == C and ws > 0 and hw % ws == 0
                and C % spec["num_heads"] == 0
                and any(r % n == 0 and rows % r == 0 and r * r * 4 <= 4 << 20
                        for r in (1024, 512, 256, 128, 64, 32, 16))):
            counts["fused_block"] += 1
            continue
        if qs is None and ws > 0 and hw % ws:
            counts["window_attention"] += 1
        counts["fused_mlp"] += int(rows % 128 == 0)
    return counts


def global_flash(cfg) -> int:
    """Flash launches of one ``set_image``: the global-attention blocks
    whose sequence reaches the JAX package's flash gate (``attention._use_flash``:
    q and kv lengths >= 1024, head dim >= 64; hiera_b+'s d 56 stays under
    it)."""
    hw = cfg.image_size // cfg.trunk.patch_stride[0]
    n = 0
    for spec in cfg.trunk.block_schedule():
        if spec["q_stride"] is not None:
            hw //= spec["q_stride"][0]
        if spec["window_size"] == 0:
            n += int(hw * hw >= 1024 and spec["dim_out"] // spec["num_heads"] >= 64)
    return n


def global_blocks(cfg):
    """(heads, head dim, tokens) of each global-attention block of the trunk
    that reaches the flash gate (``global_flash``'s rule)."""
    hw = cfg.image_size // cfg.trunk.patch_stride[0]
    out = []
    for spec in cfg.trunk.block_schedule():
        if spec["q_stride"] is not None:
            hw //= spec["q_stride"][0]
        d = spec["dim_out"] // spec["num_heads"]
        if spec["window_size"] == 0 and hw * hw >= 1024 and d >= 64:
            out.append((spec["num_heads"], d, hw * hw))
    return out


def rates(ms: float, flops: float, bound_ms: float, lib_ms: float, grid) -> str:
    merge = " (the time includes the merge)" if grid[1] > 1 else ""
    return (f"{flops / ms / 1e9:.1f} TF/s, {bound_ms / ms:.1%} of bound, {ms / lib_ms:.2f}x "
            f"the library call, grid {grid[0]} blocks ({grid[1]} kv splits){merge}")


def host_us(eager_ms: float, ms: float) -> str:
    """What the wrapper's host work adds to a call: an eager loop of calls
    less their device time (0 while the card is the slower of the two)."""
    return f"eager {eager_ms:.4f} ms, host adds {max(0.0, eager_ms - ms) * 1e3:.1f} us per call"


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


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed ``replays`` times between CUDA events. No host work is
    timed, so a short kernel's time is not its wrapper's Python time (which
    ``cuda_ms`` measures once the host falls behind the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def rand(rng, shape, dtype, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(DEV, dtype)


def phase_device() -> str:
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 device] {line} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes)} from nvcc's
    ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = (0, 0)
        elif name and "spill stores" in line:
            out[name] = (out[name][0], int(re.search(r"(\d+) bytes spill stores", line).group(1)))
        elif name and "Used" in line and "registers" in line:
            out[name] = (int(re.search(r"Used (\d+) registers", line).group(1)), out[name][1])
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    report = ptxas_report((lib.parent / "ptxas.log").read_text())
    spilled = {n: sp for n, (_, sp) in report.items() if sp}
    print(f"[2 build] {secs:.1f} s -> {lib} | {len(report)} kernel instantiations, "
          f"max {max(r for r, _ in report.values())} registers, {len(spilled)} with spill "
          f"stores (max {max(spilled.values(), default=0)} bytes)")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    hgmma, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k, _ in SM90_KERNELS) else None
            if name:
                hgmma[name] = 0
        elif name and "HGMMA" in line:
            hgmma[name] += 1
    failed = []
    for kind, count in SM90_KERNELS:
        mine = {n: c for n, c in hgmma.items() if kind in n}
        regs = {n: report.get(n, (None, None)) for n in mine}
        ok = len(mine) == count and min(mine.values(), default=0) > 0
        if kind in NO_SPILL:
            ok = ok and all(sp == 0 for _, sp in regs.values())
        short = {re.sub(r"^_Z\w*?" + kind, "", n)[:24] or kind: (c, *regs[n])
                 for n, c in mine.items()}
        print(f"[2 sass] {kind}: {len(mine)} of {count} instantiations, (HGMMA, registers, "
              f"spill bytes) {short} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(kind)
    if failed:
        raise AssertionError(f"wgmma missing or spills in the bf16 kernels: {failed}")


def flash_work(B, H, Nq, Nk, D, Dv, mask, itemsize):
    """(flops of the forward over the keys this mask leaves, bytes of q, k, v
    and out)."""
    keys = float(Nk * B) if mask is None else float(mask.sum().item())
    flops = 2.0 * H * Nq * keys * (D + Dv)
    nbytes = itemsize * B * H * (Nq * D + Nk * D + Nk * Dv + Nq * Dv)
    return keys, flops, nbytes


# (label, (B, H, N, D)): the flash forward's shapes at @1024
FLASH_CASES = [("hiera global attention @1024", (1, 4, 4096, 96)),
               ("memory self-attention @1024", (1, 1, 4096, 256)),
               ("hiera_l global attention @1024", (1, 8, 4096, 72))]
# memory cross-attention @1024: 1 cond slot + 7-slot ring, P = 64*64,
# 4 layers, C = 256, 64-wide values, 64 pointer tokens
KV_BANK = dict(F=8, L=4, P=4096, C=256, Dv=64, Nptr=64, Nq=4096)


def kv_inputs(rng, B: int, dtype):
    """The kv-cached call of memory cross-attention @1024 at batch B, layer
    2: (the wrapper's arguments, the kv mask as numpy). Unit-scale inputs
    keep the logits O(1), so the softmax is far from uniform and a kernel
    that dropped keys, skipped pos_rows or read the wrong row fails the
    tolerance; slot f reads its own row perm[f]."""
    F_, L, P, C, Dv, Nptr, Nq = (KV_BANK[k] for k in ("F", "L", "P", "C", "Dv", "Nptr", "Nq"))
    perm = np.array([3, 0, 6, 1, 7, 2, 5, 4], np.int32)
    q = rand(rng, (B, Nq, C), dtype)
    kc = rand(rng, (B, F_, L, P, C), dtype)
    pos = rand(rng, (F_, L, P, C), dtype)
    rows = torch.from_numpy(perm).to(DEV)
    pk = rand(rng, (B, Nptr, C), dtype)
    vs = rand(rng, (B, F_, P, Dv), dtype)
    pv = rand(rng, (B, Nptr, Dv), dtype)
    m = np.ones((B, F_ * P + Nptr), bool)
    m[:, 5 * P:] = False                   # three stale ring slots
    m[0, F_ * P:] = True                   # sixteen object pointers, the most kept
    if B > 1:
        m[1, 2 * P:3 * P] = False          # another stale slot
        m[1, F_ * P:F_ * P + 32] = True    # eight object pointers
    mask = torch.from_numpy(m).to(DEV)
    return (q, kc, pos, rows, pk, vs, pv, mask, 2), m


def phase_kernels():
    """Propagation kernels vs twins at the slice's shapes. Returns the bf16
    main-shape results per kernel for the JSON line."""
    rng = np.random.default_rng(0)
    best = {}
    for dtype in (torch.bfloat16, torch.float32):
        set_tf32(False)
        for label, (B, H, N, D) in FLASH_CASES:
            q, k, v = (rand(rng, (B, H, N, D), dtype) for _ in range(3))
            got = A.flash_attention(q, k, v)
            want = A.flash_attention_plain(q.float(), k.float(), v.float())
            err = (got.float() - want).abs().max().item()
            tol = tolerance(want, dtype)
            ms = graph_ms(lambda: A.flash_attention(q, k, v))
            eager_ms = cuda_ms(lambda: A.flash_attention(q, k, v), reps=10)
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v), reps=5)
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            _, flops, nbytes = flash_work(B, H, N, N, D, D, None, q.element_size())
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            grid = (bf16_grid(B * H, N, N) if dtype == torch.bfloat16
                    else (B * H * -(-N // 64), 1))
            ok = err <= tol
            print(f"[3 kernel] flash_attention {label} {[B, H, N, D]} {dtype} "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms "
                  f"({host_us(eager_ms, ms)}) plain {plain_ms:.3f} ms sdpa {lib_ms:.4f} ms "
                  f"bound {bound_ms:.4f} ms ({bound_by}) | "
                  f"{rates(ms, flops, bound_ms, lib_ms, grid)} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention {label} {dtype}: err {err}")
            if dtype == torch.bfloat16 and H == 4:
                best["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                               bound_ms=bound_ms, bound_by=bound_by,
                                               library_ms=lib_ms,
                                               ms_includes_merge=grid[1] > 1)
        F_, L, P, C, Dv, Nptr, Nq = (KV_BANK[k] for k in ("F", "L", "P", "C", "Dv", "Nptr",
                                                          "Nq"))
        for B in (1, 2):
            args, m = kv_inputs(rng, B, dtype)
            q, kc, pos, rows, pk, vs, pv, mask, _ = args
            got = A.kv_cached_attention(*args)
            # the twin sums kcache + pos in the cache dtype, as the kernel does
            want = A.kv_cached_attention_plain(q.float(), kc, pos, rows, pk, vs.float(),
                                               pv.float(), mask, 2)
            err = (got.float() - want).abs().max().item()
            tol = tolerance(want, dtype)
            ms = graph_ms(lambda: A.kv_cached_attention(*args))
            eager_ms = cuda_ms(lambda: A.kv_cached_attention(*args), reps=10)
            plain_ms = cuda_ms(lambda: A.kv_cached_attention_plain(*args), reps=3)
            # the library call over k/v materialised outside the timing (the
            # gather is the kernel's own work and is not counted for SDPA)
            k_mat = torch.cat([(kc[:, :, 2] + pos[rows.long(), 2][None]).reshape(B, F_ * P, C),
                               pk], dim=1)[:, None]
            v_mat = torch.cat([vs.reshape(B, F_ * P, Dv), pv], dim=1)[:, None]
            bias = mask[:, None, None, :]
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k_mat, v_mat, attn_mask=bias))
            keys = float(m.sum())
            flops = 2.0 * Nq * keys * (C + Dv)
            nbytes = q.element_size() * (B * Nq * C + B * F_ * P * C + F_ * P * C
                                         + B * Nptr * C + B * F_ * P * Dv + B * Nptr * Dv
                                         + B * Nq * Dv) + m.size
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            grid = (bf16_grid(B, Nq, F_ * P + Nptr) if dtype == torch.bfloat16
                    else (B * -(-Nq // 64), 1))
            ok = err <= tol
            print(f"[3 kernel] kv_cached_attention memory cross-attention @1024 B={B} "
                  f"{[B, Nq, F_, L, P, C, Dv, Nptr]} {dtype} max_abs_err {err:.3e} "
                  f"(tol {tol:.3e}) kernel {ms:.4f} ms ({host_us(eager_ms, ms)}) plain "
                  f"{plain_ms:.3f} ms sdpa {lib_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) | "
                  f"{rates(ms, flops, bound_ms, lib_ms, grid)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kv_cached_attention B={B} {dtype}: err {err}")
            if dtype == torch.bfloat16 and B == 1:
                best["kv_cached_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bound_ms, bound_by=bound_by,
                                                   library_ms=lib_ms,
                                                   ms_includes_merge=grid[1] > 1)
            del args, q, kc, pos, pk, vs, pv, got, want, k_mat, v_mat
    best["attention_merge"] = merge_kernel(rng)
    torch.cuda.empty_cache()
    return best


def merge_kernel(rng) -> dict:
    """The merge at the memory self-attention's split @1024 (4 splits of
    4096 rows x 256), one split of row block 7 empty."""
    S, rows, Dv = bf16_grid(1, 4096, 4096)[1], 4096, 256
    o = rand(rng, (S, rows, Dv), torch.float32)
    lse = rand(rng, (S, rows), torch.float32, scale=3.0)
    lse[S - 1, 7 * 128:8 * 128] = -1e30
    o[S - 1, 7 * 128:8 * 128] = 0.0
    out, got_lse = A.attention_merge(o, lse)
    want, want_lse = A.attention_merge_plain(o, lse)
    err = (out.float() - want).abs().max().item()
    tol = tolerance(want, torch.bfloat16)
    err_lse = (got_lse - want_lse).abs().max().item()
    ms = graph_ms(lambda: A.attention_merge(o, lse))
    plain_ms = cuda_ms(lambda: A.attention_merge_plain(o, lse), reps=10)
    bound_ms, bound_by = bound(0.0, 4.0 * S * rows * (Dv + 1) + 2.0 * rows * Dv + 4.0 * rows,
                               torch.bfloat16)
    ok = err <= tol and err_lse <= 1e-5
    print(f"[3 kernel] attention_merge {S} splits x [{rows}, {Dv}] fp32 -> bf16 max_abs_err "
          f"{err:.3e} (tol {tol:.3e}) lse err {err_lse:.3e} (tol 1e-5) kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"attention_merge: err {err}, lse {err_lse}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# (label, B, H, Nq, Nk, D, Dv, mask kind): the training path's flash calls at
# @512 (memory self-attention, and the cross-attention over 4 cond frames,
# the 6-slot ring and 76 pointer tokens: Nk = 10 * 1024 + 76, ragged), and a
# small case whose batch 0 has every key masked
TRAIN_CASES = [
    ("memory self-attention @512", 2, 1, 1024, 1024, 256, 256, None),
    ("memory cross-attention @512", 2, 1, 1024, 10316, 256, 64, "stale"),
    ("dead batch, ragged", 2, 1, 100, 77, 256, 64, "dead"),
    # 2D training differentiates the Hiera trunk: its global blocks @1024 at
    # batch 4 (bench.py's train_2d shape), hiera_s (C 384 in 4 heads) and
    # hiera_l (C 576 in 8 heads)
    ("hiera_s global attention @1024 B 4", 4, 4, 4096, 4096, 96, 96, "hiera"),
    ("hiera_l global attention @1024 B 4", 4, 8, 4096, 4096, 72, 72, "hiera"),
]


def train_mask(kind, B, Nk):
    if kind in (None, "hiera"):
        return None
    m = np.ones((B, Nk), bool)
    if kind == "stale":
        m[:, 6 * 1024:8 * 1024] = False   # two ring slots not yet written
        m[0, 10 * 1024 + 40:] = False     # pointer slots without a pointer
        m[1, 10 * 1024 + 56:] = False
    else:
        m[0] = False
        m[1, 30:50] = False
    return torch.from_numpy(m).to(DEV)


def phase_train_kernels():
    """Phase 3b: B1 with LSE, B3 and B4 against their twins at the training
    shapes. Returns the bf16 cross-attention results per kernel."""
    rng = np.random.default_rng(5)
    best = {}
    for dtype in (torch.bfloat16, torch.float32):
        set_tf32(False)
        tol_grad = TOL_GRAD_BF16 if dtype == torch.bfloat16 else TOL_GRAD_F32
        for label, B, H, Nq, Nk, D, Dv, kind in TRAIN_CASES:
            q, k = rand(rng, (B, H, Nq, D), dtype), rand(rng, (B, H, Nk, D), dtype)
            v, do = rand(rng, (B, H, Nk, Dv), dtype), rand(rng, (B, H, Nq, Dv), dtype)
            mask = train_mask(kind, B, Nk)
            scale = 1.0 / D ** 0.5
            # forward with LSE
            out, lse = A._flash_forward(q, k, v, mask, scale, with_lse=True)
            want_out, want_lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(),
                                                             mask)
            err_out = (out.float() - want_out).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            ok = err_out <= tolerance(want_out, dtype) and err_lse <= 1e-3
            # backward pair against the twin on the same inputs, O and LSE
            o = want_out.to(dtype)
            dvec = (do.float() * o.float()).sum(-1)
            dk, dv = A.flash_attention_bwd_dkv(q, k, v, mask, do, want_lse, dvec)
            dq = A.flash_attention_bwd_dq(q, k, v, mask, do, want_lse, dvec)
            wq, wk, wv = A.flash_attention_bwd_plain(q, k, v, mask, o, want_lse, do)
            errs = {n: rel_err(g, w) for n, g, w in (("dq", dq, wq), ("dk", dk, wk),
                                                      ("dv", dv, wv))}
            abs_dkv = max((dk.float() - wk.float()).abs().max().item(),
                          (dv.float() - wv.float()).abs().max().item())
            abs_dq = (dq.float() - wq.float()).abs().max().item()
            ok = ok and max(errs.values()) <= tol_grad
            if kind == "dead":
                ok = ok and dq[0].abs().max().item() == 0 and dk[0].abs().max().item() == 0
            # the bf16 dQ pass at forced kv split counts (the wrapper's pick is
            # 4 for the self-attention, 8 for the cross-attention) and the
            # dK/dV pass at forced q split counts (its pick: 4 for the
            # self-attention, 1 for the cross-attention)
            split_errs, dkv_split_errs = {}, {}
            if dtype == torch.bfloat16 and kind != "dead":
                for sp in (1, 2, 3, 7):
                    split_errs[sp] = rel_err(A.flash_attention_bwd_dq(
                        q, k, v, mask, do, want_lse, dvec, _splits=sp), wq)
                    sk, sv = A.flash_attention_bwd_dkv(q, k, v, mask, do, want_lse, dvec,
                                                       _splits=sp)
                    dkv_split_errs[sp] = max(rel_err(sk, wk), rel_err(sv, wv))
                ok = ok and max(split_errs.values()) <= tol_grad
                ok = ok and max(dkv_split_errs.values()) <= tol_grad
            # times: kernels, twins, and the library call forward and backward
            ms_fwd = graph_ms(lambda: A._flash_forward(q, k, v, mask, scale, True))
            ms_dkv = graph_ms(lambda: A.flash_attention_bwd_dkv(q, k, v, mask, do, want_lse,
                                                                dvec))
            ms_dq = graph_ms(lambda: A.flash_attention_bwd_dq(q, k, v, mask, do, want_lse,
                                                              dvec))
            plain_fwd = cuda_ms(lambda: A.flash_attention_lse_plain(q, k, v, mask), reps=3)
            plain_bwd = cuda_ms(lambda: A.flash_attention_bwd_plain(q, k, v, mask, o, want_lse,
                                                                    do), reps=3)
            bias = None if mask is None else mask[:, None, None, :]
            lib_fwd = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
            # the library backward: forward + backward captured together, less
            # the forward
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_fb = graph_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias), (qg, kg, vg), do))
            lib_bwd = max(lib_fb - lib_fwd, 1e-6)
            keys, flops_fwd, bytes_fwd = flash_work(B, H, Nq, Nk, D, Dv, mask, q.element_size())
            it = q.element_size()
            rows = 8.0 * B * H * Nq                              # lse and dvec, fp32
            mbytes = 0 if mask is None else B * Nk
            b_fwd = bound(flops_fwd, bytes_fwd + 4.0 * B * H * Nq + mbytes, dtype)
            b_dkv = bound(2.0 * H * Nq * keys * (2 * D + 2 * Dv),
                          it * B * H * (Nq * D + 2 * Nk * D + 2 * Nk * Dv + Nq * Dv)
                          + rows + mbytes, dtype)
            b_dq = bound(2.0 * H * Nq * keys * (2 * D + Dv),
                         it * B * H * (2 * Nq * D + Nk * D + Nk * Dv + Nq * Dv) + rows + mbytes,
                         dtype)
            grid = (bf16_grid(B * H, Nq, Nk) if dtype == torch.bfloat16
                    else (B * H * -(-Nq // 64), 1))
            print(f"[3b train kernel] {label} {[B, H, Nq, Nk, D, Dv]} {dtype} | "
                  f"fwd+lse {rates(ms_fwd, flops_fwd, b_fwd[0], lib_fwd, grid)} | "
                  f"fwd+lse err {err_out:.3e} lse err {err_lse:.3e} | grad err rel max|grad| "
                  f"dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} "
                  f"(tol {tol_grad:.0e}), dq at forced splits "
                  f"{ {sp: f'{e:.3e}' for sp, e in split_errs.items()} }, dk/dv at forced "
                  f"splits { {sp: f'{e:.3e}' for sp, e in dkv_split_errs.items()} } | dq grid "
                  f"{dq_grid(B * H, Nq, Nk, Dv, dtype)} dkv grid "
                  f"{dkv_grid(B * H, Nq, Nk, dtype)} | kernel (graph) fwd+lse {ms_fwd:.4f} dkv {ms_dkv:.4f} "
                  f"dq {ms_dq:.4f} ms, dkv+dq {ms_dkv + ms_dq:.4f} ms = "
                  f"{(ms_dkv + ms_dq) / lib_bwd:.2f}x sdpa bwd | share of bound dkv "
                  f"{b_dkv[0] / ms_dkv:.1%} dq {b_dq[0] / ms_dq:.1%} | plain fwd {plain_fwd:.3f} bwd {plain_bwd:.3f} ms | "
                  f"sdpa fwd {lib_fwd:.4f} bwd {lib_bwd:.4f} ms (graph fwd+bwd "
                  f"{lib_fb:.4f} less fwd) | bound fwd {b_fwd[0]:.4f} "
                  f"dkv {b_dkv[0]:.4f} dq {b_dq[0]:.4f} ms ({b_dkv[1]}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fmt = lambda d: {k: f"{v:.3e}" for k, v in d.items()}  # noqa: E731
                raise AssertionError(f"train kernels {label} {dtype}: dk/dv at forced splits "
                                     f"{fmt(dkv_split_errs)} dq at forced splits "
                                     f"{fmt(split_errs)} grads {fmt(errs)} out {err_out:.3e} "
                                     f"lse {err_lse:.3e}")
            if dtype == torch.bfloat16 and kind == "hiera":
                for p, ms, b, abs_err in (("dkv", ms_dkv, b_dkv, abs_dkv),
                                          ("dq", ms_dq, b_dq, abs_dq)):
                    best[f"flash_attention_bwd_{p} ({D}, {Dv})"] = dict(
                        max_abs_err=abs_err, ms=ms, plain_ms=plain_bwd, bound_ms=b[0],
                        bound_by=b[1], library_ms=lib_bwd, shape=[B, H, Nq, Nk, D, Dv],
                        fwd_lse_ms=ms_fwd, sdpa_fwd_ms=lib_fwd)
            if dtype == torch.bfloat16 and kind == "stale":
                best["flash_attention_bwd_dkv"] = dict(
                    max_abs_err=abs_dkv, ms=ms_dkv, plain_ms=plain_bwd, bound_ms=b_dkv[0],
                    bound_by=b_dkv[1], library_ms=lib_bwd,
                    ms_includes_sum=dkv_grid(B * H, Nq, Nk, dtype)[1] > 1)
                best["flash_attention_bwd_dq"] = dict(
                    max_abs_err=abs_dq, ms=ms_dq, plain_ms=plain_bwd, bound_ms=b_dq[0],
                    bound_by=b_dq[1], library_ms=lib_bwd,
                    ms_includes_sum=dq_grid(B * H, Nq, Nk, Dv, dtype)[1] > 1)
            del q, k, v, do, out, lse, want_out, want_lse, o, dk, dv, dq, wq, wk, wv
            del qg, kg, vg
    best["flash_attention_bwd_dq_sum"] = dq_sum_kernel(rng)
    best["flash_attention_bwd_dkv_sum"] = dkv_sum_kernel(rng)
    torch.cuda.empty_cache()
    return best


def dkv_grid(bh: int, nq: int, nk: int, dtype):
    """(blocks, q splits) of a dK/dV launch: bf16 one block per 64 keys and
    head, split by the one-wave rule; fp32 one block per 32 keys."""
    if dtype != torch.bfloat16:
        return bh * -(-nk // 32), 1
    kv_tiles = bh * -(-nk // A.DKV_BLOCK_KEYS)
    splits = A.split_count(kv_tiles, -(-nq // A.DKV_Q_TILE), sm_count())
    return kv_tiles * splits, splits


def dkv_sum_kernel(rng) -> dict:
    """The dK/dV split sum at the training self-attention's split (4
    partials of [2 * 1024, 256] fp32 each for dK and dV), against its twin
    and one library call, ``torch.tensordot`` of the scale vector with the
    partials (once for dK and once for dV). The timed calls take five copies
    in turn (84 MB, more than the 50 MB L2), as ``dq_sum_kernel``."""
    S, rows, D = dkv_grid(2, 1024, 1024, torch.bfloat16)[1], 2048, 256
    pk, pv = rand(rng, (S, rows, D), torch.float32), rand(rng, (S, rows, D), torch.float32)
    scale = 0.0625
    gk, gv = A.flash_attention_bwd_dkv_sum(pk, pv, scale)
    wk, wv = A.flash_attention_bwd_dkv_sum_plain(pk, pv, scale)
    err = max((gk - wk).abs().max().item(), (gv - wv).abs().max().item())
    tol = 1e-6 * max(wk.abs().max().item(), wv.abs().max().item())
    ws_k, ws_v = torch.full((S,), scale, device=DEV), torch.ones(S, device=DEV)
    copies = [(pk, pv)] + [(pk.clone(), pv.clone()) for _ in range(4)]
    turn = [0]

    def cycled(fn):
        def call():
            turn[0] += 1
            return fn(*copies[turn[0] % len(copies)])
        return call

    ms = graph_ms(cycled(lambda a, b: A.flash_attention_bwd_dkv_sum(a, b, scale)))
    lib_ms = graph_ms(cycled(lambda a, b: (torch.tensordot(ws_k, a, dims=1),
                                           torch.tensordot(ws_v, b, dims=1))))
    plain_ms = cuda_ms(lambda: A.flash_attention_bwd_dkv_sum_plain(pk, pv, scale), reps=10)
    bound_ms, bound_by = bound(0.0, 4.0 * (S + 1) * rows * 2 * D, torch.float32)
    ok = err <= tol
    print(f"[3b train kernel] flash_attention_bwd_dkv_sum {S} splits x 2 x [{rows}, {D}] fp32 "
          f"max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms (graph, from HBM) "
          f"tensordot x2 {lib_ms:.4f} ms ({ms / lib_ms:.2f}x) plain {plain_ms:.4f} ms bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention_bwd_dkv_sum: err {err}")
    del copies
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


def dq_grid(bh: int, nq: int, nk: int, dv: int, dtype):
    """(blocks, kv splits) of a dQ launch: bf16 one block per
    ``dq_block_rows`` query rows and head, split by the one-wave rule; fp32
    one block per 32 rows."""
    if dtype != torch.bfloat16:
        return bh * -(-nq // 32), 1
    q_tiles = bh * -(-nq // A.dq_block_rows(dv))
    splits = A.split_count(q_tiles, -(-nk // 64), sm_count())
    return q_tiles * splits, splits


def dq_sum_kernel(rng) -> dict:
    """The dQ split sum at the training cross-attention's split (8 partials
    of [2 * 1024, 256] fp32), against its twin and one library call,
    ``torch.tensordot`` of the scale vector with the partials. The timed calls
    take five copies of the partials in turn (84 MB, more than the 50 MB L2),
    so each reads them from HBM as the bound assumes; replays of one copy,
    which stays in L2, are printed beside that."""
    S, rows, D = dq_grid(2, 1024, 10316, 64, torch.bfloat16)[1], 2048, 256
    parts = rand(rng, (S, rows, D), torch.float32)
    scale = 0.0625
    got = A.flash_attention_bwd_dq_sum(parts, scale)
    want = A.flash_attention_bwd_dq_sum_plain(parts, scale)
    w = torch.full((S,), scale, device=parts.device)
    lib = torch.tensordot(w, parts, dims=1)
    err = (got - want).abs().max().item()
    err_lib = (lib - want).abs().max().item()
    tol = 1e-6 * want.abs().max().item()
    copies = [parts] + [parts.clone() for _ in range(4)]
    turn = [0]

    def cycled(fn):
        def call():
            turn[0] += 1
            return fn(copies[turn[0] % len(copies)])
        return call

    ms = graph_ms(cycled(lambda p: A.flash_attention_bwd_dq_sum(p, scale)))
    lib_ms = graph_ms(cycled(lambda p: torch.tensordot(w, p, dims=1)))
    ms_l2 = graph_ms(lambda: A.flash_attention_bwd_dq_sum(parts, scale))
    plain_ms = cuda_ms(lambda: A.flash_attention_bwd_dq_sum_plain(parts, scale), reps=10)
    bound_ms, bound_by = bound(0.0, 4.0 * (S + 1) * rows * D, torch.float32)
    ok = err <= tol
    print(f"[3b train kernel] flash_attention_bwd_dq_sum {S} splits x [{rows}, {D}] fp32 "
          f"max_abs_err {err:.3e} (tol {tol:.3e}; tensordot's {err_lib:.3e}) kernel {ms:.4f} ms "
          f"(graph, from HBM; {ms_l2:.4f} ms with one L2-resident copy) tensordot "
          f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x) plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of bound {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention_bwd_dq_sum: err {err}")
    del copies
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


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
    ok = (err <= 1e-3 and counts["flash_attention"] and counts["kv_cached_attention"]
          and torch.isfinite(cuda_masks).all())
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
    # bf16 launches that split their kv range run the merge once each: the
    # global attention [1, 4, 4096, 96] fills the card, the memory
    # self-attention [1, 1, 4096, 256] and the kv-cached call over 4096
    # queries (8 slots of 4096 keys + the pointers) split
    tok = (cfg.image_size // 16) ** 2
    want = {"flash_attention": n_global * encoded + n_layers * tracked,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dq_sum": 0, "flash_attention_bwd_dkv_sum": 0,
            "kv_cached_attention": n_layers * tracked,
            "attention_merge": n_global * encoded * merges(4, tok, tok)
            + n_layers * tracked * (merges(1, tok, tok) + merges(1, tok, 8 * tok + 64)),
            **NO_ENCODER_LAUNCHES}
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


def train_batch(T: int, O: int, S: int, n_prompt: int, P: int = 8, seed: int = 0):
    """The JAX package's ``bench.py`` train_3d batch: random images in [0, 1],
    one square per object as ground truth and its box as the prompt on every
    prompt frame."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((1, T, O, S, S), np.float32)
    gt[:, :, :, S // 4: S // 2, S // 4: S // 2] = 1.0
    coords = np.zeros((1, n_prompt, O, P, 2), np.float32)
    labels = -np.ones((1, n_prompt, O, P), np.int32)
    coords[:, :, :, 0] = [S // 4, S // 4]
    coords[:, :, :, 1] = [S // 2, S // 2]
    labels[:, :, :, 0] = 2
    labels[:, :, :, 1] = 3
    return {"images": rng.random((1, T, S, S, 3)).astype(np.float32), "gt_masks": gt,
            "prompt_coords": coords, "prompt_labels": labels,
            "prompt_use_mask": np.zeros((1, n_prompt, O), bool),
            "obj_valid": np.ones((1, O), bool)}


def train_launches(cfg, rcfg, bf16: bool) -> dict:
    """Kernel launches of one train step, from the config. Every frame is
    encoded once (its global-attention blocks take the forward kernel, no
    LSE); each tracked frame runs L memory-attention layers of self- and
    cross-attention (forward with LSE). The mem pull d(non_prompt)/d(mem)
    runs the backward of all 2L of them; the sam pull
    d(prompt + non_prompt)/d(sam) reaches the decoder's parameters through the
    memory (earlier decoders wrote it) but not through a tracked frame's first
    self-attention, whose input is the frozen encoder's output: 2L - 1. In
    bf16 every forward whose grid leaves SMs idle splits its kv range and
    runs the merge: the global attention [1, 4, tok, 96] and the memory
    attention over O objects [O, 1, tok, *] (tok = 1024 @512). A bf16 dQ
    launch that splits runs the split sum: per tracked frame 2L - 1
    self-attention backwards (the sam pull skips one) and 2L
    cross-attention ones, over at least one memory frame of tok keys. A bf16
    dK/dV launch that splits its q range runs its split sum: the
    self-attention's O x tok keys, and the cross-attention's keys, at least
    the (max_cond_frames + num_maskmem - 1) attended frames of tok tokens.
    Training over the roped-key cache (``rcfg.kcache_enabled()``) makes the
    same calls: the cross-attention's spatial keys come from the cache
    instead of a projection of the memory, at the same shape."""
    T = rcfg.video_length
    tracked = T - len(rcfg.prompt_frames)
    L = cfg.memory_attention.num_layers
    n_global = len(cfg.trunk.global_att_blocks)
    bwd = tracked * 2 * L + tracked * (2 * L - 1)
    tok, O = (cfg.image_size // 16) ** 2, rcfg.num_objects
    merge = (n_global * T * merges(4, tok, tok) + tracked * L * 2 * merges(O, tok, tok)
             if bf16 else 0)
    dq_sum = (tracked * ((2 * L - 1) * dq_sums(O, tok, tok, 256) + 2 * L * dq_sums(O, tok, tok, 64))
              if bf16 else 0)
    cross_keys = (rcfg.max_cond_frames + cfg.num_maskmem - 1) * tok
    dkv_sum = (tracked * ((2 * L - 1) * dkv_sums(O, tok, tok) + 2 * L * dkv_sums(O, tok, cross_keys))
               if bf16 else 0)
    return {"flash_attention": n_global * T + tracked * 2 * L,
            "flash_attention_bwd_dkv": bwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dq_sum": dq_sum, "flash_attention_bwd_dkv_sum": dkv_sum,
            "kv_cached_attention": 0,
            "attention_merge": merge, **NO_ENCODER_LAUNCHES}


def train_grads(model):
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
            if p.requires_grad}


def phase_train_parity(use_kcache: bool = False):
    """Phase 6 (and 14a with ``use_kcache``, training over the roped-key
    cache): one train step on the card (kernels) and on the CPU (plain
    path), same seed and batch, fp32 with TF32 off."""
    cfg = sam2_hiera_t(image_size=512, compute_dtype="float32")
    rcfg = recipe_3d.Recipe3DConfig(video_length=4, prompt_freq=2, num_objects=1,
                                    max_cond_frames=2, use_kcache=use_kcache)
    batch = train_batch(4, 1, cfg.image_size, len(rcfg.prompt_frames), seed=3)
    set_tf32(False)
    runs = []
    for dev in (DEV, torch.device("cpu")):
        model = SAM2Model(cfg, seed=0, device=dev)
        step = recipe_3d.make_train_step(model, rcfg, recipe_3d.make_optimizers(model, rcfg))
        A.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs.append(({k: float(v) for k, v in metrics.items()}, train_grads(model),
                     A.launch_counts(), time.perf_counter() - t0))
        del model, step
    (mc, gc, counts, tc), (mp, gp, _, tp) = runs
    loss_err = max(abs(mc[k] - mp[k]) / abs(mp[k]) for k in ("prompt_loss", "non_prompt_loss"))
    largest = max(g.abs().max().item() for g in gp.values())
    worst, worst_name, zero_ok = 0.0, "", True
    for name, want in gp.items():
        got = gc[name]
        if name.startswith("sam_mask_decoder.") and name.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax is shift-invariant and the
            # decoder's attention has no RoPE): round-off on both sides
            zero_ok &= max(got.abs().max().item(), want.abs().max().item()) <= 1e-6 * largest
            continue
        if want.abs().max().item() == 0:
            zero_ok &= got.abs().max().item() == 0   # not reached (no empty-mask prompt)
            continue
        err = rel_err(got, want)
        if err > worst:
            worst, worst_name = err, name
    want_counts = train_launches(cfg, rcfg, bf16=False)
    ok = loss_err <= 1e-4 and worst <= 1e-3 and zero_ok and counts == want_counts
    tag = "14 train kcache parity" if use_kcache else "6 train parity"
    print(f"[{tag}] sam2_hiera_t @512 fp32 TF32 off, 4 frames, 1 object, use_kcache "
          f"{use_kcache}, one step: "
          f"cuda (kernels, launches {counts}, expected {want_counts}) vs cpu (plain): losses "
          f"{mc['prompt_loss']:.6f}/{mc['non_prompt_loss']:.6f} vs {mp['prompt_loss']:.6f}/"
          f"{mp['non_prompt_loss']:.6f} rel err {loss_err:.2e} (tol 1e-4) | {len(gp)} "
          f"trainable leaves, worst grad err rel max|grad| {worst:.2e} at {worst_name} "
          f"(tol 1e-3), zero-gradient leaves at round-off {zero_ok} | cuda {tc:.1f} s cpu "
          f"{tp:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: losses {loss_err}, grads {worst} at {worst_name}, "
                             f"launches {counts} vs {want_counts}")


def phase_train_full_width(power_line: str):
    """Phase 7: three bf16 train steps of sam2_hiera_t @512, 8 frames, 2
    objects (BASELINE config 3)."""
    cfg = sam2_hiera_t(image_size=512)
    rcfg = recipe_3d.Recipe3DConfig(video_length=8, prompt_freq=2, num_objects=2,
                                    max_cond_frames=4)
    batch = train_batch(8, 2, cfg.image_size, len(rcfg.prompt_frames), seed=0)
    set_tf32(False)
    model = SAM2Model(cfg, seed=0, device=DEV)
    step = recipe_3d.make_train_step(model, rcfg, recipe_3d.make_optimizers(model, rcfg))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=DEV).manual_seed(0)   # training dropout on, as the CLI
    losses = [step(batch, gen)]                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        losses.append(step(batch, gen))
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 3
    counts = A.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = model.state_dict()
    group_of = {m: g for g, mods in TRAINABLE_GROUPS.items() for m in mods}
    changed = {g: any(not torch.equal(before[k], after[k]) for k in before
                      if group_of.get(k.split(".")[0]) == g) for g in TRAINABLE_GROUPS}
    frozen_same = all(torch.equal(before[k], after[k]) for k in before
                      if k.split(".")[0] not in group_of)
    finite = all(np.isfinite(float(m[k])) for m in losses for k in m)
    want = {k: 3 * n for k, n in train_launches(cfg, rcfg, bf16=True).items()}
    ok = finite and all(changed.values()) and frozen_same and counts == want
    loss_txt = ", ".join(f"{float(m['loss']):.4f}" for m in losses)
    print(f"[7 train full width] sam2_hiera_t @512 bf16, 8 frames, 2 objects, max_cond_frames 4, "
          f"prompt_freq 2 | losses (warm-up, 3 timed) {loss_txt} finite {finite} | groups "
          f"changed {changed} frozen identical {frozen_same} | launches over 3 steps {counts} "
          f"expected {want} | {secs:.3f} s per step, {8 / secs:.2f} frames/s | peak memory "
          f"{peak:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train full width: finite {finite}, changed {changed}, frozen "
                             f"{frozen_same}, launches {counts} vs {want}")
    return counts


@contextlib.contextmanager
def encoder_switches(value: str, names=ENCODER_SWITCHES):
    """Set the encoder switches ``names`` to ``value``, and the others to
    "0", for a block of code."""
    saved = {k: os.environ.get(k) for k in ENCODER_SWITCHES}
    os.environ.update({k: (value if k in names else "0") for k in ENCODER_SWITCHES})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def linear_params(rng, out_dim, in_dim, dtype):
    """A torch Linear's weight and bias at its fan-in init scale."""
    b = in_dim ** -0.5
    return (torch.from_numpy(rng.uniform(-b, b, (out_dim, in_dim)).astype(np.float32)).to(DEV, dtype),
            torch.from_numpy(rng.uniform(-b, b, out_dim).astype(np.float32)).to(DEV, dtype))


def block_params(rng, C, dtype):
    g1, g2 = (1 + 0.1 * rand(rng, (C,), dtype) for _ in range(2))
    b1, b2 = (0.1 * rand(rng, (C,), dtype) for _ in range(2))
    wq, bq = linear_params(rng, 3 * C, C, dtype)
    wp, bp = linear_params(rng, C, C, dtype)
    w1, bm1 = linear_params(rng, 4 * C, C, dtype)
    w2, bm2 = linear_params(rng, C, 4 * C, dtype)
    return FB.BlockParams(g1, b1, wq, bq, wp, bp, g2, b2, w1, bm1, w2, bm2)


def _check(name, label, dtype, got, want, ms, plain_ms, lib_ms, bnd, best, main):
    """``ms`` and ``lib_ms`` (None without a library call): graph-replay
    device times."""
    err = (got.float() - want.float()).abs().max().item()
    tol = tolerance(want.float(), dtype)
    ok = err <= tol and bool(torch.isfinite(got).all())
    lib = f"{lib_ms:.4f} ms (graph), {ms / lib_ms:.2f}x" if lib_ms is not None else "none"
    print(f"[8 encoder kernel] {name} {label} {dtype} max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms (graph) plain {plain_ms:.3f} ms library {lib} bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.1%} of bound {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} {dtype}: err {err} (tol {tol})")
    if dtype == torch.bfloat16 and main:
        best[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                          bound_by=bnd[1], library_ms=lib_ms)


# (rows, C) of the fused MLP (B7) in phase 8, hidden 4C: the MLP tails of
# hiera_t @1024 (the first the kernels line's shape), a ragged row count, and
# the stage 2-4 tails of hiera_b+ and hiera_l @1024
MLP_CASES = ((16384, 192), (65536, 96), (4096, 384), (1024, 768), (1000, 96), (16384, 224),
             (4096, 448), (1024, 896), (16384, 288), (4096, 576), (1024, 1152))
# (Bn, ws, C, heads) of the fused window block (B8) in phase 8: hiera_t
# blocks 0 (ws 8, C 96, 1 head; the kernels line's shape) and 2 (ws 4, C 192,
# 2 heads) @1024, a ragged row count (5 ws-4 windows, 80 rows), and every
# hiera_b+ / hiera_l width @1024
BLOCK_CASES = ((1024, 8, 96, 1), (1024, 4, 192, 2), (5, 4, 192, 2), (1024, 8, 112, 2),
               (1024, 4, 224, 4), (1024, 8, 144, 2), (1024, 4, 288, 4), (16, 16, 576, 8),
               (16, 8, 1152, 16))


def phase_encoder_kernels():
    """Phase 8: B5/B6, B7 and B8 against their twins at the hiera_t @1024
    shapes and the hiera_b+ / hiera_l widths @1024. Returns the bf16
    main-shape results per kernel."""
    rng = np.random.default_rng(8)
    best, widths = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        set_tf32(False)
        it = 2 if dtype == torch.bfloat16 else 4
        # B5 / B6: hiera_t blocks 4/6/8 (64 -> 70, ws 14, 4 heads) and 11
        # (32 -> 35, ws 7, 8 heads), d 96; hiera_b+ stage 3 (ws 14, 8 heads)
        # and 4 (ws 7, 16 heads), d 56
        for (Hp, heads, ws, d, main) in ((70, 4, 14, 96, True), (35, 8, 7, 96, False),
                                         (70, 8, 14, 56, False), (35, 16, 7, 56, False)):
            C = d * heads
            qkv = rand(rng, (1, Hp, Hp, 3 * C), dtype)
            want = WA.window_attention_plain(qkv.float(), heads, ws)
            nw, n = (Hp // ws) ** 2, ws * ws
            q, k, v = qkv.reshape(1, Hp // ws, ws, Hp // ws, ws, 3, heads, d).permute(
                5, 0, 1, 3, 6, 2, 4, 7).reshape(3, nw, heads, n, d).unbind(0)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            bnd = bound(4.0 * nw * heads * n * n * d, it * Hp * Hp * 4 * C, dtype)
            plain_ms = cuda_ms(lambda: WA.window_attention_plain(qkv, heads, ws), reps=5)
            for name, fn in (("window_attention", WA.window_attention),
                             ("window_attention_v2", WA.window_attention_v2)):
                got = fn(qkv, heads, ws)
                ms = graph_ms(lambda: fn(qkv, heads, ws))
                parts, _, wgs = WA.window_query_parts(ws)
                grid = (f"{nw * heads * parts} CTAs of {wgs} warpgroups" if dtype == torch.bfloat16
                        else "fp32 FMA")
                _check(name, f"[1,{Hp},{Hp},{3 * C}] ws {ws} heads {heads} d {d} ({grid})", dtype,
                       got, want, ms, plain_ms, lib_ms, bnd, best, main)
            del qkv, q, k, v, want
        for N, C in MLP_CASES:
            main = (N, C) == MLP_CASES[0]
            x = rand(rng, (N, C), dtype)
            g, b = 1 + 0.1 * rand(rng, (C,), dtype), 0.1 * rand(rng, (C,), dtype)
            (w1, b1), (w2, b2) = linear_params(rng, 4 * C, C, dtype), linear_params(rng, C, 4 * C, dtype)
            args = (x, g, b, w1, b1, w2, b2)
            got = FM.ln_mlp_residual(*args)
            want = FM.ln_mlp_residual_plain(*args)
            ms = graph_ms(lambda: FM.ln_mlp_residual(*args))
            plain_ms = cuda_ms(lambda: FM.ln_mlp_residual_plain(*args), reps=5)
            bnd = bound(16.0 * N * C * C, it * (2 * N * C + 8 * C * C + 7 * C), dtype)
            _check("fused_mlp", f"{N}x{C}x{4 * C}", dtype, got, want, ms, plain_ms, None, bnd,
                   best, main)
            del x, args, got, want
        for Bn, ws, C, heads in BLOCK_CASES:
            main = (Bn, ws, C, heads) == BLOCK_CASES[0]
            wins = rand(rng, (Bn, ws, ws, C), dtype)
            p = block_params(rng, C, dtype)
            N, n = Bn * ws * ws, ws * ws
            got = FB.fused_window_block(wins, p, heads)
            want = FB.fused_window_block_plain(wins.reshape(-1, C), p, heads, n).reshape(wins.shape)
            ms = graph_ms(lambda: FB.fused_window_block(wins, p, heads))
            plain_ms = cuda_ms(lambda: FB.fused_window_block_plain(wins.reshape(-1, C), p, heads,
                                                                   n), reps=5)
            bnd = bound(2.0 * N * C * 12 * C + 4.0 * N * n * C,
                        it * (2 * N * C + 12 * C * C + 13 * C), dtype)
            _check("fused_block", f"N {N} C {C} ws {ws} heads {heads}", dtype, got, want, ms,
                   plain_ms, None, bnd, best, main)
            if dtype == torch.bfloat16 and N >= 1024:
                widths.setdefault(C, dict(
                    shape=f"N {N} C {C} ws {ws} heads {heads}",
                    max_abs_err=(got.float() - want.float()).abs().max().item(), ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None))
            del wins, p, got, want
    linear_rows()
    for Bn, ws, C, heads in BLOCK_CASES:
        if Bn * ws * ws >= 1024:
            block_split(Bn, ws, C, heads)
    block_chain()
    torch.cuda.empty_cache()
    best["fused_block_widths"] = widths
    return best


# (rows, C) of every encoder stage of hiera_t / s, b+ and l @1024, and the
# linears of a block at that width: (name, N, K, epilogue)
PRESET_STAGES = ((65536, 96), (16384, 192), (4096, 384), (1024, 768), (65536, 112),
                 (16384, 224), (4096, 448), (1024, 896), (65536, 144), (16384, 288),
                 (4096, 576), (1024, 1152))
EPI_NAMES = {EL.EPI_BIAS: "bias", EL.EPI_BIAS_GELU: "gelu", EL.EPI_RESIDUAL: "residual"}


def block_linears(C: int):
    return (("qkv", 3 * C, C, EL.EPI_BIAS), ("proj", C, C, EL.EPI_RESIDUAL),
            ("fc1", 4 * C, C, EL.EPI_BIAS_GELU), ("fc2", C, 4 * C, EL.EPI_RESIDUAL))


def linear_rows():
    """Phase 8: the bf16 encoder linear at every B7 / B8 linear of the four
    presets @1024, and a ragged N no allowed tile width divides (the TMA
    store clips its last column chunk), against the plain fp32 product
    rounded as the epilogue; kernel and ``F.linear`` by CUDA-graph replay."""
    rng = np.random.default_rng(81)
    bf16 = torch.bfloat16
    cases = [(M, C, *lin) for M, C in PRESET_STAGES for lin in block_linears(C)]
    cases += [(1000, 200, f"ragged {EPI_NAMES[e]}", 200, 200, e) for e in EPI_NAMES]
    for M, C, name, N, K, epi in cases:
        a = rand(rng, (M, K), bf16)
        w, b = linear_params(rng, N, K, bf16)
        resid = rand(rng, (M, N), bf16) if epi == EL.EPI_RESIDUAL else None
        got = EL.linear(a, w, b, resid, epi)
        want = EL.linear_plain(a, w, b, resid, epi)
        err = (got.float() - want.float()).abs().max().item()
        tol = tolerance(want.float(), bf16)
        ms = graph_ms(lambda: EL.linear(a, w, b, resid, epi))
        lib_ms = graph_ms(lambda: F.linear(a, w, b))
        bn = EL.tile_n(M, N, K, sm_count())
        tiles = -(-M // EL.TILE_M) * -(-N // bn)
        bnd = bound(2.0 * M * N * K,
                    2 * (M * K + N * K + M * N * (2 if resid is not None else 1) + N), bf16)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"[8 encoder linear] {name} {M}x{C}: N {N} K {K} {EPI_NAMES[epi]} | BN {bn}, "
              f"{tiles} tiles on {min(tiles, sm_count())} CTAs, {-(-tiles // sm_count())} rounds | "
              f"max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms (graph) F.linear "
              f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.1%} of bound "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"encoder linear {name} {M}x{C}: err {err} (tol {tol})")
        del a, w, b, resid, got, want


def chain_trace(fn, reps: int = 10, replays: int = 3):
    """``fn``'s kernels inside a CUDA graph of ``reps`` calls, replayed
    ``replays`` times under ``torch.profiler``: ({kernel name: device ms
    per call}, the share of the replays' span in which no kernel ran)."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            short = re.split(r"[<(]", name)[0].split("::")[-1]
            by_name[short] = by_name.get(short, 0.0) + e.time_range.end - e.time_range.start
    del graph
    if not spans:
        return {}, None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > hi:
            busy += hi - lo
            lo, hi = s0, e0
        else:
            hi = max(hi, e0)
    busy += hi - lo
    return ({k: v / (reps * replays) / 1e3 for k, v in by_name.items()},
            1.0 - busy / (spans[-1][1] - spans[0][0]))


def block_split(Bn: int, ws: int, C: int, heads: int) -> dict:
    """Phase 8: the bf16 fused block at one width split into its launches,
    each timed alone by CUDA-graph replay (LN1, qkv, the window attention,
    proj, then B7's one kernel or LN2 / fc1 / fc2), beside the whole block;
    and the block's kernels and idle share inside a replayed graph
    (``chain_trace``). Prints one line; returns the numbers."""
    rng = np.random.default_rng(82)
    bf16 = torch.bfloat16
    wins = rand(rng, (Bn, ws, ws, C), bf16)
    p = block_params(rng, C, bf16)
    N = Bn * ws * ws
    x = wins.reshape(N, C)
    normed = EL.layer_norm(x, p.norm1_weight, p.norm1_bias)
    qkv = EL.linear(normed, p.qkv_weight, p.qkv_bias)
    att = WA.window_attention(qkv.reshape(Bn, ws, ws, 3 * C), heads, ws).reshape(N, C)
    x1 = EL.linear(att, p.proj_weight, p.proj_bias, x, EL.EPI_RESIDUAL)
    parts = {"ln1": lambda: EL.layer_norm(x, p.norm1_weight, p.norm1_bias),
             "qkv": lambda: EL.linear(normed, p.qkv_weight, p.qkv_bias),
             "window": lambda: WA.window_attention(qkv.reshape(Bn, ws, ws, 3 * C), heads, ws),
             "proj": lambda: EL.linear(att, p.proj_weight, p.proj_bias, x, EL.EPI_RESIDUAL)}
    mlp = (x1, p.norm2_weight, p.norm2_bias, p.fc1_weight, p.fc1_bias, p.fc2_weight, p.fc2_bias)
    if FM.kernel_launches(C, 4 * C, 1) == 1:
        parts["mlp"] = lambda: FM.ln_mlp_residual(*mlp)
    else:
        n2 = EL.layer_norm(x1, p.norm2_weight, p.norm2_bias)
        h = EL.linear(n2, p.fc1_weight, p.fc1_bias, None, EL.EPI_BIAS_GELU)
        parts["ln2"] = lambda: EL.layer_norm(x1, p.norm2_weight, p.norm2_bias)
        parts["fc1"] = lambda: EL.linear(n2, p.fc1_weight, p.fc1_bias, None, EL.EPI_BIAS_GELU)
        parts["fc2"] = lambda: EL.linear(h, p.fc2_weight, p.fc2_bias, x1, EL.EPI_RESIDUAL)
    alone = {k: graph_ms(fn) for k, fn in parts.items()}
    block_ms = graph_ms(lambda: FB.fused_window_block(wins, p, heads))
    kernels, idle = chain_trace(lambda: FB.fused_window_block(wins, p, heads))
    tiles = {name: EL.tile_n(N, n_out, K, sm_count()) for name, n_out, K, _ in block_linears(C)
             if name in parts}
    print(f"[8 block split] N {N} C {C} ws {ws} heads {heads} | block {block_ms:.4f} ms (graph) "
          f"| alone: " + " ".join(f"{k} {v:.4f}" for k, v in alone.items())
          + f" (sum {sum(alone.values()):.4f}) | linear BN {tiles} | in a replayed graph: "
          + " ".join(f"{k} {v:.4f}" for k, v in sorted(kernels.items()))
          + f" ms, idle share {'not traced' if idle is None else f'{idle:.3f}'}", flush=True)
    return dict(block_ms=block_ms, alone=alone, kernels=kernels, idle=idle, tiles=tiles)


def block_chain():
    """Phase 8: eight bf16 fused blocks with their own weights captured in
    one CUDA graph (hiera_l's C 576 and hiera_t's C 96), replayed twice on
    new inputs; each block's output against the twin on that block's own
    input, so a launch that read its input early would miss."""
    rng = np.random.default_rng(83)
    bf16 = torch.bfloat16
    for Bn, ws, C, heads in ((16, 16, 576, 8), (1024, 8, 96, 1)):
        params = [block_params(rng, C, bf16) for _ in range(8)]
        x0 = rand(rng, (Bn, ws, ws, C), bf16)

        def chain():
            outs, y = [], x0
            for p in params:
                y = FB.fused_window_block(y, p, heads)
                outs.append(y)
            return outs

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = chain()
        worst = 0.0
        for _ in range(2):
            x0.copy_(rand(rng, (Bn, ws, ws, C), bf16))
            graph.replay()
            torch.cuda.synchronize()
            prev = x0
            for p, got in zip(params, outs):
                want = FB.fused_window_block_plain(prev.reshape(-1, C), p, heads, ws * ws)
                worst = max(worst, rel_err(got.reshape(-1, C), want))
                prev = got
        ok = worst <= TOL_BF16_REL and all(bool(torch.isfinite(o).all()) for o in outs)
        print(f"[8 block chain] 8 blocks N {Bn * ws * ws} C {C} in one CUDA graph, 2 replays: "
              f"worst block err rel max|output| {worst:.3e} (tol {TOL_BF16_REL:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"fused block chain C {C}: err {worst}")
        del graph, outs, params, x0


def test_image(size: int, seed: int) -> np.ndarray:
    """bench.py's AMG image: 24 flat-coloured discs over black, plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.zeros((size, size, 3), np.float32)
    for _ in range(24):
        cy, cx = rng.integers(0, size, 2)
        r = rng.integers(size // 50, size // 8)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)[..., None]
        img = np.where(blob, rng.random(3, np.float32) * 255, img)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


IMAGE_PROMPTS = {"points": dict(point_coords=np.array([[200.0, 150.0], [260.0, 300.0]]),
                                point_labels=np.array([1, 0])),
                 "box": dict(box=np.array([60, 80, 300, 280]), multimask_output=False)}


def phase_image_parity():
    """Phase 9: the image predictor @512 fp32 with the encoder switches on,
    card (kernels) against the same seeded model on the CPU (twins)."""
    cfg = sam2_hiera_t(image_size=512, compute_dtype="float32")
    img = test_image(400, seed=9)[:, :360]           # 400 x 360, resized to 512
    set_tf32(False)
    outs = {}
    with encoder_switches("1"):
        for dev in (DEV, torch.device("cpu")):
            pred = SAM2ImagePredictor(SAM2Model(cfg, seed=0, device=dev))
            A.reset_launch_counts()
            t0 = time.perf_counter()
            pred.set_image(img)
            counts = A.launch_counts()
            res = {k: pred.predict(**kw) for k, kw in IMAGE_PROMPTS.items()}
            outs[dev.type] = (res, counts, time.perf_counter() - t0)
            del pred
    (cres, counts, tc), (pres, _, tp) = outs["cuda"], outs["cpu"]
    want = {**{k: 0 for k in counts}, "flash_attention": global_flash(cfg),
            **encoder_launches(cfg)}
    errs = {k: max(np.abs(cres[k][2] - pres[k][2]).max(), np.abs(cres[k][1] - pres[k][1]).max())
            for k in IMAGE_PROMPTS}
    ok = max(errs.values()) <= 1e-3 and counts == want and all(
        np.isfinite(cres[k][2]).all() for k in IMAGE_PROMPTS)
    print(f"[9 image parity] sam2_hiera_t @512 fp32 TF32 off, switches on: set_image + predict "
          f"(points, box) cuda (kernels, launches {counts}) vs cpu (twins): low-res logits and "
          f"IoU max_abs_err {errs} (tol 1e-3) | cuda {tc:.1f} s cpu {tp:.1f} s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"image parity: errs {errs}, launches {counts} vs {want}")


def _sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def timed_generate(gen, img):
    """generate() with its stage split: encode (set_image), decode + score
    (the point batches, synchronised), and the rest (host filters, NMS, the
    survivors' pull, RLE and output)."""
    spent = {"encode": 0.0, "decode_score": 0.0}
    pred = gen.predictor
    orig_set, orig_batch = pred.set_image, gen._decode_score_batch

    def set_image(image):
        dt, _ = _sync_s(lambda: orig_set(image))
        spent["encode"] += dt

    def batch(*a):
        dt, out = _sync_s(lambda: orig_batch(*a))
        spent["decode_score"] += dt
        return out

    pred.set_image, gen._decode_score_batch = set_image, batch
    try:
        total, anns = _sync_s(lambda: gen.generate(img))
    finally:
        pred.set_image, gen._decode_score_batch = orig_set, orig_batch
    spent["host"] = total - spent["encode"] - spent["decode_score"]
    return total, spent, anns


def phase_image_full_width(power_line: str):
    """Phase 10: hiera_t @1024 bf16 image serving. Returns the launch counts
    of one set_image + predict with the switches on."""
    cfg = sam2_hiera_t()
    set_tf32(False)
    model = SAM2Model(cfg, seed=0, device=DEV)
    pred = SAM2ImagePredictor(model)
    img = test_image(1024, seed=0)
    # set_image A/B, switches off / on / on / off, 5 calls each after a warm-up
    times = {"0": [], "1": []}
    for value in ("0", "1", "1", "0"):
        with encoder_switches(value):
            pred.set_image(img)
            for _ in range(5):
                times[value].append(_sync_s(lambda: pred.set_image(img))[0] * 1e3)
    off_ms, on_ms = float(np.median(times["0"])), float(np.median(times["1"]))
    with encoder_switches("1"):
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        pred.set_image(img)
        masks, ious, low = pred.predict(**IMAGE_PROMPTS["points"])
        torch.cuda.synchronize()
        counts = A.launch_counts()
        by_width = dict(FB.fused_window_block.launches_by_width)
        peak_predictor = torch.cuda.max_memory_allocated() / 2 ** 30
        predict_ms = float(np.median([_sync_s(lambda: pred.predict(**IMAGE_PROMPTS["points"]))[0]
                                      for _ in range(10)])) * 1e3
        # bench.py's 2d workload: one multimask decode of 64 single-point prompts
        rng = np.random.default_rng(0)
        coords = torch.from_numpy(rng.random((64, 1, 2)).astype(np.float32) * 1024).to(DEV)
        labels = torch.ones(64, 1, dtype=torch.int32, device=DEV)

        def decode():
            with torch.no_grad():
                lo, io = amg_api._decode_point_grid(model, pred._features, coords, labels)
            return float(io.sum())

        decode()
        decode_s = min(_sync_s(decode)[0] for _ in range(5))
        # generate at 32 points per side: default and loaded thresholds
        gens = {"default": amg_api.SAM2AutomaticMaskGenerator(model, points_per_side=32),
                "loaded": amg_api.SAM2AutomaticMaskGenerator(
                    model, points_per_side=32, pred_iou_thresh=0.0, stability_score_thresh=0.0)}
        gens["default"].generate(img)                # warm-up
        torch.cuda.reset_peak_memory_stats()
        gen_res = {k: timed_generate(g, img) for k, g in gens.items()}
        peak_amg = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {**{k: 0 for k in counts}, "flash_attention": global_flash(cfg),
            **encoder_launches(cfg)}
    finite = bool(np.isfinite(low).all()) and masks.shape == (3, 1024, 1024)
    loaded_n = len(gen_res["loaded"][2])
    ok = counts == want and finite and loaded_n > 0
    gen_txt = " | ".join(
        f"generate {k} {t:.3f} s ({len(a)} masks; encode {sp['encode']:.3f} decode+score "
        f"{sp['decode_score']:.3f} host filter+NMS+RLE {sp['host']:.3f} s)"
        for k, (t, sp, a) in gen_res.items())
    print(f"[10 image full width] sam2_hiera_t @1024 bf16 | set_image switches off "
          f"{off_ms:.2f} ms on {on_ms:.2f} ms (median of 10 each, off/on/on/off) | predict "
          f"{predict_ms:.2f} ms | 2d decode 64 points x 3 masks {decode_s * 1e3:.2f} ms = "
          f"{64 * 3 / decode_s:.1f} masks/s | {gen_txt} | launches per set_image + predict "
          f"{counts} expected {want} | peak memory set_image+predict {peak_predictor:.2f} GiB, "
          f"generate {peak_amg:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"image full width: launches {counts} vs {want}, finite {finite}, "
                             f"loaded masks {loaded_n}")
    return {**counts, "fused_block_by_width": by_width}


# bf16 image embeddings with the switches on against off, relative to their
# largest |value|. The two paths round each block's two residual sums
# differently ((x + y) + b against x + (y + b)), about one bf16 ulp (2^-8)
# each, which over L blocks adds up like a random walk to sqrt(2 L) * 2^-8:
# 2.7e-2 for hiera_b+ (24 blocks), 3.8e-2 for hiera_l (48). Sound runs read
# 1.8e-2 / 3.4e-2 (NVIDIA H100, 700 W); planted faults in B7 read 0.26 (its
# one-kernel form's last hidden chunk with the wrong weights) and 0.63 (the
# linears' last k chunk dropped) on hiera_b+
# (scripts/profile_port_planted_faults.py --e2e)
TOL_BL_EMBED = 5e-2


def phase_bl_set_image(power_line: str):
    """Phase 11: sam2_hiera_b+ and sam2_hiera_l @1024 bf16 at full depth,
    set_image with the switches on against off, exact launch counts; then
    sam2_hiera_l @512 fp32 with the switches on, card against the CPU.
    Returns the summed launch counts of the two bf16 set_image calls."""
    set_tf32(False)
    img = test_image(1024, seed=11)
    total, by_width = {}, {}
    for label, make in (("sam2_hiera_b+", sam2_hiera_b_plus), ("sam2_hiera_l", sam2_hiera_l)):
        cfg = make()
        pred = SAM2ImagePredictor(SAM2Model(cfg, seed=0, device=DEV))
        times, embeds = {"0": [], "1": []}, {}
        for value in ("0", "1", "1", "0"):
            with encoder_switches(value):
                pred.set_image(img)
                for _ in range(3):
                    times[value].append(_sync_s(lambda: pred.set_image(img))[0] * 1e3)
                embeds[value] = pred._features["image_embed"].float()
        with encoder_switches("1"):
            A.reset_launch_counts()
            pred.set_image(img)
            torch.cuda.synchronize()
            counts = A.launch_counts()
            for C, n in FB.fused_window_block.launches_by_width.items():
                by_width[C] = by_width.get(C, 0) + n
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        want = {**{k: 0 for k in counts}, "flash_attention": global_flash(cfg),
                **encoder_launches(cfg)}
        err = rel_err(embeds["1"], embeds["0"])
        finite = bool(torch.isfinite(embeds["1"]).all())
        ok = counts == want and finite and err <= TOL_BL_EMBED
        print(f"[11 b+/l set_image] {label} @1024 bf16, {len(cfg.trunk.block_schedule())} "
              f"blocks | set_image switches off {np.median(times['0']):.2f} ms on "
              f"{np.median(times['1']):.2f} ms (median of 6 each, off/on/on/off) | image "
              f"embedding on vs off err rel max|embed| {err:.3e} (tol {TOL_BL_EMBED:.0e}) finite "
              f"{finite} | launches {counts} expected {want} | {power_line} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} set_image: launches {counts} vs {want}, err {err}, "
                                 f"finite {finite}")
        del pred, embeds
        torch.cuda.empty_cache()
    # hiera_l @512 fp32, switches on: kernels on the card, twins on the CPU
    cfg = sam2_hiera_l(image_size=512, compute_dtype="float32")
    img = test_image(400, seed=12)[:, :360]
    outs = {}
    with encoder_switches("1"):
        for dev in (DEV, torch.device("cpu")):
            pred = SAM2ImagePredictor(SAM2Model(cfg, seed=0, device=dev))
            A.reset_launch_counts()
            t0 = time.perf_counter()
            pred.set_image(img)
            counts = A.launch_counts()
            res = {k: pred.predict(**kw) for k, kw in IMAGE_PROMPTS.items()}
            outs[dev.type] = (res, counts, time.perf_counter() - t0)
            del pred
    (cres, counts, tc), (pres, _, tp) = outs["cuda"], outs["cpu"]
    want = {**{k: 0 for k in counts}, "flash_attention": global_flash(cfg),
            **encoder_launches(cfg)}
    errs = {k: max(np.abs(cres[k][2] - pres[k][2]).max(), np.abs(cres[k][1] - pres[k][1]).max())
            for k in IMAGE_PROMPTS}
    ok = max(errs.values()) <= 1e-3 and counts == want and all(
        np.isfinite(cres[k][2]).all() for k in IMAGE_PROMPTS)
    print(f"[11 b+/l set_image] sam2_hiera_l @512 fp32 TF32 off, switches on: set_image + "
          f"predict (points, box) cuda (kernels, launches {counts}, expected {want}) vs cpu "
          f"(twins): low-res logits and IoU max_abs_err {errs} (tol 1e-3) | cuda {tc:.1f} s "
          f"cpu {tp:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"hiera_l image parity: errs {errs}, launches {counts} vs {want}")
    torch.cuda.empty_cache()
    return {**total, "fused_block_by_width": by_width}


# ---------------------------------------------------------------------------
# The rest of the 3D session: reverse and resumed propagation, the three
# memory readouts and batched volumes
# ---------------------------------------------------------------------------

# the memory readouts, chosen as the JAX package chooses them:
# (MEDSAM2_KV_STORAGE, use_kcache)
READOUTS = {"storage": ("1", True), "read_kcache": ("0", True), "read_raw": ("1", False)}
# bf16 masks of two paths that differ only in the order of their roundings
# (the storage-order readout on B2 against the read order over the same cache
# on B1; folded volumes on B2 at B = 4 against one volume at a time on B1),
# relative to the largest |logit|: each memory-attention layer's
# cross-attention rounds P and its output to bf16 at other points (other kv
# orders and split boundaries), about one bf16 ulp (2^-8) of its output, and
# these independent roundings reach the logits as a random walk over the
# layers and the tracked frames that carry them: sqrt(4 layers x 15 frames) x
# 2^-8 = 3.0e-2. A readout that attends a wrong slot or drops the pointers
# changes the logits by O(1) of their maximum.
TOL_READOUT = 5e-2


@contextlib.contextmanager
def readout_env(readout: str):
    saved = os.environ.get("MEDSAM2_KV_STORAGE")
    os.environ["MEDSAM2_KV_STORAGE"] = READOUTS[readout][0]
    try:
        yield READOUTS[readout][1]
    finally:
        if saved is None:
            os.environ.pop("MEDSAM2_KV_STORAGE", None)
        else:
            os.environ["MEDSAM2_KV_STORAGE"] = saved


def disc_point(size: int, t: int):
    """The centre of ``volume``'s disc on frame t, in video pixels."""
    return [size * (0.3 + 0.03 * t), size * 0.45]


def bidirectional(model, video, readout: str, prompt: int, events=None):
    """A session with one click on frame ``prompt``: propagate forward, then
    ``reverse=True`` from the prompt frame, which first re-encodes the frames
    tracked forward into the ring. ``events`` (three CUDA events) time the
    two calls. Returns (forward frames, masks, reverse frames, masks)."""
    with readout_env(readout) as use_kcache:
        pred = SAM2VideoPredictor(model, use_kcache=use_kcache)
        state = pred.init_state(images=video)
        pred.add_new_points(state, prompt, 1, np.array([disc_point(video.shape[1], prompt)]),
                            np.array([1]))
        if events:
            events[0].record()
        f1, m1 = pred.propagate_in_video_batch(state)
        if events:
            events[1].record()
        f2, m2 = pred.propagate_in_video_batch(state, reverse=True)
        if events:
            events[2].record()
    return f1, m1, f2, m2


def volume_batch(V: int, T: int, size: int):
    """``bench.py``'s 3d_batch inputs: V normalised test volumes and one
    click per volume on frame 0 ([V, O=1, P=1, 2])."""
    from medsam2_tpu_torch.utils.transforms import IMAGENET_MEAN, IMAGENET_STD

    vids = np.stack([volume(T, size, seed=10 + v) for v in range(V)]).astype(np.float32) / 255
    videos = torch.from_numpy((vids - IMAGENET_MEAN) / IMAGENET_STD)
    coords = np.tile(np.array(disc_point(size, 0), np.float32), (V, 1, 1, 1))
    return videos, coords, np.ones((V, 1, 1), np.int32)


def session_spec(cfg):
    from medsam2_tpu_torch.state import memory_bank as MB

    return MB.BankSpec.from_config(cfg, max_cond_frames=1)


def readout_launches(cfg, readout: str, encodes: int, steps: int) -> dict:
    """Kernel launches of ``encodes`` frame encodes and ``steps``
    memory-attention steps of one object in ``readout``, from the config
    apart from the wrappers. Each step runs L memory self-attentions on B1
    and L cross-attentions, on B2 in storage order and on B1 in read order
    (over F = 1 + 7 slots, or Fa = 1 + 6 read slots, of P keys, and the
    pointer tokens); a bf16 launch whose blocks fill at most half the SMs
    splits and merges (``merges``)."""
    spec = session_spec(cfg)
    tok = (cfg.image_size // 16) ** 2
    L = cfg.memory_attention.num_layers
    gf = global_flash(cfg)
    storage = readout == "storage"
    keys = ((spec.max_cond_frames + spec.noncond_ring) if storage
            else spec.num_frames_attended) * tok + spec.num_ptr_tokens
    return {"flash_attention": gf * encodes + L * steps * (1 if storage else 2),
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dq_sum": 0, "flash_attention_bwd_dkv_sum": 0,
            "kv_cached_attention": L * steps if storage else 0,
            "attention_merge": gf * encodes * merges(4, tok, tok)
            + L * steps * (merges(1, tok, tok) + merges(1, tok, keys)),
            **NO_ENCODER_LAUNCHES}


def session_launches(cfg, readout: str, T: int, prompt: int) -> dict:
    """Kernel launches of ``bidirectional`` (one object), add_new_points
    included (``readout_launches``). Encoded frames: the preview, the prompt
    frame once in each propagation, every tracked frame, and, before the
    reverse call, the frames tracked forward that the feature ring (7) or
    the pointer ring (15) reaches; every tracked frame is a memory-attention
    step."""
    spec = session_spec(cfg)
    fwd, rev = T - 1 - prompt, prompt
    window = min(T - 1 - prompt, max(spec.noncond_ring, spec.ptr_ring))
    return readout_launches(cfg, readout, 1 + (1 + fwd) + (1 + window + rev), fwd + rev)


def volume_launches(cfg, V: int, T: int, fold: bool) -> dict:
    """Kernel launches of ``propagate_volumes_batched`` (one object a volume,
    one prompt frame), from the config apart from the wrappers. Folded: T
    encodes of V frames at once (the global attention at B*H = 4V), and per
    tracked frame L self-attentions at B = V on B1 and L storage-order
    cross-attentions at B = V on B2. Unfolded: each volume alone, reading the
    cache in read order on B1 (the JAX package's vmapped form does so too)."""
    spec = session_spec(cfg)
    tok = (cfg.image_size // 16) ** 2
    L = cfg.memory_attention.num_layers
    gf = global_flash(cfg)
    tracked = T - 1
    if fold:
        keys = (spec.max_cond_frames + spec.noncond_ring) * tok + spec.num_ptr_tokens
        flash, kv = gf * T + L * tracked, L * tracked
        merge = (gf * T * merges(4 * V, tok, tok)
                 + L * tracked * (merges(V, tok, tok) + merges(V, tok, keys)))
    else:
        keys = spec.num_frames_attended * tok + spec.num_ptr_tokens
        flash, kv = V * (gf * T + 2 * L * tracked), 0
        merge = V * (gf * T * merges(4, tok, tok)
                     + L * tracked * (merges(1, tok, tok) + merges(1, tok, keys)))
    return {"flash_attention": flash, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dq_sum": 0, "flash_attention_bwd_dkv_sum": 0,
            "kv_cached_attention": kv, "attention_merge": merge, **NO_ENCODER_LAUNCHES}


def check_kv_cached(tag: str, label: str, args, dtype) -> dict:
    """B2 on ``args`` (the wrapper's arguments) against its twin, timed as
    phase 3: kernel and library call by CUDA-graph replay (the library over
    k / v materialised outside the timing), the twin by CUDA events. Prints
    one line, raises on a miss; returns the case's numbers."""
    q, kc, pos, rows, pk, vs, pv, mask, layer = args
    B, Nq, C = q.shape
    F_, P, Dv, Nptr, Rr = kc.shape[1], kc.shape[3], vs.shape[-1], pk.shape[1], pos.shape[0]
    got = A.kv_cached_attention(*args)
    # the twin sums kcache + pos in the cache dtype, as the kernel does
    want = A.kv_cached_attention_plain(q.float(), kc, pos, rows, pk, vs.float(), pv.float(),
                                       mask, layer)
    err = (got.float() - want).abs().max().item()
    tol = tolerance(want, dtype)
    finite = bool(torch.isfinite(got).all())
    ms = graph_ms(lambda: A.kv_cached_attention(*args))
    plain_ms = cuda_ms(lambda: A.kv_cached_attention_plain(*args), reps=3)
    k_mat = torch.cat([(kc[:, :, layer] + pos[rows.long(), layer][None]).reshape(B, F_ * P, C),
                       pk], dim=1)[:, None]
    v_mat = torch.cat([vs.reshape(B, F_ * P, Dv), pv], dim=1)[:, None]
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, None], k_mat, v_mat, attn_mask=mask[:, None, None, :]))
    flops = 2.0 * Nq * float(mask.sum().item()) * (C + Dv)
    nbytes = q.element_size() * (B * Nq * C + B * F_ * P * C + Rr * P * C + B * Nptr * C
                                 + B * F_ * P * Dv + B * Nptr * Dv + B * Nq * Dv) + mask.numel()
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    grid = (bf16_grid(B, Nq, F_ * P + Nptr) if dtype == torch.bfloat16
            else (B * -(-Nq // 64), 1))
    ok = err <= tol and finite
    print(f"[{tag}] kv_cached_attention {label} row_of_slot {rows.tolist()} "
          f"{[B, Nq, F_, kc.shape[2], P, C, Dv, Nptr]} {dtype} max_abs_err {err:.3e} (tol "
          f"{tol:.3e}) finite {finite} kernel {ms:.4f} ms plain {plain_ms:.3f} ms sdpa "
          f"{lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) | "
          f"{rates(ms, flops, bound_ms, lib_ms, grid)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kv_cached_attention {label} {dtype}: err {err}, finite {finite}")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, splits=grid[1])


def check_read_order_flash(tag: str, label: str, q, k, v, mask, dtype) -> dict:
    """B1 as the read-order memory cross-attention runs it at inference
    (q [B, 1, Nq, 256], Dv 64, a kv mask, no LSE) against its twin, timed as
    phase 3. Prints one line, raises on a miss; returns the case's numbers."""
    B, _, Nq, C = q.shape
    Nk, Dv = k.shape[2], v.shape[3]
    got = A.flash_attention(q, k, v, kv_mask=mask)
    want = A.flash_attention_plain(q.float(), k.float(), v.float(), kv_mask=mask)
    err = (got.float() - want).abs().max().item()
    tol = tolerance(want, dtype)
    finite = bool(torch.isfinite(got).all())
    ms = graph_ms(lambda: A.flash_attention(q, k, v, kv_mask=mask))
    plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v, kv_mask=mask), reps=3)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]))
    m = mask.cpu().numpy()
    _, flops, nbytes = flash_work(B, 1, Nq, Nk, C, Dv, m, q.element_size())
    bound_ms, bound_by = bound(flops, nbytes + m.size, dtype)
    grid = bf16_grid(B, Nq, Nk) if dtype == torch.bfloat16 else (B * -(-Nq // 64), 1)
    ok = err <= tol and finite
    print(f"[{tag}] flash_attention {label} {[B, 1, Nq, Nk, C, Dv]} {dtype} max_abs_err "
          f"{err:.3e} (tol {tol:.3e}) finite {finite} kernel {ms:.4f} ms plain {plain_ms:.3f} ms "
          f"sdpa {lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) | "
          f"{rates(ms, flops, bound_ms, lib_ms, grid)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention {label} {dtype}: err {err}, finite {finite}")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, splits=grid[1])


def kv_random_args(rng, B: int, spec, rows, mask, dtype, L: int = 4, C: int = 256, Dv: int = 64):
    """The kv-cached call's arguments for a bank of ``spec`` at batch B
    (layer 2), unit-scale random tensors around the given slot -> row map
    and kv mask."""
    F_, P = spec.max_cond_frames + spec.noncond_ring, spec.mem_spatial
    Nptr, Rr = spec.num_ptr_tokens, spec.num_frames_attended
    return (rand(rng, (B, P, C), dtype), rand(rng, (B, F_, L, P, C), dtype),
            rand(rng, (Rr, L, P, C), dtype), rows, rand(rng, (B, Nptr, C), dtype),
            rand(rng, (B, F_, P, Dv), dtype), rand(rng, (B, Nptr, Dv), dtype), mask, 2)


def phase_session_kernels():
    """Phase 3c: B2 at the folded-volume batch B = 4 (hiera_t @512: 1 cond
    slot and a 7-slot ring of 1024 keys, 64 pointer tokens) with the slot ->
    row map and validity a bank gives forward and in reverse, and B1 at the
    read-order inference shape @1024 (q [1,1,4096,256] against 7 read slots
    of 4096 keys and 64 pointer tokens, Dv 64, a kv mask, no LSE), bf16 and
    fp32, against their twins; times as phase 3. Returns the bf16 results."""
    from medsam2_tpu_torch.state import memory_bank as MB

    rng = np.random.default_rng(8)
    out = {"kv_cached_attention": [], "flash_attention": []}
    spec = session_spec(sam2_hiera_t(image_size=512))
    R, P, Nptr, B = spec.noncond_ring, spec.mem_spatial, spec.num_ptr_tokens, 4
    for dtype in (torch.bfloat16, torch.float32):
        set_tf32(False)
        for reverse in (False, True):
            bank = MB.init_bank(spec, B, DEV)
            cond, tracked, cur = (15, range(14, 4, -1), 4) if reverse else (0, range(1, 11), 11)
            bank["cond_frame_idx"][:, 0] = cond
            for f in tracked:
                bank["noncond_frame_idx"][:, f % R] = f
            rows, valid = MB.kv_storage_layout(spec, bank, cur, track_in_reverse=reverse)
            ptr_valid = torch.zeros(B, Nptr, dtype=torch.bool, device=DEV)
            for b in range(B):
                ptr_valid[b, :4 * (1 + 5 * b)] = True
            mask = torch.cat([valid.repeat_interleave(P, dim=1), ptr_valid], dim=1)
            layout = "reverse" if reverse else "forward"
            res = check_kv_cached("3c session kernel",
                                  f"folded volumes @512 B={B}, {layout} layout",
                                  kv_random_args(rng, B, spec, rows, mask, dtype), dtype)
            if dtype == torch.bfloat16:
                out["kv_cached_attention"].append(res)
        Fa, Pk = 7, 4096
        Nk = Fa * Pk + Nptr
        q = rand(rng, (1, 1, Pk, 256), dtype)
        k, v = rand(rng, (1, 1, Nk, 256), dtype), rand(rng, (1, 1, Nk, 64), dtype)
        m = np.ones((1, Nk), bool)
        m[:, 3 * Pk:4 * Pk] = False            # a stale ring target
        m[:, Fa * Pk + 8:] = False             # two pointers of 4 tokens
        res = check_read_order_flash("3c session kernel",
                                     "read-order cross-attention @1024, no LSE", q, k, v,
                                     torch.from_numpy(m).to(DEV), dtype)
        if dtype == torch.bfloat16:
            out["flash_attention"].append(res)
        del q, k, v
    torch.cuda.empty_cache()
    return out


def phase_session_parity():
    """Phase 12a: sam2_hiera_t @512 fp32, TF32 off, kernels on the card
    against the plain path on the CPU: the bidirectional session (a click on
    frame 4 of 8, forward, then reverse from frame 4) through each readout,
    and two folded volumes of 4 frames. Low-res logits to 1e-3."""
    cfg = sam2_hiera_t(image_size=512, compute_dtype="float32")
    video = volume(8, 512, seed=1)
    set_tf32(False)
    models = {d: SAM2Model(cfg, seed=0, device=d) for d in (DEV, "cpu")}
    errs = {}
    with torch.no_grad():
        for readout in READOUTS:
            A.reset_launch_counts()
            t0 = time.perf_counter()
            cuda = bidirectional(models[DEV], video, readout, 4)
            torch.cuda.synchronize()
            t_cuda = time.perf_counter() - t0
            counts = A.launch_counts()
            t0 = time.perf_counter()
            cpu = bidirectional(models["cpu"], video, readout, 4)
            t_cpu = time.perf_counter() - t0
            same_frames = cuda[0] == cpu[0] == list(range(4, 8)) and \
                cuda[2] == cpu[2] == [4, 3, 2, 1, 0]
            err = max((a.cpu() - b).abs().max().item() for a, b in
                      ((cuda[1], cpu[1]), (cuda[3], cpu[3])))
            finite = bool(torch.isfinite(cuda[1]).all() and torch.isfinite(cuda[3]).all())
            # storage order runs B2; both read orders run B1 only
            ok = (same_frames and finite and err <= 1e-3 and counts["flash_attention"] > 0
                  and (readout == "storage") == (counts["kv_cached_attention"] > 0))
            errs[readout] = err
            print(f"[12 session parity] sam2_hiera_t @512 fp32 TF32 off, {readout}: click on "
                  f"frame 4 of 8, forward {cuda[0]} then reverse {cuda[2]}: cuda (launches "
                  f"{counts}) vs cpu: low-res logits max_abs_err {err:.3e} (tol 1e-3, |logits| "
                  f"max {cpu[1].abs().max().item():.2f}) | cuda {t_cuda:.1f} s cpu {t_cpu:.1f} s "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"session parity {readout}: err {err}, frames "
                                     f"{cuda[0]} {cuda[2]}, launches {counts}")
        videos, coords, labels = volume_batch(2, 4, 512)
        spec = session_spec(cfg)
        A.reset_launch_counts()
        got = propagate_volumes_batched(models[DEV], spec, videos, coords, labels, fold=True)
        counts = A.launch_counts()
        want = propagate_volumes_batched(models["cpu"], spec, videos, coords, labels, fold=True)
    err = (got.cpu() - want).abs().max().item()
    ok = (err <= 1e-3 and tuple(got.shape) == (2, 4, 1, 1, 128, 128)
          and counts["kv_cached_attention"] > 0 and bool(torch.isfinite(got).all()))
    print(f"[12 session parity] folded volumes @512 fp32, 2 volumes x 4 frames: cuda (launches "
          f"{counts}) vs cpu: low-res logits max_abs_err {err:.3e} (tol 1e-3) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"folded volume parity: err {err}, launches {counts}")
    del models
    torch.cuda.empty_cache()


def phase_session_full_width(power_line: str):
    """Phase 12b: sam2_hiera_t @1024 bf16, 16 frames, a click on frame 8,
    forward then reverse, through each readout: exact launch counts, ms per
    tracked frame, peak memory, and the storage-order masks against the
    read-order ones over the cache (``TOL_READOUT``). Returns
    {readout: launch counts}."""
    cfg = sam2_hiera_t()
    T, prompt = 16, 8
    video = volume(T, 512, seed=2)
    set_tf32(False)
    model = SAM2Model(cfg, seed=0, device=DEV)
    counts, masks = {}, {}
    for readout in READOUTS:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.no_grad():
            bidirectional(model, video, readout, prompt)             # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            f1, m1, f2, m2 = bidirectional(model, video, readout, prompt, events=ev)
            torch.cuda.synchronize()
        counts[readout] = A.launch_counts()
        masks[readout] = (m1.float(), m2.float())
        fwd_ms, rev_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        tracked = (T - 1 - prompt) + prompt
        spec = session_spec(cfg)
        window = min(T - 1 - prompt, max(spec.noncond_ring, spec.ptr_ring))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = session_launches(cfg, readout, T, prompt)
        finite = bool(torch.isfinite(m1).all() and torch.isfinite(m2).all())
        shapes = (tuple(m1.shape) == (T - prompt, 1, 1, 256, 256)
                  and tuple(m2.shape) == (prompt + 1, 1, 1, 256, 256)
                  and f1 == list(range(prompt, T)) and f2 == list(range(prompt, -1, -1)))
        ok = counts[readout] == want and finite and shapes
        print(f"[12 session full width] sam2_hiera_t @1024 bf16, {readout}, {T} frames, click "
              f"on frame {prompt}: forward {fwd_ms:.2f} ms ({T - 1 - prompt} tracked, preflight "
              f"included), reverse {rev_ms:.2f} ms ({prompt} tracked, preflight and "
              f"{window} re-encoded ring frames included) = "
              f"{(fwd_ms + rev_ms) / tracked:.2f} ms per tracked frame | launches "
              f"{counts[readout]} expected {want} | finite {finite} shapes {shapes} | peak "
              f"memory {peak:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"session full width {readout}: launches {counts[readout]} vs "
                                 f"{want}, finite {finite}, shapes {shapes}")
    for other in ("read_kcache", "read_raw"):
        scale = max(masks["storage"][i].abs().max().item() for i in (0, 1))
        err = max((masks["storage"][i] - masks[other][i]).abs().max().item() for i in (0, 1))
        agree = np.mean([((masks["storage"][i] > 0) == (masks[other][i] > 0)).float()
                         .mean().item() for i in (0, 1)])
        enforced = other == "read_kcache"
        ok = err <= TOL_READOUT * scale or not enforced
        print(f"[12 session full width] storage order vs {other}: low-res logits max_abs_err "
              f"{err:.3e} = {err / scale:.3e} of max|logits| {scale:.2f} (tol {TOL_READOUT:.0e} "
              f"of max{'' if enforced else ', not enforced: raw keys are rounded otherwise'}), "
              f"mask pixels agreeing {agree:.5f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"storage vs {other}: err {err} of max {scale}")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_volumes_full_width(power_line: str):
    """Phase 12c: ``propagate_volumes_batched`` at ``bench.py``'s 3d_batch
    shape (sam2_hiera_t @512 bf16, 4 volumes of 16 frames, one click each on
    frame 0), folded and unfolded: exact launch counts, frames/s (best of two
    calls after a warm-up, host clock, synchronised), peak memory, folded
    masks against unfolded (``TOL_READOUT``). Returns {form: launch counts}."""
    cfg = sam2_hiera_t(image_size=512)
    V, T = 4, 16
    videos, coords, labels = volume_batch(V, T, 512)
    videos = videos.to(DEV)
    spec = session_spec(cfg)
    set_tf32(False)
    model = SAM2Model(cfg, seed=0, device=DEV)
    counts, masks = {}, {}
    with torch.no_grad():
        for fold in (True, False):
            run = lambda: propagate_volumes_batched(model, spec, videos, coords, labels,  # noqa: E731
                                                    fold=fold)
            run()                                                     # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            secs = []
            for i in range(2):
                if i == 1:
                    A.reset_launch_counts()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            name = "folded" if fold else "unfolded"
            counts[name] = A.launch_counts()
            masks[name] = out.float()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = volume_launches(cfg, V, T, fold)
            finite = bool(torch.isfinite(out).all())
            ok = counts[name] == want and finite and tuple(out.shape) == (V, T, 1, 1, 128, 128)
            print(f"[12 volumes] sam2_hiera_t @512 bf16, {V} volumes x {T} frames, {name}: "
                  f"{V * T / min(secs):.2f} frames/s (calls {', '.join(f'{x:.3f}' for x in secs)} "
                  f"s) | launches {counts[name]} expected {want} | finite {finite} | peak memory "
                  f"{peak:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"volumes {name}: launches {counts[name]} vs {want}, "
                                     f"finite {finite}, shape {tuple(out.shape)}")
    scale = masks["unfolded"].abs().max().item()
    err = (masks["folded"] - masks["unfolded"]).abs().max().item()
    agree = ((masks["folded"] > 0) == (masks["unfolded"] > 0)).float().mean().item()
    ok = err <= TOL_READOUT * scale
    print(f"[12 volumes] folded vs unfolded: low-res logits max_abs_err {err:.3e} = "
          f"{err / scale:.3e} of max|logits| {scale:.2f} (tol {TOL_READOUT:.0e} of max), mask "
          f"pixels agreeing {agree:.5f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"folded vs unfolded: err {err} of max {scale}")
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Corrections on tracked frames, clear_non_cond_mem_around_input, and
# training over the roped-key cache
# ---------------------------------------------------------------------------

# bf16 first-step train losses with the roped-key cache against without it,
# relative: the cache rounds each memory's projected and rotated keys and
# its positional half to bf16 apart and adds them in bf16, where the
# per-frame projection rounds their sum once; about one bf16 ulp (2^-8) of
# each key, reaching the logits as a random walk over the 4 layers x 4
# tracked frames of phase 7's step: sqrt(16) x 2^-8 = 1.6e-2. A cache read
# at a wrong slot, or without its positional half, moves the loss by O(1).
TOL_KCACHE_LOSS = 2e-2


def session_bank(spec, B: int, reverse: bool, clear=None):
    """A bank as a session leaves it (the feature and pointer rings, no
    payload): cond frame 0 and frames 1-10 tracked forward, read at frame 11;
    or cond frame 15 and frames 14-4 tracked in reverse, read at frame 3.
    ``clear`` = (center, radius) then invalidates that window. Returns
    (bank, the frame read)."""
    from medsam2_tpu_torch.state import memory_bank as MB

    bank = MB.init_bank(spec, B, DEV)
    cond, tracked, cur = (15, range(14, 3, -1), 3) if reverse else (0, range(1, 11), 11)
    bank["cond_frame_idx"][:, 0] = cond
    for f in tracked:
        bank["noncond_frame_idx"][:, f % spec.noncond_ring] = f
        bank["ptr_frame_idx"][:, f % spec.ptr_ring] = f
    if clear is not None:
        MB.clear_noncond_window(bank, *clear)
    return bank, cur


def dead_splits(kv_mask, nq: int):
    """The kv splits of a bf16 launch at batch 1 (the wrapper's split rule
    over 64-key tiles, ``bf16_grid``) in which ``kv_mask`` [1, Nk] leaves no
    valid key."""
    nk = kv_mask.shape[1]
    tiles = -(-nk // 64)
    per_split = -(-tiles // bf16_grid(1, nq, nk)[1]) * 64
    return [i for i in range(-(-nk // per_split))
            if not kv_mask[0, i * per_split:(i + 1) * per_split].any()]


def phase_clear_kernels():
    """Phase 3d: the kernel cases ``clear_non_cond_mem_around_input`` makes,
    hiera_t @1024, bf16 and fp32, against the twins, timed as phase 3.
    B1 at the read-order inference shape ([1,1,4096,28736], D 256 / Dv 64, no
    LSE) read at frame 11 after frames 5-9 were cleared: read slots 1-5 are
    holes, so kv splits 1 and 2 of 4 (7232 keys each) hold no valid key. B2
    at the session shape (1 cond slot + 7 ring slots of 4096 keys, 64 pointer
    tokens) after frames 8-10 were cleared, forward (read at 11) and reverse
    (read at 3): ring slots 1-3, storage slots 2-4, mid-ring, so kv split 1
    of 4 (129 tiles) holds no valid key. Masks from the bank's own readouts
    (``read_bank``, ``kv_storage_layout``, ``read_ptrs``). A split without a
    valid key must give the merge weight 0 and no NaN. Returns the bf16
    results."""
    from medsam2_tpu_torch.state import memory_bank as MB

    rng = np.random.default_rng(9)
    cfg = sam2_hiera_t()
    spec = session_spec(cfg)
    P, Nptr, D = spec.mem_spatial, spec.num_ptr_tokens, spec.mem_dim
    out = {"kv_cached_attention": [], "flash_attention": []}
    for dtype in (torch.bfloat16, torch.float32):
        set_tf32(False)
        bank, cur = session_bank(spec, 1, False, clear=(7, 2))
        zeros = torch.zeros(cfg.num_maskmem, D, device=DEV)
        valid = MB.read_bank(spec, bank, cur, zeros, torch.zeros(P, D, device=DEV))[2]
        Nk = valid.shape[1]
        dead = dead_splits(valid, P)
        assert dead == [1, 2], dead
        q = rand(rng, (1, 1, P, 256), dtype)
        k, v = rand(rng, (1, 1, Nk, 256), dtype), rand(rng, (1, 1, Nk, 64), dtype)
        res = check_read_order_flash(
            "3d clear kernel", "read-order cross-attention @1024 after a clear, kv splits "
            f"{dead} of the bf16 launch's 4 without a valid key", q, k, v, valid, dtype)
        if dtype == torch.bfloat16:
            out["flash_attention"].append(res)
        del q, k, v
        for reverse in (False, True):
            bank, cur = session_bank(spec, 1, reverse, clear=(9, 1))
            rows, slot_valid = MB.kv_storage_layout(spec, bank, cur, track_in_reverse=reverse)
            ring = slot_valid[0, spec.max_cond_frames:].tolist()
            assert [i for i, ok in enumerate(ring) if not ok][:3] == [1, 2, 3], ring
            ptr_valid = MB.read_ptrs(spec, bank, cur, track_in_reverse=reverse)[1]
            mask = torch.cat([slot_valid.repeat_interleave(P, dim=1), ptr_valid], dim=1)
            assert dead_splits(mask, P) == [1], dead_splits(mask, P)
            layout = "reverse" if reverse else "forward"
            res = check_kv_cached(
                "3d clear kernel", f"session @1024 B=1, {layout} layout, ring slots 1-3 "
                "cleared (kv split 1 of the bf16 launch's 4 without a valid key)",
                kv_random_args(rng, 1, spec, rows, mask, dtype), dtype)
            if dtype == torch.bfloat16:
                out["kv_cached_attention"].append(res)
    torch.cuda.empty_cache()
    return out


def mask_at(size: int, cx: float, cy: float, r: float) -> np.ndarray:
    yy, xx = np.mgrid[:size, :size]
    return ((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2).astype(np.float32)


def correction_session(model, video, readout: str):
    """Two objects clicked on frame 0 (the disc, and a point at 70 %, 70 %),
    propagate; a point correction of object 1 on frame 9 (its ring slot is
    frame 2's) and a mask correction of object 2 on frame 5; propagate twice
    (the third reuses the consolidated decodes). Returns the three (frames,
    masks)."""
    size = video.shape[1]
    with readout_env(readout) as use_kcache:
        pred = SAM2VideoPredictor(model, max_cond_frames=1, use_kcache=use_kcache)
        state = pred.init_state(images=video)
        pred.add_new_points(state, 0, 1, np.array([disc_point(size, 0)]), np.array([1]))
        pred.add_new_points(state, 0, 2, np.array([[0.7 * size, 0.7 * size]]), np.array([1]))
        outs = [pred.propagate_in_video_batch(state)]
        pred.add_new_points(state, 9, 1, np.array([disc_point(size, 9), [0.1 * size] * 2]),
                            np.array([1, 0]))
        pred.add_new_mask(state, 5, 2, mask_at(size, 0.7 * size, 0.7 * size, 0.08 * size))
        outs += [pred.propagate_in_video_batch(state), pred.propagate_in_video_batch(state)]
    return outs


def reverse_correction_session(model, video, readout: str):
    """One object clicked on the last frame, tracked in reverse; a correction
    on frame 3 (tracked in reverse, so its decode reads the frames after
    it); reverse again. Returns the two (frames, masks)."""
    size, T = video.shape[1], video.shape[0]
    with readout_env(readout) as use_kcache:
        pred = SAM2VideoPredictor(model, max_cond_frames=1, use_kcache=use_kcache)
        state = pred.init_state(images=video)
        pred.add_new_points(state, T - 1, 1, np.array([disc_point(size, T - 1)]), np.array([1]))
        outs = [pred.propagate_in_video_batch(state, reverse=True)]
        pred.add_new_points(state, 3, 1, np.array([disc_point(size, 3)]), np.array([1]))
        outs.append(pred.propagate_in_video_batch(state, reverse=True))
    return outs


def clear_session(model, video, readout: str):
    """``clear_non_cond_mem_around_input``, one object: clicks on frames 0
    and 6 (visiting frame 6 clears the memories of frames 1-5 tracked
    before it), propagate; a correction on frame 9 (it pops the retained
    outputs of frames 2-16, its own included), then a resume from frame 10,
    which warns that the correction had no effect. Returns the two (frames,
    masks) and the warnings' count."""
    import warnings

    size = video.shape[1]
    with readout_env(readout) as use_kcache:
        pred = SAM2VideoPredictor(model, max_cond_frames=2, use_kcache=use_kcache,
                                  clear_non_cond_mem_around_input=True)
        state = pred.init_state(images=video)
        for f in (0, 6):
            pred.add_new_points(state, f, 1, np.array([disc_point(size, f)]), np.array([1]))
        outs = [pred.propagate_in_video_batch(state)]
        pred.add_new_points(state, 9, 1, np.array([disc_point(size, 9)]), np.array([1]))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs.append(pred.propagate_in_video_batch(state, start_frame_idx=10))
    return outs, len(caught)


def phase_correction_parity():
    """Phase 13a: sam2_hiera_t @512 fp32, TF32 off, kernels on the card
    against the plain path on the CPU, in each readout: the correction
    session (12 frames), the reverse correction session (8 frames) and the
    clear session (12 frames). Low-res logits of every propagation to 1e-3."""
    cfg = sam2_hiera_t(image_size=512, compute_dtype="float32")
    set_tf32(False)
    models = {d: SAM2Model(cfg, seed=0, device=d) for d in (DEV, "cpu")}
    sessions = {"correction": (correction_session, volume(12, 512, seed=3)),
                "reverse correction": (reverse_correction_session, volume(8, 512, seed=4)),
                "clear": (clear_session, volume(12, 512, seed=5))}
    with torch.no_grad():
        for name, (run, video) in sessions.items():
            for readout in READOUTS:
                A.reset_launch_counts()
                t0 = time.perf_counter()
                cuda = run(models[DEV], video, readout)
                torch.cuda.synchronize()
                t_cuda = time.perf_counter() - t0
                counts = A.launch_counts()
                t0 = time.perf_counter()
                cpu = run(models["cpu"], video, readout)
                t_cpu = time.perf_counter() - t0
                extra = ""
                if name == "clear":
                    (cuda, n_warn), (cpu, n_warn_cpu) = cuda, cpu
                    extra = f", warnings {n_warn} / {n_warn_cpu}"
                same_frames = [c[0] for c in cuda] == [c[0] for c in cpu]
                err = max((c[1].cpu() - w[1]).abs().max().item() for c, w in zip(cuda, cpu))
                finite = all(bool(torch.isfinite(c[1]).all()) for c in cuda)
                ok = (same_frames and finite and err <= 1e-3 and counts["flash_attention"] > 0
                      and (readout == "storage") == (counts["kv_cached_attention"] > 0)
                      and (name != "clear" or n_warn == n_warn_cpu == 1))
                print(f"[13 correction parity] sam2_hiera_t @512 fp32 TF32 off, {name} session, "
                      f"{readout}: orders {[c[0] for c in cuda]} | cuda (launches {counts}) vs "
                      f"cpu: low-res logits max_abs_err {err:.3e} (tol 1e-3, |logits| max "
                      f"{max(w[1].abs().max().item() for w in cpu):.2f}){extra} | cuda "
                      f"{t_cuda:.1f} s cpu {t_cpu:.1f} s {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"correction parity {name} {readout}: err {err}, "
                                         f"launches {counts}")
    del models
    torch.cuda.empty_cache()


def correction_launches(cfg, readout: str, T: int, corrections) -> dict:
    """Kernel launches of a correction round (one object, cond frame 0, the
    whole video tracked once before): a click on each frame of
    ``corrections``, then the re-propagation over all T frames
    (``readout_launches``). Encoded frames: each click's preview, the cond
    frame's preflight, for each fresh correction at f its rebuilt ring (the
    frames before it that the feature ring (7) or the pointer ring (15)
    reaches, min(f - 1, 15)) and its decode, every tracked frame, and each
    correction's memory re-encoded at its place in the order. Memory
    attention runs for every tracked frame and every correction decode."""
    spec = session_spec(cfg)
    n = len(corrections)
    tracked = T - 1 - n
    window = sum(min(f - 1, max(spec.noncond_ring, spec.ptr_ring)) for f in corrections)
    return readout_launches(cfg, readout, n + 1 + window + n + tracked + n, tracked + n)


def phase_correction_full_width(power_line: str):
    """Phase 13b: sam2_hiera_t @1024 bf16, 16 frames, a click on frame 0,
    propagate; then the correction round a clinician feels: clicks on frames
    5 and 12 and the re-propagation, host clock from the first click to the
    end of the propagation (synchronised, after a warm-up session), in each
    readout: exact launch counts, ms per tracked frame of the round, peak
    memory, storage order against read order over the cache
    (``TOL_READOUT``). Returns {readout: launch counts}."""
    cfg = sam2_hiera_t()
    T, corrections = 16, (5, 12)
    video = volume(T, 512, seed=2)
    size = video.shape[1]
    set_tf32(False)
    model = SAM2Model(cfg, seed=0, device=DEV)
    counts, masks = {}, {}
    for readout in READOUTS:
        with readout_env(readout) as use_kcache, torch.no_grad():
            for rep in range(2):                                 # warm-up, then timed
                pred = SAM2VideoPredictor(model, max_cond_frames=1, use_kcache=use_kcache)
                state = pred.init_state(images=video)
                pred.add_new_points(state, 0, 1, np.array([disc_point(size, 0)]), np.array([1]))
                pred.propagate_in_video_batch(state)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                A.reset_launch_counts()
                t0 = time.perf_counter()
                for f in corrections:
                    pred.add_new_points(state, f, 1, np.array([disc_point(size, f)]),
                                        np.array([1]))
                frames, m = pred.propagate_in_video_batch(state)
                torch.cuda.synchronize()
                round_ms = (time.perf_counter() - t0) * 1e3
        counts[readout] = A.launch_counts()
        masks[readout] = m.float()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tracked = T - 1 - len(corrections)
        want = correction_launches(cfg, readout, T, corrections)
        finite = bool(torch.isfinite(m).all())
        shapes = tuple(m.shape) == (T, 1, 1, 256, 256) and frames == list(range(T))
        consolidated = state["corr_consolidated"] == set(corrections)
        ok = counts[readout] == want and finite and shapes and consolidated
        print(f"[13 correction full width] sam2_hiera_t @1024 bf16, {readout}, {T} frames, "
              f"click on frame 0 then correction clicks on frames {list(corrections)}: round "
              f"(clicks + re-propagation) {round_ms:.2f} ms = {round_ms / tracked:.2f} ms per "
              f"tracked frame ({tracked} tracked, {len(corrections)} correction decodes and "
              f"their rebuilt rings included) | launches {counts[readout]} expected {want} | "
              f"finite {finite} shapes {shapes} consolidated {consolidated} | peak memory "
              f"{peak:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"correction full width {readout}: launches {counts[readout]} "
                                 f"vs {want}, finite {finite}, shapes {shapes}")
    scale = masks["storage"].abs().max().item()
    err = (masks["storage"] - masks["read_kcache"]).abs().max().item()
    ok = err <= TOL_READOUT * scale
    print(f"[13 correction full width] storage order vs read_kcache after the correction round: "
          f"low-res logits max_abs_err {err:.3e} = {err / scale:.3e} of max|logits| {scale:.2f} "
          f"(tol {TOL_READOUT:.0e} of max) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"correction round storage vs read_kcache: err {err} of {scale}")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_train_kcache_full_width(power_line: str):
    """Phase 14b: phase 7's bf16 train step (sam2_hiera_t @512, 8 frames, 2
    objects) with the roped-key cache on against off, in turns off, on, on,
    off, each run a fresh seeded model, a warm-up step and 3 timed steps:
    seconds per step, exact launch counts (equal: the cache changes where
    the cross-attention's keys come from, not the calls), the first step's
    losses on against off (``TOL_KCACHE_LOSS``). Returns the cache-on
    counts over 3 steps."""
    cfg = sam2_hiera_t(image_size=512)
    batch = train_batch(8, 2, cfg.image_size, 4, seed=0)
    set_tf32(False)
    secs, first, counts = {False: [], True: []}, {}, {}
    for use_kcache in (False, True, True, False):
        rcfg = recipe_3d.Recipe3DConfig(video_length=8, prompt_freq=2, num_objects=2,
                                        max_cond_frames=4, use_kcache=use_kcache)
        model = SAM2Model(cfg, seed=0, device=DEV)
        step = recipe_3d.make_train_step(model, rcfg, recipe_3d.make_optimizers(model, rcfg))
        gen = torch.Generator(device=DEV).manual_seed(0)
        m0 = step(batch, gen)
        first.setdefault(use_kcache, {k: float(v) for k, v in m0.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(batch, gen) for _ in range(3)]
        torch.cuda.synchronize()
        secs[use_kcache].append((time.perf_counter() - t0) / 3)
        counts[use_kcache] = A.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = all(np.isfinite(float(m[k])) for m in losses for k in m)
        want = {k: 3 * n for k, n in train_launches(cfg, rcfg, bf16=True).items()}
        ok = finite and counts[use_kcache] == want
        print(f"[14 train kcache] sam2_hiera_t @512 bf16, 8 frames, 2 objects, use_kcache "
              f"{use_kcache}: {secs[use_kcache][-1]:.3f} s per step | first-step losses "
              f"{first[use_kcache]['prompt_loss']:.5f}/{first[use_kcache]['non_prompt_loss']:.5f} "
              f"finite {finite} | launches over 3 steps {counts[use_kcache]} expected {want} | "
              f"peak memory {peak:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train kcache {use_kcache}: launches {counts[use_kcache]} vs "
                                 f"{want}, finite {finite}")
        del model, step
    err = max(abs(first[True][k] - first[False][k]) / abs(first[False][k])
              for k in ("prompt_loss", "non_prompt_loss"))
    ok = err <= TOL_KCACHE_LOSS
    on, off = np.mean(secs[True]), np.mean(secs[False])
    print(f"[14 train kcache] on vs off: {on:.3f} vs {off:.3f} s per step ({on / off:.3f}x; runs "
          f"on {', '.join(f'{x:.3f}' for x in secs[True])}, off "
          f"{', '.join(f'{x:.3f}' for x in secs[False])}) | first-step losses rel err "
          f"{err:.3e} (tol {TOL_KCACHE_LOSS:.0e}) | {power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train kcache on vs off: loss rel err {err}")
    torch.cuda.empty_cache()
    return counts[True]


# ---------------------------------------------------------------------------
# REFUGE 2D training: the similarity bank, recipe_2d and the train_2d CLI
# ---------------------------------------------------------------------------

# the bank draws injected into the non-empty step of phase 15 (slots of the
# first step's two writes), as the CPU tests inject the JAX package's
REFUGE_INDICES = np.array([[1, 0], [0, 0]])
# the bank's memory features card vs CPU, relative L2 (see phase_2d_parity)
TOL_BANK_FEATS_L2 = 5e-3
# the encoder switches that 2D training can take: B5 has no backward (the
# JAX package's window attention has no vjp), so its switch stays off
TRAIN_2D_SWITCHES = ("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_MLP")
# B3 / B4 launches by (D, Dv) of a step (``launches_by_width``)
BWD_COUNTED = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def refuge_batch(B: int, S: int, seed: int) -> dict:
    """``B`` synthetic fundus samples packed as the CLI packs them."""
    rng = np.random.default_rng(seed)
    return pack_refuge_batch([synthetic_fundus(rng, S) for _ in range(B)], S, S)


def train_2d_launches(cfg, B: int, nonempty: bool, bf16: bool, switches: bool = False) -> dict:
    """Kernel launches of one REFUGE step at batch B, from the config. The
    trunk trains, so each global block that reaches the flash gate runs the
    forward with LSE and then the backward pair; with a non-empty bank the
    L memory-attention layers add a self-attention [B, 1, tok, 256] and a
    cross-attention over the B drawn memories [B, 1, tok, B tok] (D 256 /
    Dv 64: the low-rank value path), each differentiated too. bf16 splits
    and sums follow ``merges`` / ``dq_sums`` / ``dkv_sums``. With the 2D
    encoder switches on, each forward runs ``encoder_launches`` B8 and B7
    calls (their backward is the twin's, no launch). Also returns the
    B3 / B4 launches by (D, Dv) under ``by_width``."""
    L = cfg.memory_attention.num_layers
    tok = (cfg.image_size // 16) ** 2
    calls = [(B * h, n, n, d, d) for h, d, n in global_blocks(cfg)]   # (bh, nq, nk, d, dv)
    if nonempty:
        calls += [(B, tok, tok, 256, 256), (B, tok, B * tok, 256, 64)] * L
    by_width = {}
    for _, _, _, d, dv in calls:
        by_width[(d, dv)] = by_width.get((d, dv), 0) + 1
    enc = encoder_launches(cfg, batch=B) if switches else NO_ENCODER_LAUNCHES
    return {"flash_attention": len(calls), "flash_attention_bwd_dkv": len(calls),
            "flash_attention_bwd_dq": len(calls),
            "flash_attention_bwd_dq_sum": sum(dq_sums(bh, nq, nk, dv)
                                              for bh, nq, nk, _, dv in calls) if bf16 else 0,
            "flash_attention_bwd_dkv_sum": sum(dkv_sums(bh, nq, nk)
                                               for bh, nq, nk, _, _ in calls) if bf16 else 0,
            "kv_cached_attention": 0,
            "attention_merge": sum(merges(bh, nq, nk) for bh, nq, nk, _, _ in calls) if bf16
            else 0,
            "window_attention": 0, "fused_mlp": enc["fused_mlp"] if switches else 0,
            "fused_block": enc["fused_block"] if switches else 0, "by_width": by_width}


def step_counts() -> dict:
    """The launch counts since the last reset, with B3 / B4's by (D, Dv)
    (one dict: every dK/dV launch has its dQ launch)."""
    widths = {name: dict(getattr(A, name).launches_by_width) for name in BWD_COUNTED}
    if widths["flash_attention_bwd_dq"] != widths["flash_attention_bwd_dkv"]:
        raise AssertionError(f"dK/dV and dQ launches differ by width: {widths}")
    return {**A.launch_counts(), "by_width": widths["flash_attention_bwd_dkv"]}


def trainable_grads(model) -> dict:
    return {n: t.grad.detach().float().cpu() for n, t in recipe_2d.named_trainables(model)}


def grad_errors(got: dict, want: dict, zero_in_exact=()):
    """(worst error relative to a leaf's max|grad| and its leaf, whether the
    leaves zero in exact arithmetic (the decoder's key biases and
    ``zero_in_exact``) or not reached hold at most round-off)."""
    largest = max(g.abs().max().item() for g in want.values())
    worst, worst_name, zero_ok = 0.0, "", True
    for name, w in want.items():
        g = got[name]
        if name in zero_in_exact or (name.startswith("sam_mask_decoder.")
                                     and name.endswith("k_proj.bias")):
            # zero in exact arithmetic (softmax is shift-invariant and the
            # decoder's attention has no RoPE): round-off on both sides
            zero_ok &= max(g.abs().max().item(), w.abs().max().item()) <= 1e-6 * largest
            continue
        if w.abs().max().item() == 0:
            zero_ok &= g.abs().max().item() == 0      # not reached (memory encoder)
            continue
        err = rel_err(g, w)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, zero_ok


def phase_2d_parity():
    """Phase 15: two REFUGE steps of sam2_hiera_t @512 fp32 (TF32 off,
    memory-attention dropout 0) at batch 2 on the card (kernels) against the
    same seeded model and batches on the CPU (plain twins): the empty-bank
    step, then the bank it wrote with injected draws. Losses, every gradient
    AdamW applies (after clipping), and the bank after each step; once with
    the encoder switches off and once with B8 and B7 on (their backward
    re-runs the twin: card against the CPU, where the forward is the twin
    too). Exact launch counts on the card, B3 / B4 by width included."""
    base = sam2_hiera_t(image_size=512, compute_dtype="float32")
    cfg = dataclasses.replace(base, memory_attention=dataclasses.replace(
        base.memory_attention, dropout=0.0))
    rcfg = recipe_2d.Recipe2DConfig(memory_bank_size=8, out_size=512)
    B = 2
    batches = [refuge_batch(B, cfg.image_size, seed=s) for s in (7, 8)]
    set_tf32(False)
    for switches in (False, True):
        runs = []                                        # the card's run, then the CPU's
        with encoder_switches("1" if switches else "0", TRAIN_2D_SWITCHES):
            for dev in (DEV, torch.device("cpu")):
                model = SAM2Model(cfg, seed=0, device=dev)
                step = recipe_2d.make_train_step_2d(model, rcfg,
                                                    recipe_2d.make_optimizer_2d(model, rcfg))
                bank = recipe_2d.init_bank(model, 8)
                out = []
                t0 = time.perf_counter()
                for i, batch in enumerate(batches):
                    A.reset_launch_counts()
                    bank, m = step(batch, bank, None, bool(i),
                                   indices=torch.from_numpy(REFUGE_INDICES) if i else None)
                    out.append(({k: float(v) for k, v in m.items()}, trainable_grads(model),
                                step_counts(), {k: v.float().cpu() for k, v in bank.items()}))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                runs.append((out, time.perf_counter() - t0))
                del model, step, bank
        ok_all = True
        for i in range(2):
            (mc, gc, counts, bc), (mp, gp, _, bp) = runs[0][0][i], runs[1][0][i]
            loss_err = max(abs(mc[k] - mp[k]) / abs(mp[k]) for k in mp)
            worst, worst_name, zero_ok = grad_errors(gc, gp)
            bank_err = max(rel_err(bc[k], bp[k]) for k in ("embeds", "iou"))
            # the memory encoder reads the thresholded prediction (pred > 0):
            # a logit within round-off of 0 flips that pixel's mask between
            # card and CPU, which moves the memory of its 16 x 16 cell by
            # O(1e-2) of the features' max (1.8e-2 at one cell on an H100)
            # but the whole tensor little in norm
            feats_max = rel_err(bc["feats"], bp["feats"])
            feats_l2 = ((bc["feats"] - bp["feats"]).norm() / bp["feats"].norm()).item()
            valid_ok = torch.equal(bc["valid"], bp["valid"])
            want = train_2d_launches(cfg, B, bool(i), bf16=False, switches=switches)
            ok = (loss_err <= 1e-4 and worst <= 1e-3 and zero_ok and bank_err <= 1e-3
                  and feats_l2 <= TOL_BANK_FEATS_L2 and valid_ok and counts == want)
            ok_all &= ok
            print(f"[15 2d parity] sam2_hiera_t @512 fp32 TF32 off, batch {B}, dropout 0, "
                  f"encoder switches {'B8+B7 on' if switches else 'off'}, step {i} "
                  f"({'bank non-empty, injected draws' if i else 'empty bank'}): cuda "
                  f"(kernels, launches {counts}, expected {want}) vs cpu (plain): losses "
                  f"{mc['loss']:.6f} vs {mp['loss']:.6f} rel err {loss_err:.2e} (tol 1e-4) | "
                  f"{len(gp)} trainable leaves, worst clipped grad err rel max|grad| "
                  f"{worst:.2e} at {worst_name} (tol 1e-3), zero leaves at round-off {zero_ok} "
                  f"| bank embeds / iou rel err {bank_err:.2e} (tol 1e-3), feats rel L2 err "
                  f"{feats_l2:.2e} (tol {TOL_BANK_FEATS_L2:.0e}; max {feats_max:.2e} of max), "
                  f"valid equal {valid_ok} "
                  f"({int(bc['valid'].sum())} slots) | cuda {runs[0][1]:.1f} s cpu "
                  f"{runs[1][1]:.1f} s for both steps {'ok' if ok else 'FAIL'}")
        if not ok_all:
            raise AssertionError(f"2d parity, switches {switches}: see the lines above")


def trace_step(fn):
    """(host ms, device busy ms, kernel launches) of one ``fn`` under
    ``torch.profiler`` (busy: the kernels' summed device time;
    ``scripts/profile_port_train.py``'s rule)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, count = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            busy_us += e.time_range.elapsed_us()
            count += 1
    return wall_ms, busy_us / 1e3, count


def phase_2d_full_width(power_line: str):
    """Phase 16: the REFUGE step at ``bench.py``'s train_2d shape, sam2_hiera_s
    @1024 bf16 batch 4 (bank 16, loss at 1024 px, dropout on as the CLI):
    a warm-up step on the empty bank and 3 timed steps on the non-empty
    one: finite losses, every parameter updated, exact launch counts of
    B1 / B3 / B4 and their merges and sums (B3 / B4 by width), seconds per
    step, images/s, peak memory, then one traced step (device busy time and
    idle share). Then one step with B8 and B7 on, exact counts; a hiera_l
    @512 bf16 step at batch 2 for the D 72 widths of B3 / B4; and the port's
    ``train_2d`` CLI on synthetic data for 2 steps and 1 validation sample.
    Returns {path: launch counts}."""
    B = 4
    cfg = sam2_hiera_s()
    rcfg = recipe_2d.Recipe2DConfig()
    set_tf32(False)
    batches = [refuge_batch(B, cfg.image_size, seed=s) for s in range(5)]
    model = SAM2Model(cfg, seed=0, device=DEV)
    step = recipe_2d.make_train_step_2d(model, rcfg, recipe_2d.make_optimizer_2d(model, rcfg))
    bank = recipe_2d.init_bank(model, rcfg.memory_bank_size)
    gen = torch.Generator(device=DEV).manual_seed(0)
    before = {n: t.detach().clone() for n, t in recipe_2d.named_trainables(model)}
    A.reset_launch_counts()
    bank, m0 = step(batches[0], bank, gen, False)                       # warm-up
    torch.cuda.synchronize()
    warm = step_counts()
    want_warm = train_2d_launches(cfg, B, False, bf16=True)
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for batch in batches[1:4]:
        bank, m = step(batch, bank, gen, True)
        metrics.append(m)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 3
    counts = step_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one = train_2d_launches(cfg, B, True, bf16=True)
    want = {k: ({w: 3 * n for w, n in v.items()} if k == "by_width" else 3 * v)
            for k, v in one.items()}
    wall_ms, busy_ms, n_kernels = trace_step(lambda: step(batches[4], bank, gen, True))
    losses = [float(x["loss"]) for x in [m0, *metrics]]
    finite = all(np.isfinite(v) for v in losses)
    after = dict(recipe_2d.named_trainables(model))
    grads = {n: t.grad for n, t in recipe_2d.named_trainables(model)}
    # every tensor with a gradient moves (Adam steps each element by about
    # lr); one without (the memory encoder behind the bank, the prompt
    # encoder behind its no-grad) keeps its value: the decay factor
    # 1 - lr wd = 1 - 1e-8 rounds to 1 in fp32, in optax as here
    with_grad = [n for n in before if grads[n].abs().max().item() > 0]
    stuck = [n for n in with_grad if torch.equal(before[n], after[n].detach())]
    updated = sum(not torch.equal(before[n], after[n].detach()) for n in before)
    ok = finite and not stuck and counts == want and warm == want_warm
    print(f"[16 2d full width] sam2_hiera_s @1024 bf16, batch {B}, bank {rcfg.memory_bank_size}, "
          f"loss at {rcfg.out_size} px | losses (warm-up, 3 timed) "
          f"{', '.join(f'{v:.4f}' for v in losses)} finite {finite} | {updated} of "
          f"{len(before)} trainable tensors updated ({len(with_grad)} with a gradient in the "
          f"last step, stuck {stuck[:3]}) | warm-up launches "
          f"{warm} expected {want_warm} | launches over 3 steps {counts} expected {want} | "
          f"{secs:.3f} s per step, {B / secs:.2f} images/s | peak memory {peak:.2f} GiB | "
          f"traced step: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels; untraced busy share (derived) "
          f"{busy_ms / (secs * 1e3):.3f} | {power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"2d full width: finite {finite}, stuck {stuck}, launches "
                             f"{counts} vs {want}, warm-up {warm} vs {want_warm}")
    paths = {"2d training": flat_counts(counts)}

    # one step with B8 and B7 forward on (the backward re-runs their twins)
    with encoder_switches("1", TRAIN_2D_SWITCHES):
        A.reset_launch_counts()
        t0 = time.perf_counter()
        bank, m = step(batches[1], bank, gen, True)
        torch.cuda.synchronize()
        on_s = time.perf_counter() - t0
        on = step_counts()
    want_on = train_2d_launches(cfg, B, True, bf16=True, switches=True)
    ok = on == want_on and np.isfinite(float(m["loss"]))
    print(f"[16 2d full width] the same step with the encoder switches B8 + B7 on: loss "
          f"{float(m['loss']):.4f}, {on_s:.3f} s | launches {on} expected {want_on} | "
          f"{power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"2d switches on: launches {on} vs {want_on}")
    paths["2d training B8+B7"] = flat_counts(on)
    del model, step, bank, before, after, grads
    torch.cuda.empty_cache()

    # hiera_l's global blocks reach B3 / B4 at (72, 72)
    cfg_l = sam2_hiera_l(image_size=512)
    model = SAM2Model(cfg_l, seed=0, device=DEV)
    rcfg_l = recipe_2d.Recipe2DConfig(out_size=512)
    step = recipe_2d.make_train_step_2d(model, rcfg_l, recipe_2d.make_optimizer_2d(model, rcfg_l))
    bank = recipe_2d.init_bank(model, 16)
    A.reset_launch_counts()
    bank, m = step(refuge_batch(2, 512, seed=9), bank, gen, False)
    bank, m2 = step(refuge_batch(2, 512, seed=10), bank, gen, True)
    torch.cuda.synchronize()
    got_l = step_counts()
    w0, w1 = (train_2d_launches(cfg_l, 2, ne, bf16=True) for ne in (False, True))
    want_l = {k: ({w: w0[k].get(w, 0) + w1[k].get(w, 0) for w in {*w0[k], *w1[k]}}
                  if k == "by_width" else w0[k] + w1[k]) for k in w0}
    ok = got_l == want_l and np.isfinite(float(m["loss"])) and np.isfinite(float(m2["loss"]))
    print(f"[16 2d full width] sam2_hiera_l @512 bf16, batch 2, two steps (empty, then "
          f"non-empty bank): losses {float(m['loss']):.4f}, {float(m2['loss']):.4f} | launches "
          f"{got_l} expected {want_l} | {power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"2d hiera_l: launches {got_l} vs {want_l}")
    paths["2d training hiera_l @512"] = flat_counts(got_l)
    del model, step, bank
    torch.cuda.empty_cache()

    # the port's CLI on the card: synthetic fundus data, 2 steps, 1 validation sample
    logdir = str(Path(__file__).resolve().parent / "build" / "train_2d_logs")
    shutil.rmtree(logdir, ignore_errors=True)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    cli_model = train_2d_cli.main(
        ["-net", "sam2", "-dataset", "synthetic", "-sam_config", "sam2_hiera_s",
         "-image_size", "1024", "-out_size", "1024", "-b", str(B), "-epochs", "1",
         "-steps_per_epoch", "2", "-val_freq", "1", "-val_max_samples", "1",
         "-logdir", logdir, "-print_freq", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli = step_counts()
    rows = [json.loads(ln) for f in Path(logdir).rglob("scalars.jsonl") for ln in open(f)]
    val = [r for r in rows if "val/dice" in json.dumps(r)]
    on_card = cli_model.device.type == "cuda"
    ok = on_card and bool(val) and cli["flash_attention_bwd_dkv"] > 0
    print(f"[16 2d cli] python -m medsam2_tpu_torch.cli.train_2d -dataset synthetic -sam_config "
          f"sam2_hiera_s -image_size 1024 -b {B}, 2 steps + 1 validation sample on "
          f"{cli_model.device}: {cli_s:.1f} s | validation scalars {val[-1] if val else None} | "
          f"launches {cli} | {power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train_2d CLI: on card {on_card}, validation {val}")
    del cli_model
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# Nuclei serving: the DPA-P2PNet prompter and the sliding-window engine
# ---------------------------------------------------------------------------

# the CPU tests' TINY SAM2 (tests/test_predictors.py), restated without them
NUCLEI_TINY = SAM2Config(
    trunk=HieraConfig(embed_dim=8, stages=(1, 1, 1, 1), window_spec=(2, 2, 2, 2),
                      global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(3, 3)),
    neck=FpnNeckConfig(backbone_channel_list=(64, 32, 16, 8)), image_size=64,
    compute_dtype="float32")
# a mask logit this close to 0 may take the other sign on the card than on
# the CPU (the two agree to ~1e-6); the instance maps are then held in AJI
NEAR_ZERO = 1e-4
# the B5 / B7 / B8 shapes of nuclei_256 (hiera_s @256): B5 on the padded
# stage-3 / stage-4 blocks ((Hp, heads, ws, d)); B7 on stage 3's 256 rows
# (the three-launch form at C 384); B8 on stages 1 and 2 ((Bn, ws, C, heads))
NUCLEI_WINDOW = ((28, 4, 14, 96), (14, 8, 7, 96))
NUCLEI_MLP = ((256, 384),)
NUCLEI_BLOCK = ((64, 8, 96, 1), (64, 4, 192, 2))
# nuclei training at batch 4 (phase 18b): B7 on stage 2's pooling block and
# stages 3 and 4, B8 on stages 1 and 2
NUCLEI_TRAIN_MLP = ((4096, 192), (1024, 384), (256, 768))
NUCLEI_TRAIN_BLOCK = ((256, 8, 96, 1), (256, 4, 192, 2))


@contextlib.contextmanager
def last_slot_draws():
    """Every similarity-bank read draws the last valid slot, on either
    device (the CPU tests' injection), so card and CPU condition on the
    same memories."""
    orig = SB.read_similarity_bank

    def read(bank, cur, generator, n, indices=None):
        idx = (bank["valid"].sum() - 1).clamp_min(0).reshape(1, 1).expand(cur.shape[0], n)
        return orig(bank, cur, generator, n, indices=idx)

    SB.read_similarity_bank = read
    try:
        yield
    finally:
        SB.read_similarity_bank = orig


@contextlib.contextmanager
def recorded_decodes(store: list):
    """``decode_cells`` also keeps each call's mask logits in ``store``."""
    orig = NI.decode_cells

    def wrapped(*a, **k):
        store.append(orig(*a, **{**k, "binary": False, "return_memory": False})[0])
        return orig(*a, **k)

    NI.decode_cells = wrapped
    try:
        yield
    finally:
        NI.decode_cells = orig


def nuclei_models(cfg, backbone: str, dev, lean: bool = False):
    """A seeded SAM2 model and prompter on ``dev``; ``lean`` sets the class
    head's output bias to (1, -1), so that random weights propose enough
    points at the small parity sizes."""
    model = SAM2Model(cfg, seed=0, device=dev)
    prompter = Prompter(PrompterConfig(backbone=backbone), seed=1, device=dev)
    if lean:
        with torch.no_grad():
            prompter.cls_head.out.bias.copy_(torch.tensor([1.0, -1.0]))
    return model, prompter


def calibrate_prompter(prompter, image: np.ndarray, points: int) -> float:
    """Shift the class head's foreground bias so that ``points`` of the
    anchors of ``image`` score as foreground. Random weights score nearly
    every anchor alike (all foreground or none); a trained prompter proposes
    about one point per cell. Returns the shift."""
    with torch.no_grad():
        logits = prompter(torch.from_numpy(image[None]).to(prompter.device))[0]["pred_logits"][0]
        margin = (logits[:, 0] - logits[:, 1]).float().cpu().numpy()
        shift = -float(np.sort(margin)[-points - 1] + np.sort(margin)[-points]) / 2
        prompter.cls_head.out.bias[0] += shift
    return shift


def nuclei_image(rng, size: int, tile: int = 250, cells: int = 30) -> dict:
    """A ``size``-px nuclei image (a multiple of ``tile``) as ``tile``-px
    ``synthetic_nuclei`` tiles of ``cells`` cells each (MoNuSeg's 1000 x
    1000 images hold several hundred nuclei), ids offset per tile."""
    n = size // tile
    img = np.zeros((size, size, 3), np.float32)
    inst = np.zeros((size, size), np.int32)
    for i in range(n):
        for j in range(n):
            s = synthetic_nuclei(rng, tile, cells)
            img[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = s["image"]
            inst[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = np.where(
                s["inst_map"] > 0, s["inst_map"] + inst.max(), 0)
    return {"image": img, "inst_map": inst}


def nuclei_kernels(power_line: str):
    """Phase 17k: B5, B7 and B8 at the nuclei_256 shapes (serving, and B7 /
    B8 at nuclei training's batch of 4) against their twins, bf16, with
    kernel, twin, library and bound times (as phase 8). Returns {kernel:
    [results]}."""
    rng = np.random.default_rng(17)
    dtype = torch.bfloat16
    set_tf32(False)
    out = {"window_attention": [], "fused_mlp": [], "fused_block": []}

    def keep(name, label, got, want, ms, plain_ms, lib_ms, bnd):
        err = (got.float() - want.float()).abs().max().item()
        tol = tolerance(want.float(), dtype)
        ok = err <= tol and bool(torch.isfinite(got).all())
        lib = f"{lib_ms:.4f} ms (graph), {ms / lib_ms:.2f}x" if lib_ms is not None else "none"
        print(f"[17k nuclei kernel] {name} {label} {dtype} max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.4f} ms (graph) plain {plain_ms:.3f} ms library {lib} bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.1%} of bound | {power_line} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: err {err} (tol {tol})")
        out[name].append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms))

    for Hp, heads, ws, d in NUCLEI_WINDOW:
        C = d * heads
        qkv = rand(rng, (1, Hp, Hp, 3 * C), dtype)
        nw, n = (Hp // ws) ** 2, ws * ws
        q, k, v = qkv.reshape(1, Hp // ws, ws, Hp // ws, ws, 3, heads, d).permute(
            5, 0, 1, 3, 6, 2, 4, 7).reshape(3, nw, heads, n, d).unbind(0)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        keep("window_attention", f"[1,{Hp},{Hp},{3 * C}] ws {ws} heads {heads} d {d}",
             WA.window_attention(qkv, heads, ws), WA.window_attention_plain(qkv.float(), heads, ws),
             graph_ms(lambda: WA.window_attention(qkv, heads, ws)),
             cuda_ms(lambda: WA.window_attention_plain(qkv, heads, ws), reps=5),
             graph_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
             bound(4.0 * nw * heads * n * n * d, 2 * Hp * Hp * 4 * C, dtype))
    for N, C in NUCLEI_MLP + NUCLEI_TRAIN_MLP:
        x = rand(rng, (N, C), dtype)
        g, b = 1 + 0.1 * rand(rng, (C,), dtype), 0.1 * rand(rng, (C,), dtype)
        w1, b1 = linear_params(rng, 4 * C, C, dtype)
        w2, b2 = linear_params(rng, C, 4 * C, dtype)
        args = (x, g, b, w1, b1, w2, b2)
        keep("fused_mlp", f"{N}x{C}x{4 * C}", FM.ln_mlp_residual(*args),
             FM.ln_mlp_residual_plain(*args), graph_ms(lambda: FM.ln_mlp_residual(*args)),
             cuda_ms(lambda: FM.ln_mlp_residual_plain(*args), reps=5), None,
             bound(16.0 * N * C * C, 2 * (2 * N * C + 8 * C * C + 7 * C), dtype))
    for Bn, ws, C, heads in NUCLEI_BLOCK + NUCLEI_TRAIN_BLOCK:
        wins = rand(rng, (Bn, ws, ws, C), dtype)
        p = block_params(rng, C, dtype)
        N, n = Bn * ws * ws, ws * ws
        keep("fused_block", f"N {N} C {C} ws {ws} heads {heads}",
             FB.fused_window_block(wins, p, heads),
             FB.fused_window_block_plain(wins.reshape(-1, C), p, heads, n).reshape(wins.shape),
             graph_ms(lambda: FB.fused_window_block(wins, p, heads)),
             cuda_ms(lambda: FB.fused_window_block_plain(wins.reshape(-1, C), p, heads, n),
                     reps=5), None,
             bound(2.0 * N * C * 12 * C + 4.0 * N * n * C, 2 * (2 * N * C + 12 * C * C + 13 * C),
                   dtype))
    torch.cuda.empty_cache()
    return out


def phase_nuclei_parity():
    """Phase 17a: TINY SAM2 (64 px, fp32, TF32 off) with resnet18 and
    pvt_v2_b0 prompters, card (kernels where the path has them) against the
    same seeded models on the CPU: the prompter's outputs, one decode of 70
    points, and ``predict_instances`` on a 64-px image and a 128-px one
    (crop 64, overlap 32: 9 crops, so that the drop of points in processed
    crops, the progressive NMS, the bank writes and the merge all run), the
    bank reads drawing its last valid slot on both. Then nuclei_256 at full
    width: one 256-px crop's image embedding in bf16 with B5, B7 and B8 on
    against fp32 with the switches off, on the card, with exact launch
    counts."""
    set_tf32(False)
    rng = np.random.default_rng(17)
    small, large = synthetic_nuclei(rng, 64, 6), synthetic_nuclei(rng, 128, 16)
    pts = rng.uniform(2, 62, (70, 2)).astype(np.float32)
    for backbone in ("resnet18", "pvt_v2_b0"):
        runs = []                                        # the card's run, then the CPU's
        for dev in (DEV, torch.device("cpu")):
            model, prompter = nuclei_models(NUCLEI_TINY, backbone, dev, lean=True)
            img = torch.from_numpy(small["image"][None]).to(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                outs = {k: v.float().cpu() for k, v in prompter(img)[0].items()}
            bank = recipe_2d.init_bank(model, 8)
            decoded = NI.decode_cells(model, pts, bank, None, img, False)
            logits = []
            with last_slot_draws(), recorded_decodes(logits):
                maps = [NI.predict_instances(model, prompter, s, bank, None, overlap=32)
                        for s in (small, large)]
            runs.append((outs, decoded, maps, logits,
                         {k: v.float().cpu() for k, v in bank.items()}, time.perf_counter() - t0))
            del model, prompter
        (oc, dc, mc, lc, bc, tc), (op, dp, mp, lp, bp, tp) = runs
        p_err = {k: (oc[k] - op[k]).abs().max().item() for k in op}
        d_err = (np.abs(dc[0] - dp[0]).max(), np.abs(dc[1] - dp[1]).max())
        flips = [((a > 0) != (b > 0)) for a, b in zip(lc, lp)] if len(lc) == len(lp) else None
        n_flip = sum(int(f.sum()) for f in flips) if flips is not None else -1
        near = max((float(np.abs(b[f]).max(initial=0.0)) for f, b in zip(flips, lp)),
                   default=0.0) if flips else 0.0
        equal = [bool(np.array_equal(a, b)) for a, b in zip(mc, mp)]
        ajis = [get_fast_aji(remap_label(b), remap_label(a)) for a, b in zip(mc, mp)]
        maps_ok = all(equal) or (n_flip > 0 and near <= NEAR_ZERO and min(ajis) >= 0.99)
        reason = ("equal" if all(equal) else
                  f"{n_flip} mask pixels differ in sign, all with |logit| <= {near:.1e}: AJI "
                  f"{[f'{a:.4f}' for a in ajis]} (>= 0.99)")
        # the bank as phase 15 holds it: a flipped pixel moves its crop's
        # memory features, little in norm
        bank_err = max(rel_err(bc[k], bp[k]) for k in ("embeds", "iou"))
        feats_l2 = ((bc["feats"] - bp["feats"]).norm() / bp["feats"].norm()).item()
        ok = (max(p_err.values()) <= 1e-3 and max(d_err) <= 1e-3 and maps_ok
              and max(m.max() for m in mp) >= 4 and bank_err <= (1e-2 if n_flip else 1e-3)
              and feats_l2 <= (TOL_BANK_FEATS_L2 if n_flip else 1e-4)
              and torch.equal(bc["valid"], bp["valid"]))
        print(f"[17a nuclei parity] TINY @64 fp32 TF32 off, {backbone} prompter: cuda vs cpu | "
              f"prompter max_abs_err {p_err} (tol 1e-3) | decode of 70 points: logits "
              f"{d_err[0]:.2e}, IoUs {d_err[1]:.2e} (tol 1e-3) | predict_instances 64 px and 128 "
              f"px (9 crops, {len(lp)} decoded): {[int(m.max()) for m in mp]} instances, maps "
              f"{reason} | bank embeds / iou rel err {bank_err:.2e} (tol 1e-3, 1e-2 after a "
              f"flip), feats rel L2 {feats_l2:.2e}, {int(bp['valid'].sum())} slots | cuda "
              f"{tc:.1f} s cpu {tp:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"nuclei parity {backbone}: see the line above")

    # nuclei_256 at full width: B5 / B7 / B8 in bf16 against fp32 plain
    crop = torch.from_numpy(synthetic_nuclei(rng, 256, 24)["image"][None]).to(DEV)
    embeds, counts = {}, None
    for label, cfg, switches in (("bf16 on", nuclei_256(), "1"),
                                 ("fp32 off", nuclei_256(compute_dtype="float32"), "0")):
        model = SAM2Model(cfg, seed=0, device=DEV)
        bank = recipe_2d.init_bank(model, 16)
        with encoder_switches(switches), torch.no_grad():
            A.reset_launch_counts()
            embeds[label] = recipe_2d.encode_and_condition(model, crop, bank, None, False, 1)[0]
            torch.cuda.synchronize()
            if switches == "1":
                counts = A.launch_counts()
        del model
    cfg = nuclei_256()
    want = {**{k: 0 for k in counts}, **encoder_launches(cfg)}
    err = rel_err(embeds["bf16 on"], embeds["fp32 off"])
    finite = bool(torch.isfinite(embeds["bf16 on"]).all())
    ok = counts == want and finite and err <= TOL_BL_EMBED
    print(f"[17a nuclei parity] nuclei_256 (sam2_hiera_s @256, {len(cfg.trunk.block_schedule())} "
          f"blocks) one crop's image embedding, bf16 with B5/B7/B8 on vs fp32 switches off: err "
          f"rel max|embed| {err:.3e} (tol {TOL_BL_EMBED:.0e}) finite {finite} | launches {counts} "
          f"expected {want} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"nuclei_256 switches: err {err}, launches {counts} vs {want}")
    torch.cuda.empty_cache()


NUCLEI_STAGES = {"prompter": "predict_points", "encode": "encode_and_condition",
                 "decode": "decode_chunk", "bank_write": "write_memory",
                 "merge": "merge_instances"}


@contextlib.contextmanager
def nuclei_stage_timers(spent: dict):
    """Each stage of the engine (``NUCLEI_STAGES``) timed by the host clock,
    synchronised, into ``spent`` (seconds and calls)."""
    origs = {k: getattr(NI, name) for k, name in NUCLEI_STAGES.items()}

    def wrap(k, fn):
        def timed(*a, **kw):
            dt, out = _sync_s(lambda: fn(*a, **kw))
            spent[k] = spent.get(k, 0.0) + dt
            spent[k + "_calls"] = spent.get(k + "_calls", 0) + 1
            return out
        return timed

    for k, name in NUCLEI_STAGES.items():
        setattr(NI, name, wrap(k, origs[k]))
    try:
        yield
    finally:
        for k, name in NUCLEI_STAGES.items():
            setattr(NI, name, origs[k])


def nuclei_run(model, prompter, samples, bank, gen):
    """``predict_instances`` over ``samples``: (seconds, instances, launch
    counts with B8's by width, decoded crops, stage split, seconds under the
    timers). Synchronised host clock; the stage split comes from a second
    pass under the timers (a run under them is slower)."""
    encodes = []
    orig = NI.encode_and_condition

    def counted(*a, **k):
        encodes.append(1)
        return orig(*a, **k)

    A.reset_launch_counts()
    NI.encode_and_condition = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_inst = sum(int(NI.predict_instances(model, prompter, s, bank, gen).max())
                     for s in samples)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        NI.encode_and_condition = orig
    counts = {**A.launch_counts(),
              "fused_block_by_width": dict(FB.fused_window_block.launches_by_width)}
    spent = {}
    with nuclei_stage_timers(spent):
        t1 = time.perf_counter()
        for s in samples:
            NI.predict_instances(model, prompter, s, bank, gen)
        total = time.perf_counter() - t1
    spent["host_rest"] = total - sum(v for k, v in spent.items() if not k.endswith("_calls"))
    return secs, n_inst, counts, len(encodes), spent, total


def split_text(spent: dict, total: float, n: int) -> str:
    keys = ("prompter", "encode", "decode", "bank_write", "merge", "host_rest")
    return ", ".join(f"{k} {spent.get(k, 0.0) / n:.4f}" for k in keys) + (
        f" s per image (of {total / n:.4f} under the timers; {spent.get('encode_calls', 0)} "
        f"decoded crops, {spent.get('decode_calls', 0)} decode chunks)")


def phase_nuclei_full_width(power_line: str):
    """Phase 17b: nuclei_256 (sam2_hiera_s @256, bf16, bank 16) with the
    pvt_v2_b2 prompter, seeded random weights (the JAX init's distributions),
    the class head's foreground bias shifted so that the prompter proposes
    24 points on the first image (``calibrate_prompter``), as ``bench.py``'s
    nuclei mode runs it: 8 ``synthetic_nuclei`` 256-px images of 24
    cells after two warm-up passes (the second reaches the non-empty bank's
    encode), then two 1000 x 1000 images (25 crops each at stride 192), with
    the encoder switches off and on: images/s, seconds per image, the stage
    split, exact launch counts per decoded crop, peak memory; one traced
    256-px image (device busy share); then the 256-px run once with the
    resnet50 prompter (the CLI's default). PyTorch's TF32 defaults (on for
    convolutions only). Returns the launch counts of the switches-on 256-px
    run."""
    cfg = nuclei_256()
    # PyTorch's defaults, as a user runs it: the fp32 prompter's convolutions
    # on TF32 tensor cores, fp32 matmuls without
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    rng = np.random.default_rng(0)
    samples = [synthetic_nuclei(rng, cfg.image_size, 24) for _ in range(8)]
    big = [nuclei_image(rng, 1000) for _ in range(2)]
    model, prompter = nuclei_models(cfg, "pvt_v2_b2", DEV)
    shift = calibrate_prompter(prompter, samples[0]["image"], 24)
    gen = torch.Generator(device=DEV).manual_seed(1)
    per_crop = encoder_launches(cfg)
    result = None
    for switches in ("0", "1"):
        with encoder_switches(switches):
            bank = recipe_2d.init_bank(model, 16)
            for _ in range(2):
                NI.predict_instances(model, prompter, samples[0], bank, gen)
            torch.cuda.reset_peak_memory_stats()
            secs, n_inst, counts, encodes, spent, total = nuclei_run(
                model, prompter, samples, bank, gen)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            by_width = counts.pop("fused_block_by_width")
            want = {**{k: 0 for k in counts},
                    **({k: encodes * v for k, v in per_crop.items()} if switches == "1" else {})}
            ok = counts == want and n_inst > 0
            name = "nuclei_e2e_images_per_sec_nuclei_256_pvt_v2_b2"
            print(f"[17b nuclei full width] nuclei_256 bf16 + pvt_v2_b2 prompter (foreground "
                  f"bias shifted {shift:+.3f}: 24 of 256 anchors on the first image), switches "
                  f"{'on' if switches == '1' else 'off'}: {name} {len(samples) / secs:.3f} "
                  f"({secs / len(samples):.4f} s per image, {n_inst} instances over 8 images) | "
                  f"split {split_text(spent, total, len(samples))} | launches {counts} expected "
                  f"{want} ({encodes} encodes x {per_crop if switches == '1' else 'none'}) | peak "
                  f"memory {peak:.2f} GiB | {power_line} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"nuclei 256: launches {counts} vs {want}, {n_inst} instances")
            if switches == "1":
                result = {**counts, "fused_block_by_width": by_width}
            torch.cuda.reset_peak_memory_stats()
            secs_b, n_b, counts_b, enc_b, spent_b, total_b = nuclei_run(
                model, prompter, big, bank, gen)
            counts_b.pop("fused_block_by_width")
            peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
            want_b = {**{k: 0 for k in counts_b},
                      **({k: enc_b * v for k, v in per_crop.items()} if switches == "1" else {})}
            ok = counts_b == want_b and n_b > 0 and enc_b > 0
            print(f"[17b nuclei full width] 1000 x 1000 images (MoNuSeg's size, 25 crops each), "
                  f"switches {'on' if switches == '1' else 'off'}: {secs_b / len(big):.3f} s per "
                  f"image, {n_b} instances over 2 | split {split_text(spent_b, total_b, len(big))} "
                  f"| launches {counts_b} expected {want_b} | peak memory {peak_b:.2f} GiB | "
                  f"{power_line} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"nuclei 1000: launches {counts_b} vs {want_b}, {n_b} "
                                     f"instances, {enc_b} encodes")
    wall_ms, busy_ms, n_kernels = trace_step(
        lambda: NI.predict_instances(model, prompter, samples[1], bank, gen))
    print(f"[17b nuclei full width] one traced 256-px image (switches off): host {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}, {n_kernels} kernels "
          f"| {power_line}")
    del prompter
    prompter = Prompter(PrompterConfig(backbone="resnet50"), seed=1, device=DEV)
    shift = calibrate_prompter(prompter, samples[0]["image"], 24)
    bank = recipe_2d.init_bank(model, 16)
    for _ in range(2):
        NI.predict_instances(model, prompter, samples[0], bank, gen)
    A.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_inst = sum(int(NI.predict_instances(model, prompter, s, bank, gen).max()) for s in samples)
    secs = time.perf_counter() - t0
    ok = n_inst > 0
    print(f"[17b nuclei full width] nuclei_256 bf16 + resnet50 prompter (the CLI's default; "
          f"foreground bias shifted {shift:+.3f}), switches off: {len(samples) / secs:.3f} "
          f"images/s ({secs / len(samples):.4f} s per image, {n_inst} instances) | {power_line} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("nuclei resnet50: no instance")
    del model, prompter, bank
    set_tf32(False)
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# Nuclei training: the prompter and SAM2 trained jointly (recipe_nuclei)
# ---------------------------------------------------------------------------

# zero in exact arithmetic: the mask head's BatchNorm takes its conv's bias out
NUCLEI_ZERO_LEAVES = ("prompter.mask_head.conv1.bias",)
# the prompter's gradients card vs CPU at 256 px, relative L2 over all its
# leaves. Its ReLU networks have ~10^6 inputs a step at 256 px, and those
# within round-off of 0 take the other side on the card (at 64 px none did:
# 3.0e-5 of max); each flip moves one leaf's gradient, by up to 2.6e-2 of
# its max in the first step on an H100 (relative L2 2.8e-3), and 0.2 (L2
# 6.1e-2) in the second after the first step's flipped
# elements had parted the weights by 2 lr: the second step now starts from
# one state. The SAM2 leaves, which carry B7 / B8, stay at 1e-3 of max; the
# prompter's leaves at 1e-3 of max at 64 px.
TOL_PROMPTER_GRAD_L2 = 5e-2
# a SAM2 leaf card vs CPU at 256 px: the trunk's q-pooling is a max-pool,
# and a window whose two largest inputs lie within round-off takes the
# other one on the card, which moves the pooled block's projection
# gradient (hiera_t's block 1 proj: 1.97e-3 of its max in the second step,
# from one state on both devices, on an H100; 2.9e-6 in the first step).
# Each leaf is held to 1e-3 of its max, or to this with the
# whole SAM2 gradient within 1e-3 in relative L2.
TOL_SAM_GRAD_FLIP = 1e-2
NUCLEI_INDICES = np.array([[1, 0], [0, 0]])


def nuclei_batch(B: int, S: int, M: int, seed: int, cells: int = 24, textured: bool = False):
    """``B`` synthetic nuclei images of ``cells`` cells packed into ``M``
    slots as the CLI packs them; ``textured`` swaps the images for
    unit-normal noise under the same cells (card vs CPU: a ReLU input
    within round-off of 0 takes the other side on a flat image, and the
    flat background's cancelling contributions then move the prompter's
    gradients by up to 5 % of their max, measured between the packages)."""
    rng = np.random.default_rng(seed)
    batch = pack_nuclei_batch([synthetic_nuclei(rng, S, cells) for _ in range(B)], S, S, M)
    if textured:
        batch["images"] = rng.standard_normal(batch["images"].shape).astype(np.float32)
    return batch


def nuclei_train_launches(cfg, B: int, steps: int, switches: bool) -> dict:
    """Kernel launches of ``steps`` nuclei steps at batch B: no attention
    reaches the flash gate at these sizes (the top level's queries are
    (S / 16)^2 <= 256 tokens), so only B8 and B7 run, ``encoder_launches``
    a forward with the switches on (their backward is the twin's)."""
    enc = encoder_launches(cfg, batch=B) if switches else NO_ENCODER_LAUNCHES
    return {**{k: 0 for k in A.launch_counts()},
            **{k: steps * v for k, v in enc.items() if k != "window_attention"},
            "window_attention": 0}


def nuclei_models_train(cfg, rcfg, dev):
    """A seeded SAM2 model and prompter on ``dev`` with the recipe's
    optimizer and step."""
    model = SAM2Model(cfg, seed=0, device=dev)
    prompter = Prompter(rcfg.prompter, seed=1, device=dev)
    opt = recipe_nuclei.make_optimizer_nuclei(model, prompter, rcfg)
    return model, prompter, opt, recipe_nuclei.make_train_step_nuclei(model, prompter, rcfg, opt)


def nuclei_trainables(model, prompter) -> dict:
    """A copy of the trainable tensors on the host (on the CPU ``.cpu()``
    would alias the live parameters)."""
    return {n: t.detach().float().cpu().clone()
            for n, t in recipe_nuclei.named_trainables(model, prompter)}


def phase_nuclei_train_parity():
    """Phase 18a: two nuclei steps (the empty bank, then the bank the first
    wrote with injected draws), card against the same seeded models and
    batches on the CPU, fp32 with TF32 off, the resnet18 prompter, memory
    attention and head dropout 0, textured images under synthetic cells
    (``nuclei_batch``): at TINY (64 px) with the encoder switches off (its
    8-channel, head-dim-8 windows are outside B8's built widths), and at
    sam2_hiera_t @256 (dense embedding 16, the nuclei_256 rule) with the
    switches off and with B8 + B7 on (forward the kernels, backward their
    twins); at 256 px the second step starts from the CPU's state on both
    devices. Phase 15's tolerances: the six losses, every clipped gradient
    (the prompter's at 256 px in relative L2, ``TOL_PROMPTER_GRAD_L2``),
    then the parameters after AdamW (each element within two lr steps of
    the CPU's, Adam moving an element whose gradient is round-off by its
    sign), the mask head's running statistics, and the bank (memory
    features in relative L2). Exact launch counts on the card."""
    set_tf32(False)
    pcfg = PrompterConfig(backbone="resnet18", dropout=0.0)
    t_base = sam2_hiera_t(image_size=256, dense_embed_size=16, compute_dtype="float32")
    cases = (("TINY @64", NUCLEI_TINY, 2, 6, False),
             ("sam2_hiera_t @256", t_base, 2, 16, False),
             ("sam2_hiera_t @256", t_base, 2, 16, True))
    for label, base, B, M, switches in cases:
        cfg = dataclasses.replace(base, memory_attention=dataclasses.replace(
            base.memory_attention, dropout=0.0))
        S = cfg.image_size
        rcfg = recipe_nuclei.NucleiRecipeConfig(prompter=pcfg, memory_bank_size=8, max_cells=M,
                                                out_size=S)
        batches = [nuclei_batch(B, S, M, seed=s, cells=M // 2 + 2, textured=True)
                   for s in (12, 13)]
        runs = ([], [])                                  # the card's steps, the CPU's
        secs = [0.0, 0.0]
        with encoder_switches("1" if switches else "0", TRAIN_2D_SWITCHES):
            sides = [nuclei_models_train(cfg, rcfg, dev) for dev in (DEV, torch.device("cpu"))]
            banks = [recipe_2d.init_bank(side[0], 8) for side in sides]
            for i, batch in enumerate(batches):
                if i and S > 64:
                    # 256 px: the second step starts from the CPU's state on
                    # both (see TOL_PROMPTER_GRAD_L2: flipped ReLUs part the
                    # prompters in the first step, and its points then steer
                    # SAM2's prompts)
                    for dst, src in zip(sides[0][:3], sides[1][:3]):
                        dst.load_state_dict(copy.deepcopy(src.state_dict()))
                    banks[0] = {k: v.to(DEV) for k, v in banks[1].items()}
                for j, (model, prompter, opt, step) in enumerate(sides):
                    A.reset_launch_counts()
                    t0 = time.perf_counter()
                    banks[j], m = step(batch, banks[j], bool(i),
                                       indices=torch.from_numpy(NUCLEI_INDICES) if i else None)
                    grads = {n: t.grad.detach().float().cpu().clone()
                             for n, t in recipe_nuclei.named_trainables(model, prompter)}
                    secs[j] += time.perf_counter() - t0
                    bn = prompter.mask_head.bn
                    runs[j].append(({k: float(v) for k, v in m.items()}, grads, A.launch_counts(),
                                    {k: v.float().cpu().clone() for k, v in banks[j].items()},
                                    nuclei_trainables(model, prompter),
                                    torch.cat([bn.running_mean, bn.running_var]).float().cpu()))
            del sides, banks
        ok_all = True
        for i in range(2):
            (mc, gc, counts, bc, pc, sc), (mp, gp, _, bp, pp, sp) = runs[0][i], runs[1][i]
            loss_err = max(abs(mc[k] - mp[k]) / abs(mp[k]) for k in mp)
            sam = [n for n in gp if not n.startswith("prompter.")]
            worst, worst_name, zero_ok = grad_errors({n: gc[n] for n in sam},
                                                     {n: gp[n] for n in sam})
            s_l2 = (torch.cat([(gc[n] - gp[n]).flatten() for n in sam]).norm()
                    / torch.cat([gp[n].flatten() for n in sam]).norm()).item()
            s_ok = worst <= 1e-3 or (worst <= TOL_SAM_GRAD_FLIP and s_l2 <= 1e-3)
            p_worst, p_name, p_zero_ok = grad_errors({n: gc[n] for n in gp if n not in sam},
                                                     {n: gp[n] for n in gp if n not in sam},
                                                     NUCLEI_ZERO_LEAVES)
            p_l2 = (torch.cat([(gc[n] - gp[n]).flatten() for n in gp if n not in sam]).norm()
                    / torch.cat([gp[n].flatten() for n in gp if n not in sam]).norm()).item()
            # the prompter at 256 px: see TOL_PROMPTER_GRAD_L2
            p_ok = p_worst <= 1e-3 if S <= 64 else p_l2 <= TOL_PROMPTER_GRAD_L2
            stats_tol = 1e-4 if S <= 64 else 1e-3
            lr2 = 2 * rcfg.lr * (i + 1) + 1e-6
            param_err = max((pc[n] - pp[n]).abs().max().item() for n in pp)
            # Adam steps an element by about lr whatever its gradient's size,
            # so a leaf whose gradient is round-off on the CPU (at most 1e-6
            # of the largest: the zero-in-exact leaves), or, at 256 px, a
            # prompter leaf after a flipped ReLU, steps by a sign that may
            # differ: held to the two-lr-a-step bound alone
            largest = max(g.abs().max().item() for g in gp.values())
            param_med, med_name = max((((pc[n] - pp[n]).abs().median().item(), n) for n in pp
                                       if (S <= 64 or n in sam)
                                       and gp[n].abs().max().item() > 1e-6 * largest),
                                      default=(0.0, ""))
            stats_err = rel_err(sc, sp)
            bank_err = max(rel_err(bc[k], bp[k]) for k in ("embeds", "iou"))
            feats_l2 = ((bc["feats"] - bp["feats"]).norm() / bp["feats"].norm()).item()
            valid_ok = torch.equal(bc["valid"], bp["valid"])
            want = nuclei_train_launches(cfg, B, 1, switches)
            ok = (loss_err <= 1e-4 and s_ok and zero_ok and p_ok and p_zero_ok
                  and param_err <= lr2 and param_med <= 1e-7 and stats_err <= stats_tol
                  and bank_err <= 1e-3
                  and feats_l2 <= TOL_BANK_FEATS_L2 and valid_ok and counts == want)
            ok_all &= ok
            print(f"[18a nuclei train parity] {label} fp32 TF32 off + resnet18 prompter, "
                  f"batch {B}, {M} cell slots, dropout 0, encoder switches "
                  f"{'B8+B7 on' if switches else 'off'}, step {i} "
                  f"({'bank non-empty, injected draws' if i else 'empty bank'}): cuda (launches "
                  f"{ {k: v for k, v in counts.items() if v} }, expected "
                  f"{ {k: v for k, v in want.items() if v} }) vs cpu: loss {mc['loss']:.6f} vs "
                  f"{mp['loss']:.6f}, worst of the six rel err {loss_err:.2e} (tol 1e-4) | "
                  f"{len(sam)} SAM2 leaves, worst grad err rel max|grad| {worst:.2e} at "
                  f"{worst_name}, rel L2 {s_l2:.2e} (tol 1e-3 of max, or "
                  f"{TOL_SAM_GRAD_FLIP:.0e} with L2 1e-3) | {len(gp) - len(sam)} prompter "
                  f"leaves, worst clipped grad err rel max|grad| {p_worst:.2e} at {p_name}, "
                  f"rel L2 {p_l2:.2e} (tol "
                  f"{'1e-3 of max' if S <= 64 else f'{TOL_PROMPTER_GRAD_L2:.0e} L2'}) | zero "
                  f"leaves at round-off {zero_ok and p_zero_ok} | params after "
                  f"AdamW max diff {param_err:.2e} (tol {lr2:.1e}), worst leaf median "
                  f"{param_med:.1e} at {med_name} (tol 1e-7) | BN running stats rel err "
                  f"{stats_err:.2e} (tol {stats_tol:.0e}) | bank embeds / iou rel err {bank_err:.2e} "
                  f"(tol 1e-3), feats rel L2 {feats_l2:.2e} (tol {TOL_BANK_FEATS_L2:.0e}), valid "
                  f"equal {valid_ok} | cuda "
                  f"{secs[0]:.1f} s cpu {secs[1]:.1f} s for both steps "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok_all:
            raise AssertionError(f"nuclei train parity {label}, switches {switches}: see above")


NUCLEI_TRAIN_STAGES = ("prompter", "encode", "decode_and_memory_write", "match", "backward",
                       "optimizer", "losses_and_rest")


def nuclei_step_split(model, prompter, step, opt, batch, bank, gens):
    """One step under synchronising timers: the prompter forward, the SAM2
    encode + bank conditioning, the rest of the forward (prompts, decoder,
    memory write), the host match, the backward, AdamW, and the rest (the
    losses, the clip, the BN update). Returns ({stage: seconds}, total, the new bank)."""
    spent = {k: 0.0 for k in (*NUCLEI_TRAIN_STAGES, "forward")}
    RN = recipe_nuclei

    def timed(key, fn):
        def run(*a, **k):
            dt, out = _sync_s(lambda: fn(*a, **k))
            spent[key] += dt
            return out
        return run

    origs = {"encode_and_condition": RN.encode_and_condition,
             "hungarian_match_host": RN.hungarian_match_host, "_grads": RN._grads,
             "forward_nuclei": RN.forward_nuclei}
    RN.encode_and_condition = timed("encode", origs["encode_and_condition"])
    RN.hungarian_match_host = timed("match", origs["hungarian_match_host"])
    RN._grads = timed("backward", origs["_grads"])
    RN.forward_nuclei = timed("forward", origs["forward_nuclei"])
    prompter.forward = timed("prompter", prompter.forward)
    opt_step = opt.step
    opt.step = timed("optimizer", opt_step)
    try:
        total, (bank, _) = _sync_s(lambda: step(batch, bank, True, *gens))
    finally:
        for k, v in origs.items():
            setattr(RN, k, v)
        del prompter.forward
        opt.step = opt_step
    fwd = spent.pop("forward")
    spent["decode_and_memory_write"] = fwd - spent["prompter"] - spent["encode"]
    spent["losses_and_rest"] = (total - fwd - spent["match"] - spent["backward"]
                                - spent["optimizer"])
    return spent, total, bank


def phase_nuclei_train_full_width(power_line: str):
    """Phase 18b: the nuclei step at full width, nuclei_256 (sam2_hiera_s
    @256, bf16, dense embedding 16) with the CLI's resnet50 prompter, batch
    4, 64 cell slots, bank 16, memory-attention and head dropout on as the
    CLI trains (0.1), synthetic 256-px images of 24 cells: with the encoder
    switches off, then B8 + B7 on, each a warm-up step on the empty bank and
    3 timed steps on the non-empty one (host clock, synchronised): finite
    losses, every tensor with a gradient updated, exact launch counts,
    seconds per step, images/s, peak memory, then one step's stage split
    under synchronising timers and one traced step (device busy time and
    idle share). Then ``cli.train_2d -net prompter -dataset synthetic`` for
    2 steps and 1 validation image. Returns {path: launch counts}."""
    B, M = 4, 64
    cfg = nuclei_256()
    rcfg = recipe_nuclei.NucleiRecipeConfig(prompter=PrompterConfig(backbone="resnet50"),
                                            memory_bank_size=16, max_cells=M,
                                            out_size=cfg.image_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True           # PyTorch's defaults, as a user runs it
    batches = [nuclei_batch(B, cfg.image_size, M, seed=s) for s in range(6)]
    paths = {}
    for switches in (False, True):
        with encoder_switches("1" if switches else "0", TRAIN_2D_SWITCHES):
            model = SAM2Model(cfg, seed=0, device=DEV)
            prompter = Prompter(rcfg.prompter, seed=1, device=DEV)
            opt = recipe_nuclei.make_optimizer_nuclei(model, prompter, rcfg)
            step = recipe_nuclei.make_train_step_nuclei(model, prompter, rcfg, opt)
            bank = recipe_2d.init_bank(model, rcfg.memory_bank_size)
            gens = [torch.Generator(device=DEV).manual_seed(s) for s in range(3)]
            before = {n: t.detach().clone()
                      for n, t in recipe_nuclei.named_trainables(model, prompter)}
            A.reset_launch_counts()
            bank, m0 = step(batches[0], bank, False, *gens)              # warm-up
            torch.cuda.synchronize()
            warm = A.launch_counts()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = []
            for batch in batches[1:4]:
                bank, m = step(batch, bank, True, *gens)
                metrics.append(m)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / 3
            counts = A.launch_counts()
            by_width = dict(FB.fused_window_block.launches_by_width)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = nuclei_train_launches(cfg, B, 3, switches)
            want_warm = nuclei_train_launches(cfg, B, 1, switches)
            spent, split_total, bank = nuclei_step_split(model, prompter, step, opt, batches[4],
                                                         bank, gens)
            wall_ms, busy_ms, n_kernels = trace_step(
                lambda: step(batches[5], bank, True, *gens))
            losses = [float(x["loss"]) for x in [m0, *metrics]]
            finite = all(np.isfinite(v) for v in losses)
            after = dict(recipe_nuclei.named_trainables(model, prompter))
            with_grad = [n for n in before if after[n].grad.abs().max().item() > 0]
            stuck = [n for n in with_grad if torch.equal(before[n], after[n].detach())]
            ok = finite and not stuck and counts == want and warm == want_warm
            tag = "B8+B7 on" if switches else "off"
            split = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spent.items())
            print(f"[18b nuclei train full width] nuclei_256 bf16 + resnet50 prompter, batch {B}, "
                  f"{M} cell slots, bank {rcfg.memory_bank_size}, dropout 0.1, switches {tag} | "
                  f"losses (warm-up, 3 timed) {', '.join(f'{v:.4f}' for v in losses)} finite "
                  f"{finite} | {len(with_grad)} of {len(before)} trainable tensors with a "
                  f"gradient, stuck {stuck[:3]} | warm-up launches "
                  f"{ {k: v for k, v in warm.items() if v} } expected "
                  f"{ {k: v for k, v in want_warm.items() if v} } | launches over 3 steps "
                  f"{ {k: v for k, v in counts.items() if v} } expected "
                  f"{ {k: v for k, v in want.items() if v} } (B8 by width {by_width}) | "
                  f"nuclei_train_s_per_step {secs:.4f}, {B / secs:.3f} images/s | peak memory "
                  f"{peak:.2f} GiB | one step's split (ms) {split} of {split_total * 1e3:.1f} "
                  f"under the timers | traced step: host {wall_ms:.1f} ms, device busy "
                  f"{busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}, idle share "
                  f"{1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels | {power_line} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"nuclei train {tag}: finite {finite}, stuck {stuck}, "
                                     f"launches {counts} vs {want}, warm-up {warm} vs "
                                     f"{want_warm}")
            if switches:
                paths["nuclei training"] = {**counts, "fused_block_by_width": by_width}
            del model, prompter, opt, step, bank, before, after
            torch.cuda.empty_cache()

    # the port's CLI on the card: synthetic nuclei, 2 steps, 1 validation image
    logdir = str(Path(__file__).resolve().parent / "build" / "train_2d_nuclei_logs")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.perf_counter()
    cli_model, cli_prompter = train_2d_cli.main(
        ["-net", "prompter", "-dataset", "synthetic", "-image_size", "256", "-out_size", "256",
         "-b", str(B), "-epochs", "1", "-steps_per_epoch", "2", "-val_freq", "1",
         "-val_max_samples", "1", "-logdir", logdir, "-print_freq", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    rows = [json.loads(ln) for f in Path(logdir).rglob("scalars.jsonl") for ln in open(f)]
    val = [r for r in rows if "val/aji" in json.dumps(r)]
    on_card = cli_model.device.type == "cuda" and cli_prompter.device.type == "cuda"
    ok = on_card and bool(val)
    print(f"[18b nuclei train cli] python -m medsam2_tpu_torch.cli.train_2d -net prompter -dataset "
          f"synthetic -image_size 256 -out_size 256 -b {B}, 2 steps + 1 validation image on "
          f"{cli_model.device}: {cli_s:.1f} s | validation scalars {val[-1] if val else None} | "
          f"{power_line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train_2d nuclei CLI: on card {on_card}, validation {val}")
    del cli_model, cli_prompter
    set_tf32(False)
    torch.cuda.empty_cache()
    return paths


def flat_counts(counts: dict) -> dict:
    """A step's counts with B3 / B4 by width spread into their own names."""
    out = {k: v for k, v in counts.items() if k != "by_width"}
    for (d, dv), n in counts.get("by_width", {}).items():
        if d == dv and d in (96, 72):
            for p in ("dkv", "dq"):
                out[f"flash_attention_bwd_{p} ({d}, {d})"] = n
    return out


def main() -> None:
    t_start = time.perf_counter()
    power_line = phase_device()
    phase_build()
    best = phase_kernels()
    session_shapes = phase_session_kernels()
    clear_shapes = phase_clear_kernels()
    best.update(phase_train_kernels())
    phase_e2e_parity()
    paths = {"propagation": phase_full_width(power_line)}
    phase_train_parity()
    paths["training"] = phase_train_full_width(power_line)
    best.update(phase_encoder_kernels())
    block_widths = best.pop("fused_block_widths")
    phase_image_parity()
    paths["2d serving"] = phase_image_full_width(power_line)
    paths["2d serving b+/l"] = phase_bl_set_image(power_line)
    phase_session_parity()
    for readout, c in phase_session_full_width(power_line).items():
        paths[f"3d session {readout}"] = c
    for form, c in phase_volumes_full_width(power_line).items():
        paths[f"3d volumes {form}"] = c
    phase_correction_parity()
    for readout, c in phase_correction_full_width(power_line).items():
        paths[f"correction round {readout}"] = c
    phase_train_parity(use_kcache=True)
    paths["training kcache"] = phase_train_kcache_full_width(power_line)
    print(f"[time] phases 1-14 in {time.perf_counter() - t_start:.0f} s")
    phase_2d_parity()
    paths.update(phase_2d_full_width(power_line))
    print(f"[time] phases 1-16 in {time.perf_counter() - t_start:.0f} s")
    nuclei_shapes = nuclei_kernels(power_line)
    phase_nuclei_parity()
    paths["nuclei serving"] = phase_nuclei_full_width(power_line)
    print(f"[time] phases 1-17 in {time.perf_counter() - t_start:.0f} s")
    phase_nuclei_train_parity()
    paths.update(phase_nuclei_train_full_width(power_line))
    print(f"[time] phases 1-18 in {time.perf_counter() - t_start:.0f} s")
    rows = []
    for name in KERNELS:
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        extra = {key: shapes[name] for key, shapes in (("session_shapes", session_shapes),
                                                       ("clear_shapes", clear_shapes),
                                                       ("nuclei_shapes", nuclei_shapes))
                 if name in shapes}
        if "(" in name and not by_path:
            raise AssertionError(f"{name}: no launch on the 2D training path")
        rows.append(dict(name=name, route="cuda", **KERNELS[name],
                         launches=sum(by_path.values()), launches_by_path=by_path,
                         **best[name], **extra))
    # B8 at each width of phase 8: launches from the image-serving runs
    for C, res in sorted(block_widths.items()):
        by_path = {p: c["fused_block_by_width"].get(C, 0) for p, c in paths.items()
                   if c.get("fused_block_by_width", {}).get(C)}
        if not by_path:
            raise AssertionError(f"fused_block C {C}: no launch on the main path")
        rows.append(dict(name=f"fused_block C{C}", route="cuda", **KERNELS["fused_block"],
                         launches=sum(by_path.values()), launches_by_path=by_path, **res))
    print(json.dumps({"kernels": rows}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
