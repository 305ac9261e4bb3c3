"""A run with the timed path broken underneath reads ``correct`` false: a
step that leaves the memory bank unchanged, half of the folded batch left
out, an answer altered where it is produced. The look for a card is skipped
(CPU, TINY); everything else is the run as the benchmark makes it."""

import pytest
import torch

from conftest import TINY_CELL
from portbench.lib import bench


def _bank_unchanged(loop):
    from medsam2_tpu_torch.state import memory_bank as mb

    orig = mb.write_bank

    def write_bank(spec, bank, frame_idx, *a, **k):
        # the conditioning frame is kept, later frames leave the bank as it is
        return orig(spec, bank, frame_idx, *a, **k) if frame_idx == 0 else bank

    loop._patches = [(mb, "write_bank", orig)]
    mb.write_bank = write_bank


def _half_batch(loop):
    orig = loop._call

    def call(i):
        V = loop.V
        loop.V = V // 2
        try:
            out = orig(i)
        finally:
            loop.V = V
        # the rows left out take the rows computed, as a mean over the rest
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand_as(out)], dim=0)

    loop._call = call


def _answer_altered(loop):
    model = loop.model
    orig = model.track_step

    def track_step(spec, bank, frame_idx, *a, **k):
        out, bank = orig(spec, bank, frame_idx, *a, **k)
        if frame_idx == 2:
            out = dict(out, pred_masks=out["pred_masks"] + 1.0)
        return out, bank

    model.track_step = track_step


def _worst_choice(loop):
    """The decoder's choice turned round: the lowest-scoring of the three
    masks is taken at every tracked slice."""
    dec = loop.model.sam_mask_decoder
    orig = dec.forward

    def forward(*a, **k):
        masks, iou, tokens, obj = orig(*a, **k)
        return masks, (-iou if k.get("multimask_output") else iou), tokens, obj

    dec.forward = forward


@pytest.mark.parametrize("fault", [_bank_unchanged, _half_batch, _answer_altered,
                                   _worst_choice])
def test_fault_reads_incorrect(tiny_root, fault):
    args = bench.parse(["--workload", TINY_CELL, "--seed", "3000000021", "--seconds", "0.5",
                        "--trace", "0", "--root", str(tiny_root)])
    holder = {}

    def patch(loop):
        holder["d"] = loop
        fault(loop)

    try:
        res = bench.run(args, 0.0, device="cpu", patch=patch)
    finally:
        for mod, name, orig in getattr(holder.get("d"), "_patches", []):
            setattr(mod, name, orig)
    assert res["correct"] is False
    c = res["checks"]["logit_rel_l2"]
    assert c["value"] > c["limit"]
