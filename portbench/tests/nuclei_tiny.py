"""A TINY joint nuclei cell for the CPU tests, added by files and entries
alone, and the faults that a run with the timed path broken underneath
must read as not correct. The faults are also the planted faults of the
chip readings (``calibrate.readings(..., patch=FAULTS[name])``)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

TINY_NUCLEI = "tiny_nuclei_train"
TINY_S = 64


def tiny_nuclei_doc(root: Path) -> dict:
    """The full configuration at TINY sizes: SAM 2 Hiera-S at 64 px in
    float32, a ResNet-18 prompter of width 32, 4 cell slots, a bank of 2."""
    from medsam2_tpu_torch.configs import get_config

    overrides = {"image_size": TINY_S, "dense_embed_size": TINY_S // 16,
                 "compute_dtype": "float32"}
    doc = json.loads((root / "portbench" / "configs" / "nuclei_256_resnet50.json").read_text())
    model = json.loads(json.dumps(dataclasses.asdict(get_config("nuclei_256", **overrides))))
    doc.update(name="tiny_nuclei", overrides=overrides, model=model)
    doc["prompter"] = dict(doc["prompter"], backbone="resnet18", hidden_dim=32)
    doc["recipe"] = dict(doc["recipe"], max_cells=4, memory_bank_size=2, out_size=TINY_S)
    return doc


def add_tiny_nuclei(root: Path, limits: dict = None) -> None:
    """Add the TINY configuration, traffic mix, limits and cell to the
    checkout at ``root``, on the full cell's metrics."""
    pb = root / "portbench"
    (pb / "configs" / "tiny_nuclei.json").write_text(json.dumps(tiny_nuclei_doc(root)))
    tr = json.loads((pb / "traffic" / "nuclei_train_b16.json").read_text())
    tr.update(batch=2, pool=4, tile_size=TINY_S, cells_min=2, cells_max=4,
              augment=dict(tr["augment"], crop_size=TINY_S))
    (pb / "traffic" / "tiny_nuclei.json").write_text(json.dumps(tr))
    if limits is None:
        limits = json.loads((pb / "limits" / "nuclei_train_n256_b16.json").read_text())
    (pb / "limits" / f"{TINY_NUCLEI}.json").write_text(json.dumps(limits))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_nuclei", "source": "https://example.org/tiny",
                         "file": "portbench/configs/tiny_nuclei.json",
                         "reduced": ["image_size"], "why": "CPU tests"})
    b["workloads"].append({"name": TINY_NUCLEI, "config": "tiny_nuclei",
                           "traffic": "tiny_nuclei", "chips": 1, "why": "CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "nuclei_train_n256_b16" in m.get("workloads", []):
            m["workloads"].append(TINY_NUCLEI)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


# ---------------------------------------------------------------------------
# Faults, each planted under the program's timed path: ``fault(loop)`` runs
# after set-up has built the step and before it drives the first steps.
# ``undo`` restores what a fault replaced in a module.
# ---------------------------------------------------------------------------


def _swap(loop, mod, name, new):
    loop._patches = getattr(loop, "_patches", []) + [(mod, name, getattr(mod, name))]
    setattr(mod, name, new)


def undo(loop) -> None:
    for mod, name, orig in reversed(getattr(loop, "_patches", [])):
        setattr(mod, name, orig)
    loop._patches = []


def state_unchanged(loop):
    """The optimizer leaves every parameter where it was."""
    loop.opt.step = lambda *a, **k: None


def half_batch(loop):
    """The step trains on the first half of each batch; the loss is the mean
    over the rest."""
    step = loop.step

    def half(batch, *a, **k):
        h = batch["images"].shape[0] // 2
        return step({k2: v[:h] for k2, v in batch.items()}, *a, **k)

    loop.step = half


def criterion_term_dropped(loop):
    """The criterion returns the classification loss as zero."""
    from medsam2_tpu_torch.train import recipe_nuclei as rn

    orig = rn.criterion_losses

    def losses(*a, **k):
        out = orig(*a, **k)
        return dict(out, loss_cls=out["loss_cls"] * 0.0)

    _swap(loop, rn, "criterion_losses", losses)


def match_permuted(loop):
    """The match hands each image's assignment on to the next ground-truth
    slot."""
    from medsam2_tpu_torch.train import recipe_nuclei as rn

    orig = rn.hungarian_match_host

    def match(mcfg, pred_coords, pred_logits, gt_points, gt_labels, gt_valid):
        out = orig(mcfg, pred_coords, pred_logits, gt_points, gt_labels, gt_valid)
        res = out.copy()
        for b in range(out.shape[0]):
            cols = np.flatnonzero(np.asarray(gt_valid[b]))
            res[b, cols] = np.roll(out[b, cols], 1)
        return res

    _swap(loop, rn, "hungarian_match_host", match)


def dropout_swapped(loop):
    """The prompter's regression and class heads take each other's dropout
    masks: both drawn, in the other order."""
    from medsam2_tpu_torch.prompter import dpa_p2pnet as dp

    orig = dp.head_dropout
    state = {"n": 0, "held": None}

    def head_dropout(x, rate, generator):
        if generator is None or rate <= 0.0:
            return orig(x, rate, generator)
        i = state["n"] % 3          # deform, reg, cls: one draw each a forward
        state["n"] += 1
        if i == 1:
            first = torch.rand(x.shape, generator=generator, device=x.device)
            state["held"] = first
            second = torch.rand(x.shape, generator=generator, device=x.device)
            mask = second < 1.0 - rate
        elif i == 2:
            mask = state.pop("held") < 1.0 - rate
            state["held"] = None
        else:
            return orig(x, rate, generator)
        return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))

    _swap(loop, dp, "head_dropout", head_dropout)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, criterion_term_dropped,
                                  match_permuted, dropout_swapped)}
