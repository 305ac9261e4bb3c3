"""3D (CT-as-video) training recipe (counterpart of
``medsam2_tpu/train/recipe_3d.py``).

Reference semantics (``func_3d/function.py:50-196``, ``train_3d.py:34-54``):
prompt every ``prompt_freq``-th frame for every object (box/click; a missing
object takes an empty-mask prompt), propagate through the memory system, then
BCEWithLogits(pos_weight=2) per (frame, object) split into the prompt and the
non-prompt loss. Two Adam optimizers: the mask decoder ("sam") at ``lr_sam``
stepped with d(prompt + non_prompt), and the memory path ("mem":
obj_ptr_proj, memory encoder and attention, mask_downsample) at ``lr_mem``
with d(non_prompt) only (``:182-191``). Everything else is frozen.

One forward per volume: the preflight over the prompt frames, then the
tracked frames in order with the read-order memory readout; the two
gradients are two ``torch.autograd.grad`` pulls through that one graph (the
JAX package's two vjp pulls). The frozen image encoder runs without autograd
(``remat="enc_saved"``); ``remat="full"`` also recomputes each tracked frame
in the backward (``torch.utils.checkpoint``).

With ``use_kcache`` (or ``MEDSAM2_TRAIN_KCACHE=1``) the bank carries the
roped-key cache: each memory's keys are projected and rotated once, when it
is written, and every tracked frame reads them in read order
(``memory_bank.read_kcache``) instead of projecting the whole memory again.
The positional half is computed inside the loss, so the k projection's
gradient keeps both of its parts; the spatial keys reach the loss through
the cache writes and the gather.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from medsam2_tpu_torch.api.video_predictor import _encode_frame, _expand, _prompt_step
from medsam2_tpu_torch.core.sam2_model import SAM2Model, compute_dtype, kcache_shape, use_multimask
from medsam2_tpu_torch.state import memory_bank as mb
from medsam2_tpu_torch.train.losses import bce_with_logits


@dataclasses.dataclass(frozen=True)
class Recipe3DConfig:
    video_length: int = 8
    prompt_freq: int = 2
    num_objects: int = 2          # static object slots (pad with zero-mask objects)
    lr_sam: float = 1e-4
    lr_mem: float = 1e-8
    pos_weight: float = 2.0
    max_cond_frames: int = 8
    # multimask on prompt frames: True for single-click prompting, False for
    # bbox (2 points), as SAM2Base._use_multimask with the preset limits
    multimask_for_prompts: bool = False
    # "enc_saved": the frozen encoder keeps no graph (the default);
    # "full": each tracked frame is also recomputed in the backward
    remat: str = "enc_saved"
    # training over the bank's roped-key cache; None reads
    # MEDSAM2_TRAIN_KCACHE (default off), as the JAX package does
    use_kcache: Optional[bool] = None

    def kcache_enabled(self) -> bool:
        if self.use_kcache is not None:
            return self.use_kcache
        return os.environ.get("MEDSAM2_TRAIN_KCACHE", "0") == "1"

    @property
    def prompt_frames(self) -> Tuple[int, ...]:
        return tuple(range(0, self.video_length, self.prompt_freq))


def make_optimizers(model: SAM2Model, rcfg: Recipe3DConfig) -> Dict[str, torch.optim.Adam]:
    """Mark the two trainable groups (everything else frozen) and build one
    Adam per group: "sam" at ``lr_sam``, "mem" at ``lr_mem``, betas (0.9,
    0.999), eps 1e-8 (``optax.adam``'s; eps after the square root in both)."""
    groups = model.set_trainable_groups()
    return {g: torch.optim.Adam([p for _, p in named],
                                lr=rcfg.lr_sam if g == "sam" else rcfg.lr_mem,
                                betas=(0.9, 0.999), eps=1e-8)
            for g, named in groups.items()}


def volume_losses(model: SAM2Model, spec: mb.BankSpec, rcfg: Recipe3DConfig, batch: Dict,
                  generator: Optional[torch.Generator] = None):
    """Losses for one volume. ``generator`` (any device) seeds the
    memory-attention dropout of each tracked frame (rate 0.1 in the
    reference); None = deterministic.

    batch (one volume; tensors on the model's device, except the host
    array ``prompt_use_mask``, which picks each object's prompt path):
      images        [T, S, S, 3]  in [0, 1]
      gt_masks      [T, O, S, S]  float 0/1
      prompt_coords [F, O, P, 2]  model-space (x, y)
      prompt_labels [F, O, P]     int (-1 pad; 2/3 for box corners)
      prompt_use_mask [F, O]      numpy bool: True = empty-mask prompt
      obj_valid     [O]           bool: real object vs padding slot

    Returns (prompt_loss, non_prompt_loss) scalars."""
    cfg = model.cfg
    T, O, S = rcfg.video_length, rcfg.num_objects, cfg.image_size
    dev = model.device
    images = batch["images"]
    gt = batch["gt_masks"]
    obj_valid = batch["obj_valid"].float()
    prompt_frames = rcfg.prompt_frames
    kshape = kcache_shape(cfg) if rcfg.kcache_enabled() else (0, 0)
    bank = mb.init_bank(spec, O, dev, kcache_shape=kshape, kcache_dtype=compute_dtype(cfg))
    # the cache's positional half depends on trainable weights: made inside
    # the loss, once per volume
    pos_kcache = model.make_pos_kcache(spec) if kshape[0] > 0 else None

    def frame_loss(high_res_masks, frame_gt):
        # high_res_masks [O, 1, S, S] logits; frame_gt [O, S, S] -> per object [O]
        per = bce_with_logits(high_res_masks[:, 0], frame_gt, rcfg.pos_weight)
        return per.mean(dim=(1, 2)) * obj_valid

    # --- preflight: prompt frames (cond memories) ---
    no_masks = torch.zeros(O, S, S, 1, device=dev)
    per_prompt = []
    for i, f in enumerate(prompt_frames):
        out, bank = _prompt_step(
            model, images, bank, f, batch["prompt_coords"][i], batch["prompt_labels"][i],
            no_masks, np.asarray(batch["prompt_use_mask"][i], bool), spec=spec,
            multimask_output=rcfg.multimask_for_prompts, is_eval=False, num_frames=T)
        per_prompt.append(frame_loss(out["pred_masks_high_res"], gt[f]))
    per_prompt = torch.stack(per_prompt)                     # [n_prompt, O]

    # --- tracked frames, in order ---
    non_prompt_frames = [t for t in range(T) if t not in prompt_frames]
    trunk_pe = model.image_encoder.trunk.get_pos_embed(S // 4, S // 4)
    multimask = use_multimask(cfg, False, 0)
    seeds: List[Optional[int]] = [None] * len(non_prompt_frames)
    if generator is not None:
        seeds = torch.randint(0, 2 ** 62, (len(non_prompt_frames),), generator=generator,
                              device=generator.device).tolist()

    def track(bank, f: int, seed: Optional[int]):
        # the frame's dropout generator is made from its seed here, so a
        # recompute under checkpoint draws the same masks
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        feats, pos = _encode_frame(model, images[f:f + 1], trunk_pos_embed=trunk_pe)
        out, bank = model.track_step(
            spec, bank, f, is_init_cond_frame=False, current_vision_feats=_expand(feats, O),
            current_vision_pos=_expand(pos, O), multimask_output=multimask,
            run_mem_encoder=True, is_cond_frame=False, num_frames=T, is_eval=False,
            pos_kcache=pos_kcache, kv_storage=False, generator=gen)
        return bank, frame_loss(out["pred_masks_high_res"], gt[f])

    if rcfg.remat not in ("enc_saved", "full"):
        raise ValueError(f"unknown remat policy {rcfg.remat!r}")
    per_nonprompt = []
    for f, seed in zip(non_prompt_frames, seeds):
        if rcfg.remat == "full":
            bank, loss = checkpoint(track, bank, f, seed, use_reentrant=False)
        else:
            bank, loss = track(bank, f, seed)
        per_nonprompt.append(loss)
    per_nonprompt = (torch.stack(per_nonprompt) if per_nonprompt
                     else torch.zeros(0, O, device=dev))

    # normalisations (func_3d/function.py:170-173)
    n_obj = obj_valid.sum().clamp_min(1.0)
    prompt_loss = per_prompt.sum() / (len(prompt_frames) * n_obj)
    non_prompt_loss = per_nonprompt.sum() / (max(len(non_prompt_frames), 1) * n_obj)
    return prompt_loss, non_prompt_loss


def _grads(loss, params, retain_graph: bool):
    """d loss / d params, zeros where the loss does not reach a parameter
    (the JAX package's zero cotangents)."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    gs = torch.autograd.grad(loss, params, retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def make_train_step(model: SAM2Model, rcfg: Recipe3DConfig,
                    optimizers: Dict[str, torch.optim.Optimizer], mesh=None):
    """The train step over a volume batch (arrays with a leading volume axis
    [Bv, ...]): per-volume losses averaged over the batch, two gradient pulls
    through one forward, the two Adam updates. After a step each trainable
    parameter's ``.grad`` holds the gradient its optimizer applied.

    With a ``parallel.mesh.Mesh``, each rank takes its data group's share of
    the batch's volumes, and the gradients and reported losses are averaged
    over the data group before the updates: the step of the whole batch
    (the loss is a mean over volumes). A model axis > 1 needs
    ``parallel.mesh.shard_model`` before the optimizers' first step."""
    spec = mb.BankSpec.from_config(model.cfg, max_cond_frames=rcfg.max_cond_frames)
    params = {g: [p for group in opt.param_groups for p in group["params"]]
              for g, opt in optimizers.items()}

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None):
        """``generator`` turns on the memory-attention dropout for this step;
        omit it for a deterministic step."""
        dev = model.device
        # which prompt path each object takes is host control flow: the mask
        # stays a host array, so the step copies nothing back for it
        use_mask = batch["prompt_use_mask"]
        use_mask = np.asarray(use_mask.cpu() if torch.is_tensor(use_mask) else use_mask, bool)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
                 if k != "prompt_use_mask"}
        if mesh is not None:
            use_mask = mesh.data_shard(use_mask)
            batch = {k: mesh.data_shard(v) for k, v in batch.items()}
        n_vol = batch["images"].shape[0]
        per_vol = [volume_losses(model, spec, rcfg,
                                 {**{k: v[i] for k, v in batch.items()},
                                  "prompt_use_mask": use_mask[i]},
                                 generator=generator) for i in range(n_vol)]
        prompt_loss = torch.stack([p for p, _ in per_vol]).mean()
        non_prompt_loss = torch.stack([n for _, n in per_vol]).mean()
        # reference grad flow: the memory path sees only d(non_prompt); the
        # decoder steps on the accumulated d(prompt) + d(non_prompt)
        g_mem = _grads(non_prompt_loss, params["mem"], retain_graph=True)
        g_sam = _grads(prompt_loss + non_prompt_loss, params["sam"], retain_graph=False)
        losses = [prompt_loss.detach().clone(), non_prompt_loss.detach().clone()]
        if mesh is not None:
            mesh.reduce_gradients(g_mem + g_sam + losses)
        prompt_loss, non_prompt_loss = losses
        for group, grads in (("mem", g_mem), ("sam", g_sam)):
            for p, g in zip(params[group], grads):
                p.grad = g
            optimizers[group].step()
        return {"loss": prompt_loss + non_prompt_loss, "prompt_loss": prompt_loss,
                "non_prompt_loss": non_prompt_loss}

    return train_step


def prompts_from_bbox(bboxes, valid, num_points: int):
    """bbox [..., 4] xyxy (+ validity [...]) -> padded corner-point prompts
    (numpy). Returns (coords [..., P, 2], labels [..., P]) with labels 2/3 on
    the two corner slots and -1 padding; invalid entries are all padding (the
    caller marks them ``use_mask`` for the empty-mask prompt)."""
    bboxes = np.asarray(bboxes, np.float32)
    valid = np.asarray(valid, bool)
    lead = bboxes.shape[:-1]
    coords = np.zeros((*lead, num_points, 2), np.float32)
    coords[..., 0, :] = bboxes[..., 0:2]
    coords[..., 1, :] = bboxes[..., 2:4]
    labels = -np.ones((*lead, num_points), np.int32)
    labels[..., 0] = 2
    labels[..., 1] = 3
    labels = np.where(valid[..., None], labels, -1).astype(np.int32)
    return coords, labels
