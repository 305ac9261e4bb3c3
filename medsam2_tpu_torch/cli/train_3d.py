"""3D (BTCV/AMOS CT-as-video) training CLI (counterpart of
``medsam2_tpu/cli/train_3d.py``; reference ``train_3d.py`` +
``func_3d/function.py``).

    python -m medsam2_tpu_torch.cli.train_3d -dataset synthetic -sam_config sam2_hiera_t \\
        -image_size 512 -video_length 8 -epochs 1 [-device cpu]

Builds the model from a preset on ``-device`` (the card by default),
optionally loads released SAM2 weights, trains with the two-optimizer recipe
over a volume batch, validates with the video predictor and threshold-averaged
IoU/Dice, and writes a checkpoint (weights, both optimizer states, epoch)
after each validation. ``-dataset btcv_nifti | amos_nifti`` reads raw
``imagesTr`` / ``labelsTr`` NIfTI volumes; ``-vis`` draws a figure per
validated (frame, object). ``-distributed data`` (or ``NxM``: N x M ranks,
model axis M) trains over a ``parallel.mesh`` when launched on more than one
rank, for example on the CPU

    torchrun --nproc_per_node 2 -m medsam2_tpu_torch.cli.train_3d -distributed data \
        -dataset synthetic -b 2 -device cpu ...

(gloo; NCCL with one card per rank); at one rank the flag changes nothing,
as in JAX.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from medsam2_tpu_torch.api.video_predictor import SAM2VideoPredictor
from medsam2_tpu_torch.checkpoint.store import load_params, restore_checkpoint, save_checkpoint
from medsam2_tpu_torch.cli.cfg import parse_args
from medsam2_tpu_torch.configs import get_config
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.data.btcv import AMOS, BTCV, pack_to_recipe_batch
from medsam2_tpu_torch.data.loader import DataLoader, device_prefetch
from medsam2_tpu_torch.data.nifti import NiftiVolumes
from medsam2_tpu_torch.data.prompts import bbox_to_xyxy
from medsam2_tpu_torch.data.synthetic import synthetic_volume
from medsam2_tpu_torch.metrics.segmentation import eval_seg
from medsam2_tpu_torch.parallel import mesh as pmesh
from medsam2_tpu_torch.train import recipe_3d
from medsam2_tpu_torch.utils.logging_utils import (EMA, MetricLogger, Profiler, ScalarWriter,
                                                   create_logger, set_log_dir)
from medsam2_tpu_torch.utils.visualization import vis_image


class SyntheticVolumes:
    def __init__(self, args, n=8):
        self.args = args
        self.n = n
        self.rng = np.random.default_rng(args.seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return synthetic_volume(self.rng, T=self.args.video_length,
                                size=self.args.image_size,
                                num_objects=self.args.max_objects,
                                prompt=self.args.prompt)


def build_dataset(args, mode: str):
    if args.dataset == "synthetic" or args.data_path is None:
        return SyntheticVolumes(args)
    # btcv_nifti / amos_nifti: the raw imagesTr / labelsTr .nii.gz volumes
    cls = {"btcv": BTCV, "amos": AMOS,
           "btcv_nifti": NiftiVolumes, "amos_nifti": NiftiVolumes}[args.dataset]
    return cls(args.data_path, mode=mode, image_size=args.image_size,
               video_length=args.video_length if mode == "Training" else None,
               prompt=args.prompt, seed=args.seed)


def _bce_pos_weight2(logits: np.ndarray, targets: np.ndarray) -> float:
    """Mean BCE-with-logits at pos_weight=2, the reference's validation
    ``lossfunc = criterion_G`` (``func_3d/function.py:14,208,300``), in
    float64 on the host."""
    x = np.asarray(logits, np.float64)
    y = np.asarray(targets, np.float64)
    return float((2.0 * y * np.logaddexp(0.0, -x) + (1.0 - y) * np.logaddexp(0.0, x)).mean())


@torch.no_grad()
def validation_sam(args, model: SAM2Model, val_loader, logger,
                   sample_dir: Optional[str] = None) -> Dict[str, float]:
    """Validation loop (``func_3d/function.py:198-314``): prompt every
    prompt_freq-th frame, propagate from frame 0, threshold-averaged IoU/Dice
    and the BCE(pos_weight=2) loss. Each volume's sums are normalised by its
    own (frame, object) pair count before the mean over the loader, whose
    length counts skipped no-object packs (``function.py:202,300-306``).
    With ``-vis``, one figure per (frame, object) under
    ``sample_dir/<volume>/<frame>/<object>.png`` (``function.py:288-298``)."""
    pred = SAM2VideoPredictor(model)
    tot_iou, tot_dice, tot_loss, n_val = 0.0, 0.0, 0.0, 0
    for batch in val_loader:
        n_val += 1
        for sample in batch:
            imgs = sample["image"]  # [T, 3, S, S]
            obj_ids = sorted({o for t in sample["label"] for o in sample["label"][t]})
            if not obj_ids:
                continue
            state = pred.val_init_state(imgs)
            empty = np.zeros(imgs.shape[2:], np.float32)
            for t in range(0, imgs.shape[0], args.prompt_freq):
                for obj in obj_ids:
                    if "pt" in sample and obj in sample["pt"].get(t, {}):
                        pred.add_new_points(state, t, obj, sample["pt"][t][obj][None],
                                            np.array([sample["p_label"][t][obj]]),
                                            normalize_coords=False)
                    elif "bbox" in sample and obj in sample["bbox"].get(t, {}) \
                            and not np.any(np.isnan(sample["bbox"][t][obj])):
                        pred.add_new_bbox(state, t, obj, bbox_to_xyxy(sample["bbox"][t][obj]),
                                          normalize_coords=False)
                    else:
                        pred.add_new_mask(state, t, obj, empty)
            name = sample["image_meta_dict"]["filename_or_obj"]
            vol_iou, vol_dice, vol_loss, pairs = 0.0, 0.0, 0.0, 0
            for frame_idx, ids, masks in pred.propagate_in_video(state, start_frame_idx=0):
                masks = masks.float().cpu().numpy()  # [O, 1, H, W]
                for oi, obj in enumerate(ids):
                    gt = sample["label"].get(frame_idx, {}).get(obj)
                    gt = (gt.astype(np.float32) if gt is not None
                          else np.zeros(masks.shape[2:], np.float32)[None])
                    vol_loss += _bce_pos_weight2(masks[oi:oi + 1], gt[None])
                    iou, dice = eval_seg(masks[oi:oi + 1], gt[None], (0.1, 0.3, 0.5, 0.7, 0.9))
                    vol_iou += iou
                    vol_dice += dice
                    pairs += 1
                    if args.vis and sample_dir is not None:
                        # the reference thresholds raw logits at 0.5: its
                        # sigmoid is commented out (func_3d/function.py:291)
                        vis_image(imgs[frame_idx], masks[oi, 0] > 0.5, gt[0],
                                  os.path.join(sample_dir, str(name), str(frame_idx),
                                               f"{obj}.png"))
            pred.reset_state(state)
            if pairs:
                tot_iou += vol_iou / pairs
                tot_dice += vol_dice / pairs
                tot_loss += vol_loss / pairs
    d = max(n_val, 1)
    return {"loss": tot_loss / d, "iou": tot_iou / d, "dice": tot_dice / d}


def main(argv=None):
    args = parse_args(argv)
    if args.net != "sam2":
        raise ValueError(f"-net {args.net}: the 3D recipe trains sam2")
    # -distributed data | NxM shards only when the world has more than one
    # rank (JAX's gate: more than one device); torchrun's env names the ranks
    mesh = None
    if args.distributed != "none" and pmesh.initialize_distributed(device=args.device) > 1:
        if torch.device(args.device).type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", pmesh.process_index()))
            args.device = f"cuda:{local % torch.cuda.device_count()}"
            torch.cuda.set_device(args.device)
        model_axis = int(args.distributed.split("x")[1]) if "x" in args.distributed else 1
        mesh = pmesh.make_mesh(model_axis=model_axis)
    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.sam_config, image_size=args.image_size)
    rcfg = recipe_3d.Recipe3DConfig(
        video_length=args.video_length, prompt_freq=args.prompt_freq,
        num_objects=args.max_objects, lr_sam=args.lr,
        multimask_for_prompts=(args.prompt == "click"))

    # every rank logs under its own run directory; rank 0 alone writes
    # checkpoints and figures
    paths = set_log_dir(args.logdir, args.exp_name if lead else f"{args.exp_name}_rank{mesh.rank}")
    logger = create_logger(paths["log_path"])
    logger.info(vars(args))
    if mesh is not None:
        logger.info(f"mesh: {mesh.shape}")

    model = SAM2Model(cfg, seed=args.seed, device=args.device)
    ckpt = args.weights or args.pretrain or args.sam_ckpt
    if ckpt:
        load_params(ckpt, model)
        logger.info(f"loaded checkpoint {ckpt}")
    else:
        logger.info("random init (no -sam_ckpt given)")
    optimizers = recipe_3d.make_optimizers(model, rcfg)
    start_epoch = 0
    if args.resume:
        state = restore_checkpoint(args.resume, model, optimizers)
        start_epoch = int(state["epoch"]) + 1
        logger.info(f"resumed from {args.resume} at epoch {start_epoch}")
    if mesh is not None:
        pmesh.shard_model(model, mesh, optimizers)
    train_step = recipe_3d.make_train_step(model, rcfg, optimizers, mesh=mesh)

    def collate(samples: List[Dict]):
        return pack_to_recipe_batch(samples, args.video_length, args.max_objects,
                                    args.prompt_freq, args.image_size)

    train_ds = build_dataset(args, "Training")
    val_ds = build_dataset(args, "Test" if args.dataset != "synthetic" else "Training")
    # every rank of a mesh loads the same global batch: one loader thread
    # draws the samples from the dataset's generator in batch order (two
    # threads take turns in whatever order they reach it)
    train_loader = DataLoader(train_ds, batch_size=args.b, shuffle=True, collate_fn=collate,
                              seed=args.seed, num_workers=2 if mesh is None else 1)
    val_loader = DataLoader(val_ds, batch_size=1, num_workers=0)

    profiler = Profiler(paths["log_path"]) if args.profile else None
    writer = ScalarWriter(paths["log_path"])
    ml = MetricLogger()
    ema = EMA(model, decay=args.model_ema_decay) if args.model_ema else None
    sample_dir = paths["sample_path"] if lead else None

    if args.eval:
        metrics = validation_sam(args, model, val_loader, logger, sample_dir=sample_dir)
        logger.info(f"eval: {metrics}")
        if mesh is not None:
            torch.distributed.destroy_process_group()
        return metrics

    # dropout active during training (the reference trains with
    # memory-attention dropout 0.1), seeded from -seed; each data rank draws
    # its own, the ranks of a model group the same
    gen = torch.Generator(device=model.device).manual_seed(
        args.seed + (mesh.data_index if mesh is not None else 0))
    if profiler:
        profiler.start()
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        for i, batch in enumerate(device_prefetch(iter(train_loader), model.device,
                                                  host_keys=("prompt_use_mask",))):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            metrics = train_step(batch, gen)
            if ema is not None and i % args.model_ema_steps == 0:
                ema.update(model)
            scalars = {k: float(v) for k, v in metrics.items()}
            ml.update(**scalars)
            if profiler:
                profiler.step()
            if i % args.print_freq == 0:
                logger.info(f"epoch {epoch} step {i}: {ml}")
            writer.add_scalars({f"train/{k}": v for k, v in scalars.items()},
                               step=epoch * 10 ** 6 + i)
        logger.info(f"epoch {epoch} trained in {time.time() - t0:.1f}s: {ml}")
        writer.add_scalars({f"train_epoch/{k}": m.global_avg for k, m in ml.meters.items()},
                           step=epoch)
        # val_freq <= 0 validates only on the final epoch
        if (args.val_freq > 0 and epoch % args.val_freq == 0) or epoch == args.epochs - 1:
            metrics = validation_sam(args, model, val_loader, logger, sample_dir=sample_dir)
            logger.info(f"epoch {epoch} val: {metrics}")
            writer.add_scalars({f"val/{k}": float(v) for k, v in metrics.items()}, step=epoch)
            _save(paths["ckpt_path"], model, optimizers, epoch, ema, lead)
    if profiler:
        profiler.close()
    writer.close()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return model


def _save(directory: str, model: SAM2Model, optimizers, epoch: int, ema, lead: bool) -> None:
    """A checkpoint with every model-parallel slice gathered whole (the
    layout of a one-process run); every rank gathers, rank 0 writes."""
    state = pmesh.full_named(model, model.state_dict())
    opts = {g: pmesh.full_optimizer_state(model, o) for g, o in optimizers.items()}
    extra = {"ema_params": pmesh.full_named(model, ema.params)} if ema is not None else None
    if lead:
        save_checkpoint(directory, state, opts, epoch, extra=extra)


if __name__ == "__main__":
    main()
