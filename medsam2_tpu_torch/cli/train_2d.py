"""2D training CLI (counterpart of ``medsam2_tpu/cli/train_2d.py``; reference
``train_2d.py`` + ``func_2d/function.py``). Two workloads by ``-dataset``:

    python -m medsam2_tpu_torch.cli.train_2d -net sam2 -dataset refuge|synthetic \\
        -sam_config sam2_hiera_s -image_size 1024 -out_size 1024 -b 4 -epochs 1 [-device cpu]
    python -m medsam2_tpu_torch.cli.train_2d -net prompter -dataset monuseg|cpm|synthetic \\
        -image_size 256 -out_size 256 -b 4 -max_cells 64 -epochs 1 [-device cpu]

- ``refuge``: SAM-only click training with the similarity memory bank
  (:mod:`medsam2_tpu_torch.train.recipe_2d`), then threshold-averaged IoU /
  Dice validation over the test set, and a checkpoint whenever the Dice
  improves.
- ``monuseg`` / ``cpm``: the DPA-P2PNet prompter (resnet50) and SAM2 trained
  jointly (:mod:`medsam2_tpu_torch.train.recipe_nuclei`; the reference's
  missing mmengine ``args.py`` replaced by flags: ``-max_cells``,
  ``-augment``), then :func:`validate_nuclei` (the sliding-window instance
  engine, Dice1 / Dice2 / AJI / AJI+ / DQ / SQ / PQ), with separate
  ``best_dice`` and ``best_aji`` checkpoints of both modules. At
  ``-image_size 256`` the dense prompt embedding is forced to 16 x 16
  (nuclei_256).

Everything runs on ``-device`` (the card by default; it raises without one).
``-dataset synthetic``, or no ``-data_path``, trains on ``synthetic_fundus``
(``-net sam2``) or ``synthetic_nuclei`` (``-net prompter``) samples, as the
JAX CLI does; ``-val_max_samples`` caps validation. ``-distributed`` and
``-vis`` raise with a pointer to ROADMAP queue A.7.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from medsam2_tpu_torch.api.nuclei_inference import predict_instances
from medsam2_tpu_torch.checkpoint.store import load_params, save_checkpoint
from medsam2_tpu_torch.cli.cfg import parse_args
from medsam2_tpu_torch.configs import get_config
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.data.loader import DataLoader, device_prefetch
from medsam2_tpu_torch.data.monuseg import CPM, MONUSEG, pack_nuclei_batch
from medsam2_tpu_torch.data.refuge import REFUGE, pack_refuge_batch
from medsam2_tpu_torch.data.synthetic import synthetic_fundus, synthetic_nuclei
from medsam2_tpu_torch.metrics.instance import (get_dice_1, get_fast_aji, get_fast_aji_plus,
                                                get_fast_dice_2, get_fast_pq, remap_label)
from medsam2_tpu_torch.metrics.segmentation import eval_seg
from medsam2_tpu_torch.prompter.dpa_p2pnet import Prompter, PrompterConfig
from medsam2_tpu_torch.train import recipe_2d, recipe_nuclei
from medsam2_tpu_torch.utils.logging_utils import (MetricLogger, ScalarWriter, create_logger,
                                                   set_log_dir)

VIS = "-vis (validation figures) is not ported; see ROADMAP queue A.7"


class SyntheticDataset:
    """``synthetic_fundus`` (``kind="refuge"``) or ``synthetic_nuclei``
    samples from one seeded generator."""

    def __init__(self, args, kind: str = "refuge", n=16):
        self.args = args
        self.make = synthetic_fundus if kind == "refuge" else synthetic_nuclei
        self.n = n
        self.rng = np.random.default_rng(args.seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.make(self.rng, self.args.image_size)


@torch.no_grad()
def validate_refuge(args, model: SAM2Model, rcfg, val_ds, bank):
    """Mean threshold-averaged IoU and Dice over the test set (the
    reference iterates the whole loader, ``train_2d.py:155-164``), each
    sample decoded with ``is_eval`` on against the trained bank."""
    gen = torch.Generator(device=model.device).manual_seed(0)
    nonempty = bool(bank["valid"].any())
    cap = int(args.val_max_samples or 0)
    n_val = len(val_ds) if cap <= 0 else min(len(val_ds), cap)
    tot_iou = tot_dice = 0.0
    for i in range(n_val):
        batch = pack_refuge_batch([val_ds[i]], args.image_size, args.out_size)
        images, coords, labels = (torch.from_numpy(batch[k]).to(model.device)
                                  for k in ("images", "coords", "labels"))
        pred = recipe_2d.forward_2d(model, rcfg, images, coords, labels, bank, gen, nonempty,
                                    is_eval=True)[0]
        iou, dice = eval_seg(pred.float().cpu().numpy()[:, None], batch["gt_masks"][:, None],
                             (0.1, 0.3, 0.5, 0.7, 0.9))
        tot_iou += iou
        tot_dice += dice
    return tot_iou / max(n_val, 1), tot_dice / max(n_val, 1)


@torch.no_grad()
def validate_nuclei(args, model: SAM2Model, prompter: Prompter, val_ds, bank,
                    generator) -> Dict[str, float]:
    """Full-image nuclei evaluation over the test set (the reference iterates
    the whole loader, ``func_2d/function.py:268-678``;
    ``-val_max_samples N`` caps it): :func:`predict_instances` per image
    (its crop size the model's image size and its overlap 64, whatever
    ``--crop_size`` / ``--overlap`` say, as in the JAX CLI; ``filtering``
    from ``-point_filtering``), scored against the GT instance map by the
    reference's metric set Dice1 / Dice2 / AJI / AJI+ / DQ / SQ / PQ, each
    averaged over the images. Writes into ``bank`` as it goes."""
    if getattr(args, "vis", False):
        raise NotImplementedError(VIS)
    tot = {"dice1": 0.0, "dice2": 0.0, "aji": 0.0, "aji_plus": 0.0,
           "dq": 0.0, "sq": 0.0, "pq": 0.0}
    n = 0
    cap = int(getattr(args, "val_max_samples", 0) or 0)
    n_val = len(val_ds) if cap <= 0 else min(len(val_ds), cap)
    for i in range(n_val):
        s = val_ds[i]
        inst_map = s.get("inst_map")
        if inst_map is None:
            continue
        pred_inst = predict_instances(model, prompter, s, bank, generator,
                                      filtering=bool(getattr(args, "point_filtering", False)))
        gt = remap_label(inst_map)
        pr = remap_label(pred_inst)
        both = bool(gt.max() and pr.max())
        tot["dice1"] += get_dice_1(gt, pr)
        tot["dice2"] += get_fast_dice_2(gt, pr) if both else 0.0
        if both:
            tot["aji"] += get_fast_aji(gt, pr)
            tot["aji_plus"] += get_fast_aji_plus(gt, pr)
        (dq, sq, pq), _ = get_fast_pq(gt, pr)
        tot["dq"] += dq
        tot["sq"] += sq
        tot["pq"] += pq
        n += 1
    return {k: v / max(n, 1) for k, v in tot.items()}


def train_refuge(args, cfg, logger, paths) -> SAM2Model:
    rcfg = recipe_2d.Recipe2DConfig(memory_bank_size=args.memory_bank_size, lr=args.lr,
                                    out_size=args.out_size, clip_grad=args.clip_grad)
    model = SAM2Model(cfg, seed=args.seed, device=args.device)
    ckpt = args.weights or args.pretrain or args.sam_ckpt
    if ckpt:
        load_params(ckpt, model)
        logger.info(f"loaded checkpoint {ckpt}")
    else:
        logger.info("random init (no -sam_ckpt given)")
    opt = recipe_2d.make_optimizer_2d(model, rcfg)
    step = recipe_2d.make_train_step_2d(model, rcfg, opt)

    if args.dataset == "synthetic" or args.data_path is None:
        train_ds = SyntheticDataset(args)
        val_ds = train_ds
    else:
        train_ds = REFUGE(args.data_path, "Training", args.image_size, args.out_size,
                          seed=args.seed)
        val_ds = REFUGE(args.data_path, "Test", args.image_size, args.out_size)
    loader = DataLoader(train_ds, batch_size=args.b, shuffle=True, seed=args.seed,
                        collate_fn=lambda s: pack_refuge_batch(s, args.image_size,
                                                               args.out_size))
    bank = recipe_2d.init_bank(model, rcfg.memory_bank_size)
    # dropout active during training and the bank's draws, seeded from -seed
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    ml = MetricLogger()
    writer = ScalarWriter(paths["log_path"])
    any_written = False
    best_dice = 0.0
    for epoch in range(args.epochs):
        t0 = time.time()
        for i, batch in enumerate(device_prefetch(iter(loader), model.device)):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            bank, metrics = step(batch, bank, gen, bank_nonempty=any_written)
            any_written = True
            scalars = {k: float(v) for k, v in metrics.items()}
            ml.update(**scalars)
            if i % args.print_freq == 0:
                logger.info(f"epoch {epoch} step {i}: {ml}")
        logger.info(f"epoch {epoch} in {time.time() - t0:.1f}s: {ml}")
        writer.add_scalars({f"train/{k}": m.global_avg for k, m in ml.meters.items()}, epoch)
        if (args.val_freq > 0 and epoch % args.val_freq == 0) or epoch == args.epochs - 1:
            iou, dice = validate_refuge(args, model, rcfg, val_ds, bank)
            logger.info(f"epoch {epoch} val iou={iou:.4f} dice={dice:.4f}")
            writer.add_scalars({"val/iou": iou, "val/dice": dice}, epoch)
            if dice > best_dice:
                best_dice = dice
                save_checkpoint(paths["ckpt_path"], model, {"adamw": opt}, epoch)
    writer.close()
    return model


def train_nuclei(args, cfg, logger, paths):
    """The joint prompter + SAM2 loop (JAX ``train_nuclei``). Returns (the
    SAM2 model, the prompter)."""
    rcfg = recipe_nuclei.NucleiRecipeConfig(
        prompter=PrompterConfig(backbone="resnet50"), memory_bank_size=args.memory_bank_size,
        max_cells=args.max_cells, lr=args.lr, out_size=args.out_size, clip_grad=args.clip_grad)
    model = SAM2Model(cfg, seed=args.seed, device=args.device)
    prompter = Prompter(rcfg.prompter, seed=args.seed + 1, device=args.device)
    if args.sam_ckpt:
        load_params(args.sam_ckpt, model)
        logger.info(f"loaded checkpoint {args.sam_ckpt}")
    opt = recipe_nuclei.make_optimizer_nuclei(model, prompter, rcfg)
    step = recipe_nuclei.make_train_step_nuclei(model, prompter, rcfg, opt)

    if args.dataset == "synthetic" or args.data_path is None:
        train_ds = SyntheticDataset(args, "nuclei")
        val_ds = train_ds
    else:
        cls = {"monuseg": MONUSEG, "cpm": CPM}[args.dataset]
        train_ds = cls(args.data_path, "train", args.image_size, args.out_size,
                       seed=args.seed, augment=bool(args.augment))
        val_ds = cls(args.data_path, "test", args.image_size, args.out_size)
    loader = DataLoader(train_ds, batch_size=args.b, shuffle=True, seed=args.seed,
                        collate_fn=lambda s: pack_nuclei_batch(s, args.image_size,
                                                               args.out_size, args.max_cells))
    bank = recipe_2d.init_bank(model, rcfg.memory_bank_size)
    # the three random streams (bank draws, memory-attention dropout, head
    # dropout), seeded from -seed; validation draws from its own
    gens = [torch.Generator(device=model.device).manual_seed(args.seed + i) for i in range(4)]
    ml = MetricLogger()
    writer = ScalarWriter(paths["log_path"])
    any_written = False
    best = {"dice1": 0.0, "aji": 0.0}
    for epoch in range(args.epochs):
        t0 = time.time()
        for i, batch in enumerate(device_prefetch(iter(loader), model.device)):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            bank, metrics = step(batch, bank, any_written, *gens[:3])
            any_written = True
            ml.update(**{k: float(v) for k, v in metrics.items()})
            if i % args.print_freq == 0:
                logger.info(f"epoch {epoch} step {i}: {ml}")
        logger.info(f"epoch {epoch} in {time.time() - t0:.1f}s: {ml}")
        writer.add_scalars({f"train/{k}": m.global_avg for k, m in ml.meters.items()}, epoch)
        if (args.val_freq > 0 and epoch % args.val_freq == 0) or epoch == args.epochs - 1:
            prompter.eval()
            scores = validate_nuclei(args, model, prompter, val_ds, bank, gens[3])
            logger.info(f"epoch {epoch} val: {scores}")
            writer.add_scalars({f"val/{k}": float(v) for k, v in scores.items()}, epoch)
            # the reference keeps separate best-Dice and best-AJI checkpoints
            # (train_2d.py:173-179)
            for key, name in (("dice1", "best_dice"), ("aji", "best_aji")):
                if scores[key] > best[key]:
                    best[key] = scores[key]
                    save_checkpoint(paths["ckpt_path"], model, {"adamw": opt}, epoch,
                                    prompter=prompter, name=name)
    writer.close()
    return model, prompter


def main(argv=None):
    args = parse_args(argv)
    if args.distributed != "none":
        raise NotImplementedError("-distributed is not ported; see ROADMAP queue A.7")
    if args.vis:
        raise NotImplementedError(VIS)
    if args.dataset == "refuge":
        workload = "refuge"
    elif args.dataset in ("monuseg", "cpm"):
        workload = "nuclei"
    else:
        workload = "nuclei" if args.net == "prompter" else "refuge"
    dense = 16 if workload == "nuclei" and args.image_size == 256 else None
    cfg = get_config(args.sam_config, image_size=args.image_size, dense_embed_size=dense)
    paths = set_log_dir(args.logdir, args.exp_name)
    logger = create_logger(paths["log_path"])
    logger.info(vars(args))
    if workload == "refuge":
        return train_refuge(args, cfg, logger, paths)
    return train_nuclei(args, cfg, logger, paths)


if __name__ == "__main__":
    main()
