"""2D training CLI, the REFUGE workload (counterpart of
``medsam2_tpu/cli/train_2d.py``; reference ``train_2d.py`` +
``func_2d/function.py``).

    python -m medsam2_tpu_torch.cli.train_2d -net sam2 -dataset synthetic \\
        -sam_config sam2_hiera_s -image_size 1024 -out_size 1024 -b 4 -epochs 1 [-device cpu]

SAM-only click training with the similarity memory bank
(:mod:`medsam2_tpu_torch.train.recipe_2d`) on ``-device`` (the card by
default; it raises without one), then threshold-averaged IoU / Dice
validation over the test set (``-val_max_samples`` caps it), and a
checkpoint (weights, optimizer state, epoch) whenever the validation Dice
improves. ``-dataset synthetic``, or no ``-data_path``, trains on
``synthetic_fundus`` samples, as the JAX CLI does.

The nuclei workload's validation is here (:func:`validate_nuclei`: the
sliding-window instance engine over the test set, scored by Dice1 / Dice2
/ AJI / AJI+ / DQ / SQ / PQ); its training loop is not ported, so
``-dataset monuseg|cpm`` and ``-net prompter`` raise with a pointer to
ROADMAP queue A.6, as do ``-distributed`` and ``-vis`` (A.7).
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
from medsam2_tpu_torch.data.refuge import REFUGE, pack_refuge_batch
from medsam2_tpu_torch.data.synthetic import synthetic_fundus
from medsam2_tpu_torch.metrics.instance import (get_dice_1, get_fast_aji, get_fast_aji_plus,
                                                get_fast_dice_2, get_fast_pq, remap_label)
from medsam2_tpu_torch.metrics.segmentation import eval_seg
from medsam2_tpu_torch.prompter.dpa_p2pnet import Prompter
from medsam2_tpu_torch.train import recipe_2d
from medsam2_tpu_torch.utils.logging_utils import (MetricLogger, ScalarWriter, create_logger,
                                                   set_log_dir)

NUCLEI = ("nuclei training (the DPA-P2PNet prompter's recipe and loop) is not ported; "
          "see ROADMAP queue A.6")
VIS = "-vis (validation figures) is not ported; see ROADMAP queue A.7"


class SyntheticDataset:
    """``synthetic_fundus`` samples from one seeded generator."""

    def __init__(self, args, kind: str = "refuge", n=16):
        if kind != "refuge":
            raise NotImplementedError(f"synthetic {kind} data: {NUCLEI}")
        self.args = args
        self.n = n
        self.rng = np.random.default_rng(args.seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return synthetic_fundus(self.rng, self.args.image_size)


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


def main(argv=None):
    args = parse_args(argv)
    if args.dataset in ("monuseg", "cpm") or args.net == "prompter":
        raise NotImplementedError(NUCLEI)
    if args.distributed != "none":
        raise NotImplementedError("-distributed is not ported; see ROADMAP queue A.7")
    if args.vis:
        raise NotImplementedError(VIS)
    cfg = get_config(args.sam_config, image_size=args.image_size)
    paths = set_log_dir(args.logdir, args.exp_name)
    logger = create_logger(paths["log_path"])
    logger.info(vars(args))
    return train_refuge(args, cfg, logger, paths)


if __name__ == "__main__":
    main()
