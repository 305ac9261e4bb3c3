"""CLI argument surface of ``cli/train_3d.py`` and ``cli/train_2d.py``
(counterpart of ``medsam2_tpu/cli/cfg.py``): the flags of the reference
``train_3d.py`` and ``train_2d.py`` (REFUGE, MoNuSeg / CPM-17) commands,
which parse unchanged, plus the JAX package's additions that the recipes
read (synthetic data, static object and cell slots, ...) and ``-device``,
the port's choice of card or CPU. Every flag here is read by one of the
CLIs or by ``train_2d.validate_nuclei``, apart from ``--overlap`` and
``--crop_size``, which the JAX CLI parses and its validation does not read
either (the crop is the model's image size, the overlap 64); the
visualisation flag comes with its slice (ROADMAP A.7)."""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--seed', default=42, type=int)
    parser.add_argument('-print_freq', type=int, default=100, help='print_freq')
    parser.add_argument('--model_ema_steps', type=int, default=1,
                        help='iterations between EMA model updates')
    parser.add_argument('--model-ema', action='store_true',
                        help='track an exponential moving average of params')
    parser.add_argument('--model-ema-decay', type=float, default=0.99)
    parser.add_argument('--clip-grad', type=float, default=0.1,
                        help='2D: clip the global gradient norm (default: 0.1)')
    parser.add_argument('--overlap', default=64, type=int,
                        help='overlapping pixels (parsed; validation overlaps by 64)')
    parser.add_argument('--crop_size', default=256, type=int,
                        help='sliding-window crop size (parsed; validation crops at '
                             '-image_size)')
    parser.add_argument('--eval', action='store_true')
    parser.add_argument('-net', type=str, default='sam2', choices=('sam2', 'prompter'),
                        help='net type: sam2 (SAM-only training); prompter (the joint '
                             'DPA-P2PNet + SAM2 nuclei recipe, with -dataset synthetic)')
    parser.add_argument('-exp_name', default='medsam2_tpu', type=str)
    parser.add_argument('-vis', type=lambda s: s not in ('0', 'False', 'false'),
                        default=False, help='visualisation during validation (not ported)')
    parser.add_argument('-augment', type=int, default=1,
                        help='nuclei training augmentation (crop / flip / rot90 / colour '
                             'jitter) on=1 / off=0')
    parser.add_argument('-prompt', type=str, default='click',
                        help='type of prompt, bbox or click')
    parser.add_argument('-prompt_freq', type=int, default=2,
                        help='frequency of giving prompt in 3D images')
    parser.add_argument('-pretrain', type=str, default=None,
                        help='path of pretrain weights (.pt)')
    parser.add_argument('-val_freq', type=int, default=3)
    parser.add_argument('-val_max_samples', type=int, default=0,
                        help='2D: cap validation to N samples for smoke runs; 0 = the full '
                             'test set (the reference protocol, train_2d.py:155-164)')
    parser.add_argument('-point_filtering', action='store_true',
                        help='nuclei eval: keep only prompter points whose pixel is positive '
                             "in the semantic mask (the reference's cfgs.test.filtering, "
                             'modeling/utils.py:423-427)')
    parser.add_argument('-device', type=str, default='cuda',
                        help="torch device: 'cuda' (the default; raises without a card) "
                             "or 'cpu'")
    parser.add_argument('-image_size', type=int, default=1024)
    parser.add_argument('-out_size', type=int, default=1024,
                        help='2D: output (loss) size')
    parser.add_argument('-distributed', default='none', type=str,
                        help="'none'; a mesh spec ('data' or e.g. '4x2') is not ported")
    parser.add_argument('-dataset', default='btcv', type=str,
                        help='3D: btcv | amos | synthetic; 2D: refuge | monuseg | cpm | '
                             'synthetic')
    parser.add_argument('-sam_ckpt', type=str, default=None,
                        help='SAM2 checkpoint (.pt); None = random init')
    parser.add_argument('-sam_config', type=str, default='sam2_hiera_s')
    parser.add_argument('-video_length', type=int, default=8)
    parser.add_argument('-b', type=int, default=1, help='batch size')
    parser.add_argument('-lr', type=float, default=1e-4)
    parser.add_argument('-weights', type=str, default=None,
                        help='weights file for evaluation')
    parser.add_argument('-memory_bank_size', type=int, default=16,
                        help='2D: slots of the similarity memory bank')
    parser.add_argument('-data_path', type=str, default=None,
                        help='dataset root; None with -dataset synthetic uses generators')
    # additions of the JAX package
    parser.add_argument('-epochs', type=int, default=100)
    parser.add_argument('-max_objects', type=int, default=2,
                        help='static object slots for the 3D recipe')
    parser.add_argument('-max_cells', type=int, default=64,
                        help='static cell slots per image for the nuclei recipe')
    parser.add_argument('-steps_per_epoch', type=int, default=0,
                        help='cap steps per epoch (0 = full dataset)')
    parser.add_argument('-profile', action='store_true',
                        help='capture a torch.profiler trace of the first steps')
    parser.add_argument('-logdir', type=str, default='logs')
    parser.add_argument('-resume', type=str, default=None,
                        help='checkpoint dir to resume training from (params + '
                             'optimizer state + epoch)')
    return parser.parse_args(argv)
