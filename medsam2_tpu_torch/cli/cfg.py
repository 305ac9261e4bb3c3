"""CLI argument surface of ``cli/train_3d.py`` (counterpart of
``medsam2_tpu/cli/cfg.py``): the flags of the reference ``train_3d.py``
command, which parses unchanged, plus the JAX package's additions that the
3D recipe reads (synthetic data, static object slots, ...) and ``-device``,
the port's choice of card or CPU. Every flag here is read by the CLI."""

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
    parser.add_argument('--eval', action='store_true')
    parser.add_argument('-net', type=str, default='sam2', choices=('sam2',),
                        help='net type (the reference command passes sam2)')
    parser.add_argument('-exp_name', default='medsam2_tpu', type=str)
    parser.add_argument('-vis', type=lambda s: s not in ('0', 'False', 'false'),
                        default=False, help='visualisation during validation (not ported)')
    parser.add_argument('-prompt', type=str, default='click',
                        help='type of prompt, bbox or click')
    parser.add_argument('-prompt_freq', type=int, default=2,
                        help='frequency of giving prompt in 3D images')
    parser.add_argument('-pretrain', type=str, default=None,
                        help='path of pretrain weights (.pt)')
    parser.add_argument('-val_freq', type=int, default=3)
    parser.add_argument('-device', type=str, default='cuda',
                        help="torch device: 'cuda' (the default; raises without a card) "
                             "or 'cpu'")
    parser.add_argument('-image_size', type=int, default=1024)
    parser.add_argument('-distributed', default='none', type=str,
                        help="'none'; a mesh spec ('data' or e.g. '4x2') is not ported")
    parser.add_argument('-dataset', default='btcv', type=str,
                        help='btcv | amos | synthetic')
    parser.add_argument('-sam_ckpt', type=str, default=None,
                        help='SAM2 checkpoint (.pt); None = random init')
    parser.add_argument('-sam_config', type=str, default='sam2_hiera_s')
    parser.add_argument('-video_length', type=int, default=8)
    parser.add_argument('-b', type=int, default=1, help='batch size')
    parser.add_argument('-lr', type=float, default=1e-4)
    parser.add_argument('-weights', type=str, default=None,
                        help='weights file for evaluation')
    parser.add_argument('-data_path', type=str, default=None,
                        help='dataset root; None with -dataset synthetic uses generators')
    # additions of the JAX package
    parser.add_argument('-epochs', type=int, default=100)
    parser.add_argument('-max_objects', type=int, default=2,
                        help='static object slots for the 3D recipe')
    parser.add_argument('-steps_per_epoch', type=int, default=0,
                        help='cap steps per epoch (0 = full dataset)')
    parser.add_argument('-profile', action='store_true',
                        help='capture a torch.profiler trace of the first steps')
    parser.add_argument('-logdir', type=str, default='logs')
    parser.add_argument('-resume', type=str, default=None,
                        help='checkpoint dir to resume training from (params + '
                             'optimizer state + epoch)')
    return parser.parse_args(argv)
