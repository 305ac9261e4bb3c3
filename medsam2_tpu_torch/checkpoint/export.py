"""Export the port's weights as a reference-format PyTorch checkpoint
(counterpart of ``medsam2_tpu/checkpoint/export.py``): ``{"model":
state_dict}``, the layout ``build_sam._load_checkpoint`` of the PyTorch
Medical-SAM2 / SAM2 stack reads. The port's ``state_dict`` already has the
reference keys and layouts, so nothing is converted.

    python -m medsam2_tpu_torch.checkpoint.export <checkpoint> <out.pt> \\
        [--preset sam2_hiera_s] [--image_size 1024] [--device cuda]

``<checkpoint>`` is a checkpoint file or directory of the port's trainers
(the latest ``step_<n>.pt``) or a released SAM2 ``.pt``, read through
:func:`medsam2_tpu_torch.checkpoint.store.load_params`.
"""

from __future__ import annotations

import argparse

import torch


def export_to_torch(model: torch.nn.Module, out_path: str) -> None:
    """Write ``{"model": state_dict}`` (CPU tensors) to ``out_path``."""
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({"model": state}, out_path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help="a checkpoint file or directory, or a SAM2 .pt")
    ap.add_argument("out", help="output .pt path")
    ap.add_argument("--preset", default="sam2_hiera_s")
    ap.add_argument("--image_size", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from medsam2_tpu_torch.checkpoint.store import load_params
    from medsam2_tpu_torch.configs import get_config
    from medsam2_tpu_torch.core.sam2_model import SAM2Model

    model = SAM2Model(get_config(args.preset, image_size=args.image_size), device=args.device)
    load_params(args.checkpoint, model)
    export_to_torch(model, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
