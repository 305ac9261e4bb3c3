"""Golden tensors of the core modules (counterpart of
``medsam2_tpu/checkpoint/goldens.py``).

Runs the image encoder, the prompt encoder and SAM heads on a fixed click,
and the memory encoder on the best mask, on fixed inputs from
``np.random.default_rng(seed)``, and returns inputs and outputs as numpy
arrays under the JAX package's keys (``in_*`` / ``out_*``). Uses:

- parity pinning: re-run after a change and diff (:func:`compare_goldens`);
- across packages and devices: the JAX package's ``dump_goldens`` on the
  same weights and seed gives the same keys from the same inputs, and a
  run on the card can be held to a run on the CPU.

    python -m medsam2_tpu_torch.checkpoint.goldens out.npz [--ckpt path] \\
        [--preset sam2_hiera_t] [--image_size 512] [--seed 0] [--device cuda]

Without ``--ckpt`` the weights are the port's own seeded init
(``SAM2Model(cfg, seed)``), which is not the JAX package's ``PRNGKey`` init:
the two packages' goldens agree only on the same weights, for example a
checkpoint both load.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from medsam2_tpu_torch.core.sam2_model import SAM2Model, compute_dtype


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.no_grad()
def dump_goldens(model: SAM2Model, seed: int = 0) -> Dict[str, np.ndarray]:
    cfg = model.cfg
    dev = model.device
    rng = np.random.default_rng(seed)
    S = cfg.image_size
    out: Dict[str, np.ndarray] = {"image_size": np.asarray(S)}

    # full image encoder
    img = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    out["in_image"] = img
    backbone = model.forward_image(torch.from_numpy(img).to(dev, compute_dtype(cfg)))
    for i, f in enumerate(backbone["backbone_fpn"]):
        out[f"out_backbone_fpn_{i}"] = _np(f)
    out["out_vision_features"] = _np(backbone["vision_features"])

    # prompt encoder + SAM heads with a fixed click
    coords = np.array([[[S * 0.5, S * 0.4]]], np.float32)
    labels = np.array([[1]], np.int32)
    out["in_point_coords"] = coords
    out["in_point_labels"] = labels
    feats, _ = model.prepare_backbone_features(backbone)
    image_embed = feats[-1]
    image_embed = image_embed + model.no_mem_embed.reshape(1, 1, 1, -1).to(image_embed.dtype)
    heads = model.forward_sam_heads(
        image_embed, point_inputs={"point_coords": torch.from_numpy(coords).to(dev),
                                   "point_labels": torch.from_numpy(labels).to(dev)},
        high_res_features=feats[:-1], multimask_output=True)
    out["out_low_res_multimasks"] = _np(heads.low_res_multimasks)
    out["out_ious"] = _np(heads.ious)
    out["out_obj_ptr"] = _np(heads.obj_ptr)
    out["out_object_score_logits"] = _np(heads.object_score_logits)

    # memory encoder on the best mask
    mem_feats, _ = model.encode_new_memory(feats[-1], heads.high_res_masks,
                                           is_mask_from_pts=True)
    out["out_maskmem_features"] = _np(mem_feats)
    return out


def compare_goldens(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                    atol: float = 1e-3) -> Dict[str, float]:
    """Max abs diff per shared output key; raises on a mismatch beyond atol."""
    diffs = {}
    for k in a:
        if not k.startswith("out_") or k not in b:
            continue
        d = float(np.max(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))))
        diffs[k] = d
        if not d <= atol:
            raise AssertionError(f"golden mismatch at {k}: max abs diff {d}")
    return diffs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", help="output .npz path")
    ap.add_argument("--ckpt", default=None, help="a checkpoint of the port or a SAM2 .pt")
    ap.add_argument("--preset", default="sam2_hiera_t")
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from medsam2_tpu_torch.configs import get_config

    model = SAM2Model(get_config(args.preset, image_size=args.image_size), seed=args.seed,
                      device=args.device)
    if args.ckpt:
        from medsam2_tpu_torch.checkpoint.store import load_params

        load_params(args.ckpt, model)
    goldens = dump_goldens(model, args.seed)
    np.savez_compressed(args.out, **goldens)
    print(f"wrote {len(goldens)} arrays to {args.out}")


if __name__ == "__main__":
    main()
