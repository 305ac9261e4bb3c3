"""DPA-P2PNet point-detection prompter (counterpart of
``medsam2_tpu/prompter/dpa_p2pnet.py``; reference
``sam2_train/modeling/dpa_p2pnet.py``).

backbone -> two FPNs (every level, and the finest alone for the mask head)
-> optional SR_PFO injection of the SAM semantic feature -> an anchor every
``space`` px -> deformable proposals (features sampled at the anchors ->
offset MLP) -> multi-scale decoding (every level sampled at the deformed
points, concatenated, a 3x3 conv over the proposal lattice) -> coordinate
and class heads, and the semantic mask head.

Sampling is ``F.grid_sample`` (bilinear, ``align_corners=True``) with
``padding_mode="border"``: the JAX sampler clips the neighbour indices into
the map and keeps the unclipped weights, which is the border rule. The
default ``"zeros"`` agrees only for points inside [-1, 1], and deformed
proposals leave the map at the crop edges.

Training (``Prompter.train()``, the JAX package's ``dropout_key``): the mask
head's BatchNorm normalises with the batch statistics over (B, h, w) and
returns them (the unbiased variance) as ``mask_bn_stats`` for the caller's
running-stat update; a ``dropout_generator`` adds head dropout after each
hidden ReLU. Batch statistics follow the training mode alone, as the JAX
package's follow ``dropout_key`` at any rate, rate 0 included. In eval
mode (the default) the running statistics normalise and nothing drops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.prompter import backbone as bb
from medsam2_tpu_torch.prompter.fpn import FPN


@dataclasses.dataclass(frozen=True)
class PrompterConfig:
    backbone: str = "resnet50"
    num_levels: int = 4
    num_classes: int = 1
    hidden_dim: int = 256
    space: int = 16
    dropout: float = 0.1  # head MLP dropout (dpa_p2pnet.py:65-75), training only
    use_sr_pfo: bool = True
    # mask-head norm: "bn" is the reference's SyncBatchNorm (batch
    # statistics in training, running ones at eval, dpa_p2pnet.py:447-452);
    # "gn" the stateless GroupNorm variant
    mask_norm: str = "bn"

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(2 ** (i + 2) for i in range(self.num_levels))


def grid_sample_points(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NHWC ``feat`` [B, H, W, C] at normalized (x, y)
    ``coords`` [B, N, 2], align_corners=True, border padding. Returns
    [B, N, C]."""
    out = F.grid_sample(feat.permute(0, 3, 1, 2), coords[:, :, None, :].to(feat.dtype),
                        mode="bilinear", padding_mode="border", align_corners=True)
    return out[..., 0].transpose(1, 2)


def anchor_points(h: int, w: int, space: int) -> np.ndarray:
    """Anchor grid every ``space`` px (``dpa_p2pnet.py:43-60``). [N, 2] (x, y)."""
    ax = np.arange(np.ceil(w / space)) * space
    ay = np.arange(np.ceil(h / space)) * space
    anchors = np.stack(np.meshgrid(ax, ay), -1).astype(np.float32)
    origin = np.array([w % space or space, h % space or space], np.float32) / 2
    return (anchors + origin).reshape(-1, 2)


def head_dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout at ``rate`` drawn from ``generator`` (on x's device);
    the identity without a generator or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class HeadMLP(nn.Module):
    """The reference ``MLP(input, hidden, num_layers, out)``
    (``dpa_p2pnet.py:63-81``): ``n_hidden`` Linear -> ReLU -> Dropout
    layers, then a Linear. The deform / reg / cls heads have one hidden
    layer, SR_PFO's per-pixel MLP two."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, gen: torch.Generator,
                 n_hidden: int = 1):
        super().__init__()
        self.l1 = layers.Linear(in_dim, hidden, gen)
        self.l2 = layers.Linear(hidden, hidden, gen) if n_hidden >= 2 else None
        self.out = layers.Linear(hidden, out_dim, gen)

    def forward(self, x, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        x = head_dropout(F.relu(self.l1(x)), rate, generator)
        if self.l2 is not None:
            x = head_dropout(F.relu(self.l2(x)), rate, generator)
        return self.out(x)


class SRPFO(nn.Module):
    """SAM-guided point-feature optimization (``dpa_p2pnet.py:161-187``):
    each pyramid level goes through a shared per-pixel MLP and receives the
    scaled, MLP'd, conv-refined SAM feature resized to its resolution."""

    def __init__(self, dim: int, gen: torch.Generator, hidden: int = 512):
        super().__init__()
        self.mlp_p = HeadMLP(dim, hidden, dim, gen, n_hidden=2)
        self.conv1 = layers.Conv2d(dim, dim, 3, gen, padding=1)
        self.conv2 = layers.Conv2d(dim, dim, 3, gen, padding=1)
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, feats: List[torch.Tensor], sam_feature: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        sam = self.mlp_p(sam_feature * self.scale.to(sam_feature.dtype), rate, generator)
        out = []
        for f in feats:
            s = layers.interpolate(sam.float(), tuple(f.shape[1:3]), method="bilinear")
            s = self.conv2(F.relu(self.conv1(s.to(f.dtype))))
            out.append(self.mlp_p(f, rate, generator) + s)
        return out


class MaskBatchNorm(nn.Module):
    """The mask head's SyncBatchNorm, eps 1e-5, applied as the JAX package's
    scale and shift: in training the statistics of the batch over (B, h, w)
    with the biased variance (differentiated through, as torch's
    BatchNorm), returned with the unbiased variance for the running-stat
    update; at eval the running statistics. ``forward`` returns (output,
    the batch statistics or None)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        stats = None
        if self.training:
            xf = x.float()
            mu = xf.mean(dim=(0, 1, 2))
            var = xf.var(dim=(0, 1, 2), correction=0)
            n = xf.shape[0] * xf.shape[1] * xf.shape[2]
            stats = {"mean": mu.detach(), "var": var.detach() * (n / max(n - 1, 1))}
        else:
            mu, var = self.running_mean, self.running_var
        root = torch.sqrt(var + 1e-5)
        scale = self.weight / root
        shift = self.bias - mu * self.weight / root
        return x * scale.to(x.dtype) + shift.to(x.dtype), stats


class MaskHead(nn.Module):
    def __init__(self, dim: int, norm: str, gen: torch.Generator):
        super().__init__()
        self.conv1 = layers.Conv2d(dim, dim, 3, gen, padding=1)
        # the reference's nn.Conv2d(d, 1, kernel_size=1, padding=1)
        # (dpa_p2pnet.py:451): a k=1 conv over a one-pixel zero border, so
        # its output is (h+2, w+2) with a bias-valued rim
        self.conv2 = layers.Conv2d(dim, 1, 1, gen, padding=1)
        if norm == "bn":
            self.bn = MaskBatchNorm(dim)
        else:
            self.gn = bb.GroupNorm(dim)

    def forward(self, x):
        """(mask logits, the BatchNorm's batch statistics or None)."""
        m = self.conv1(x)
        stats = None
        if hasattr(self, "bn"):
            m, stats = self.bn(m)
        else:
            m = self.gn(m)
        return self.conv2(F.relu(m)), stats


class Prompter(nn.Module):
    """DPA-P2PNet with random weights from ``seed`` (or loaded through
    :func:`~medsam2_tpu_torch.checkpoint.convert.prompter_state_dict_from_jax`).
    Weights are made on the CPU from a seeded generator, then moved to
    ``device``: the card unless the caller asks for ``device="cpu"``; without
    a CUDA device the default raises. Frozen, in eval mode: the nuclei
    recipe's optimizer sets its parameters to require gradients and
    ``train()`` switches to the training forward."""

    def __init__(self, cfg: PrompterConfig, seed: int = 0, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Prompter: no CUDA device; pass device='cpu' to run on the CPU")
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d = cfg.hidden_dim
        chans = bb.backbone_channels(cfg.backbone)
        self.backbone = bb.make_backbone(cfg.backbone, gen)
        self.neck = FPN(chans, d, gen)
        self.neck1 = FPN(chans, d, gen)
        self.deform_layer = HeadMLP(d, d, 2, gen)
        self.reg_head = HeadMLP(d, d, 2, gen)
        self.cls_head = HeadMLP(d, d, cfg.num_classes + 1, gen)
        self.conv = layers.Conv2d(d * cfg.num_levels, d, 3, gen, padding=1)
        self.mask_head = MaskHead(d, cfg.mask_norm, gen)
        self.sr_pfo = SRPFO(d, gen) if cfg.use_sr_pfo else None
        self.requires_grad_(False)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.conv.weight.device

    def forward(self, images: torch.Tensor, semantic_feature: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """images [B, H, W, 3]; ``semantic_feature`` an optional SAM feature
        [B, h, w, hidden_dim]. Returns ({pred_coords [B, N, 2], pred_logits
        [B, N, C+1], pred_masks [B, H, W]}, plus ``mask_bn_stats`` {mean,
        var} in training with the BN mask head; the pyramid features).
        ``dropout_generator`` draws the head dropout (rate ``cfg.dropout``)
        in training; it is ignored at eval."""
        cfg = self.cfg
        rate = cfg.dropout if self.training else 0.0
        B, H, W, _ = images.shape
        trunk = self.backbone(images)
        feats = self.neck(trunk, cfg.num_levels)
        feats1 = self.neck1(trunk, 1)[0]
        if semantic_feature is not None and self.sr_pfo is not None:
            feats = self.sr_pfo(feats, semantic_feature, rate, dropout_generator)

        anchors = torch.from_numpy(anchor_points(H, W, cfg.space)).to(images.device)
        proposals = anchors[None].expand(B, *anchors.shape)

        def normalize(coords, level):
            h, w = feats[level].shape[1:3]
            size = torch.tensor([w, h], dtype=torch.float32, device=coords.device)
            return 2.0 * coords / cfg.strides[level] / size - 1.0

        # DPP: deform the proposals from the finest level's features
        roi = grid_sample_points(feats[0], normalize(proposals, 0))
        deformed = proposals + self.deform_layer(roi, rate, dropout_generator).to(proposals.dtype)
        # MSD: every level sampled at the deformed points, a 3x3 conv over
        # the (grid-shaped) proposal lattice
        roi_cat = torch.cat([grid_sample_points(feats[i], normalize(deformed, i))
                             for i in range(cfg.num_levels)], dim=-1)
        gh, gw = -(-H // cfg.space), -(-W // cfg.space)
        roi_feat = self.conv(roi_cat.reshape(B, gh, gw, -1)).reshape(B, gh * gw, -1)
        pred_coords = deformed + self.reg_head(roi_feat, rate,
                                               dropout_generator).to(deformed.dtype)
        pred_logits = self.cls_head(roi_feat, rate, dropout_generator)
        m, bn_stats = self.mask_head(feats1)
        pred_masks = layers.bilinear_resize_ac(m.float(), (H, W))[..., 0]
        outputs = {"pred_coords": pred_coords, "pred_logits": pred_logits,
                   "pred_masks": pred_masks}
        if bn_stats is not None:
            outputs["mask_bn_stats"] = bn_stats
        return outputs, feats
