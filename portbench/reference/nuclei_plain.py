"""Plain PyTorch joint nuclei training: the DPA-P2PNet point prompter on a
GroupNorm ResNet and SAM 2 trained together, one AdamW step at a time,
written from the fork's description (``func_2d/function.py:27-266``,
``sam2_train/modeling/dpa_p2pnet.py``, ``fpn.py``, ``criterion.py``,
``matcher.py``) over :mod:`portbench.reference.sam2_plain`'s SAM 2.

It is the yardstick that decides whether the program's training steps are
correct. It imports nothing of the program: it takes a state dict (SAM 2's
upstream key names, the prompter's under ``prompter.``), the configuration
file, the batches and the program's choices where they tie, and computes in
float32 with TF32 off.

One step: the prompter's training forward (the mask head's batch
statistics, head dropout after each hidden ReLU) -> the predicted point
nearest each ground-truth cell point is that cell's prompt -> SAM 2 encodes
the images and, with a non-empty bank, conditions the top level on the
drawn memories (memory attention, dropout on) -> one mask per cell slot ->
the memory encoder on the union of each image's cell masks -> the
Hungarian match of the prompter's points to the ground truth (float64 cost)
-> six losses -> gradients -> the prompter's gradients clipped by their
global norm -> AdamW.

Where the program chose between near-equal options, the reference takes the
program's choice inside a tolerance and its own outside it, as a served
model's reference runs over the served tokens: the nearest predicted point
(``point_tie`` px), the Hungarian assignment (``match_tie`` in the cost).
The bank's draws are the program's; the dropout masks come from generators
seeded as the program's and drawn in its order.

``precision`` rounds the operands of every product and convolution, and
the gradients flowing back through them, to a lower format: ``{"sam":
"fp8", "prompter": "bf16"}`` stands in the program's place with each part
one step below the precision it runs in, ``{"sam": "fp8", "prompter":
"fp32"}`` with SAM 2 alone below it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.sam2_plain import PlainSAM2, axial_cis, exact_float32, fp8_round, \
    sine_grid

# depths, output widths, bottleneck (timm's resnet, GroupNorm variant)
RESNETS = {
    "resnet18": ((2, 2, 2, 2), (64, 128, 256, 512), False),
    "resnet34": ((3, 4, 6, 3), (64, 128, 256, 512), False),
    "resnet50": ((3, 4, 6, 3), (256, 512, 1024, 2048), True),
}
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BN_EPS = 1e-5
GN_EPS = 1e-5


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8":
        return fp8_round(x)
    return x


class _Round(torch.autograd.Function):
    """Forward and backward rounded to ``fmt``: a lower-precision operand and
    the lower-precision gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return round_to(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.fmt), None


def quant(x: torch.Tensor, fmt: str) -> torch.Tensor:
    return x if fmt == "fp32" else _Round.apply(x, fmt)


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    """Inverted dropout, the keep mask drawn as ``rand(x.shape) < 1 - rate``."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def groups_of(c: int, groups: int = 32) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


# ---------------------------------------------------------------------------
# SAM 2 with a training forward
# ---------------------------------------------------------------------------


class PlainSAMTrain(PlainSAM2):
    """:class:`PlainSAM2` over trainable leaves, with the memory attention's
    dropout and a mask decoder call over many prompts of a batch of images."""

    def __init__(self, weights, model: dict, precision: str = "fp32"):
        super().__init__(weights, model)
        self.prec = precision

    def _q(self, x):
        return quant(x, self.prec)

    def decode(self, pix, high_res, coords, labels, image_indices):
        """Single-mask output for each prompt row: pix [B, s, s, C] and the
        high-res features are gathered by ``image_indices`` [R]; coords
        [R, 1, 2] pixels, labels [R, 1]. Returns (low-res logits [R, 4s,
        4s], IoU predictions [R]). The object score does not gate the
        masks here: the training step reads the decoder's masks as they
        come."""
        a = self.a
        p = "sam_mask_decoder"
        R = coords.shape[0]
        dev = pix.device
        sparse, dense = self.prompt(coords, labels, R)
        s = a.sam_image_embedding_size
        ys = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        gy, gx = torch.meshgrid(ys, ys, indexing="ij")
        image_pe = self._pe(torch.stack([gx, gy], dim=-1))[None].expand(R, s, s, -1)
        n_mask = a.num_multimask_outputs + 1
        out_tokens = torch.cat([self.W[p + ".obj_score_token.weight"],
                                self.W[p + ".iou_token.weight"],
                                self.W[p + ".mask_tokens.weight"]], dim=0)
        tokens = torch.cat([out_tokens[None].expand(R, -1, -1), sparse], dim=1)
        src = pix.index_select(0, image_indices) + dense
        hs, src = self._twoway(src, image_pe, tokens)
        iou_tok, mask_toks = hs[:, 1], hs[:, 2: 2 + n_mask]
        src = src.reshape(R, s, s, -1)
        feat_s0, feat_s1 = (f.index_select(0, image_indices) for f in high_res)
        up = F.gelu(self.ln(self.conv_t(src, p + ".output_upscaling.0") + feat_s1,
                            p + ".output_upscaling.1", 1e-6))
        up = F.gelu(self.conv_t(up, p + ".output_upscaling.3") + feat_s0)
        hyper = self.mlp(mask_toks[:, 0], f"{p}.output_hypernetworks_mlps.0", 3)
        masks = torch.einsum("rc,rhwc->rhw", self._q(hyper), self._q(up))
        iou = self.mlp(iou_tok, p + ".iou_prediction_head", a.iou_head_depth,
                       sigmoid=a.iou_prediction_use_sigmoid)
        return masks, iou[:, 0]

    def mem_attention_train(self, curr, curr_pos, memory, memory_pos, gen, rate: float):
        """:meth:`PlainSAM2.mem_attention` (no object pointers) with dropout
        on the self-attention's, the cross-attention's and the FFN's outputs
        and on the FFN's hidden activations, drawn in that order, layer by
        layer."""
        ma = self.a.memory_attention
        side = int(round(math.sqrt(curr.shape[1])))
        cis = axial_cis(ma.d_model // ma.self_attn_num_heads, side, side, ma.rope_theta,
                        curr.device)
        x = curr + 0.1 * curr_pos if ma.pos_enc_at_input else curr
        act = F.relu if ma.activation == "relu" else F.gelu
        for li in range(ma.num_layers):
            lp = f"memory_attention.layers.{li}"
            t2 = self.ln(x, lp + ".norm1", 1e-5)
            q = t2 + curr_pos if ma.pos_enc_at_attn else t2
            x = x + dropout(self._rope_attn(lp + ".self_attn", q, q, t2, cis), rate, gen)
            t2 = self.ln(x, lp + ".norm2", 1e-5)
            q = t2 + curr_pos if ma.pos_enc_at_cross_attn_queries else t2
            k = memory + memory_pos if ma.pos_enc_at_cross_attn_keys else memory
            x = x + dropout(self._rope_attn(lp + ".cross_attn_image", q, k, memory, cis), rate,
                            gen)
            t2 = self.ln(x, lp + ".norm3", 1e-5)
            h = dropout(act(self.lin(t2, lp + ".linear1")), rate, gen)
            x = x + dropout(self.lin(h, lp + ".linear2"), rate, gen)
        return self.ln(x, "memory_attention.norm", 1e-5)


# ---------------------------------------------------------------------------
# The prompter
# ---------------------------------------------------------------------------


def anchor_points(h: int, w: int, space: int, device) -> torch.Tensor:
    """One anchor every ``space`` px, centred in its cell, rows of x then y:
    [N, 2] (x, y)."""
    ax = torch.arange(math.ceil(w / space), dtype=torch.float32, device=device) * space
    ay = torch.arange(math.ceil(h / space), dtype=torch.float32, device=device) * space
    gy, gx = torch.meshgrid(ay, ax, indexing="ij")
    origin = torch.tensor([(w % space or space) / 2, (h % space or space) / 2], device=device)
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2) + origin


class PlainPrompter:
    """DPA-P2PNet's training forward over the ``prompter.`` leaves of ``W``,
    channels first."""

    def __init__(self, W: Dict[str, torch.Tensor], pcfg: dict, precision: str = "fp32"):
        self.W = W
        self.c = pcfg
        self.prec = precision

    def _q(self, x):
        return quant(x, self.prec)

    def w(self, name):
        return self.W["prompter." + name]

    def b(self, name):
        return self.W.get("prompter." + name)

    def conv(self, x, name, stride=1, padding=0):
        return F.conv2d(self._q(x), self._q(self.w(name + ".weight")), self.b(name + ".bias"),
                        stride, padding)

    def gn(self, x, name):
        return F.group_norm(x, groups_of(x.shape[1]), self.w(name + ".weight"),
                            self.w(name + ".bias"), GN_EPS)

    def lin(self, x, name):
        y = self._q(x) @ self._q(self.w(name + ".weight")).t()
        return y + self.w(name + ".bias")

    def backbone(self, x) -> List[torch.Tensor]:
        depths, widths, bottleneck = RESNETS[self.c["backbone"]]
        y = F.relu(self.gn(self.conv(x, "backbone.stem.conv", 2, 3), "backbone.stem.gn"))
        y = F.max_pool2d(y, 3, 2, 1)
        outs = []
        for s, depth in enumerate(depths):
            for i in range(depth):
                y = self.block(y, f"backbone.stages.{s}.{i}", 2 if (i == 0 and s > 0) else 1,
                               bottleneck)
            outs.append(y)
        return outs

    def block(self, x, p: str, stride: int, bottleneck: bool):
        if bottleneck:
            y = F.relu(self.gn(self.conv(x, p + ".conv1"), p + ".gn1"))
            y = F.relu(self.gn(self.conv(y, p + ".conv2", stride, 1), p + ".gn2"))
            y = self.gn(self.conv(y, p + ".conv3"), p + ".gn3")
        else:
            y = F.relu(self.gn(self.conv(x, p + ".conv1", stride, 1), p + ".gn1"))
            y = self.gn(self.conv(y, p + ".conv2", 1, 1), p + ".gn2")
        identity = x
        if "prompter." + p + ".downsample.conv.weight" in self.W:
            identity = self.gn(self.conv(x, p + ".downsample.conv", stride),
                               p + ".downsample.gn")
        return F.relu(y + identity)

    def fpn(self, feats, name: str, num_outs: int):
        lat = [self.conv(f, f"{name}.lateral.{i}") for i, f in enumerate(feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[-2:],
                                                    mode="nearest")
        return [self.conv(lat[i], f"{name}.fpn.{i}", padding=1) for i in range(num_outs)]

    def head(self, x, name: str, gen, rate: float):
        x = dropout(F.relu(self.lin(x, name + ".l1")), rate, gen)
        if "prompter." + name + ".l2.weight" in self.W:
            x = dropout(F.relu(self.lin(x, name + ".l2")), rate, gen)
        return self.lin(x, name + ".out")

    @staticmethod
    def sample(feat, coords):
        """Bilinear samples of ``feat`` [B, C, H, W] at normalised (x, y)
        ``coords`` [B, N, 2], corners aligned, border padding: [B, N, C]."""
        out = F.grid_sample(feat, coords[:, :, None, :], mode="bilinear",
                            padding_mode="border", align_corners=True)
        return out[..., 0].transpose(1, 2)

    def forward(self, images, gen: Optional[torch.Generator]):
        """images [B, H, W, 3] -> ({pred_coords [B, N, 2], pred_logits
        [B, N, C+1], pred_masks [B, H, W]}, the mask head's batch statistics
        {mean, var (unbiased)}). The SAM feature injection (SR_PFO) runs
        only with a semantic feature, which the training step does not
        pass."""
        c = self.c
        rate = c["dropout"]
        L = c["num_levels"]
        B, H, W, _ = images.shape
        trunk = self.backbone(images.permute(0, 3, 1, 2))
        feats = self.fpn(trunk, "neck", L)
        feats1 = self.fpn(trunk, "neck1", 1)[0]
        strides = [2 ** (i + 2) for i in range(L)]
        proposals = anchor_points(H, W, c["space"], images.device)[None].expand(B, -1, -1)

        def normalise(coords, level):
            h, w = feats[level].shape[-2:]
            size = torch.tensor([w, h], dtype=torch.float32, device=coords.device)
            return 2.0 * coords / strides[level] / size - 1.0

        roi = self.sample(feats[0], normalise(proposals, 0))
        deformed = proposals + self.head(roi, "deform_layer", gen, rate)
        roi_cat = torch.cat([self.sample(feats[i], normalise(deformed, i)) for i in range(L)],
                            dim=-1)
        gh, gw = -(-H // c["space"]), -(-W // c["space"])
        grid = roi_cat.reshape(B, gh, gw, -1).permute(0, 3, 1, 2)
        roi_feat = self.conv(grid, "conv", padding=1).permute(0, 2, 3, 1).reshape(B, gh * gw, -1)
        pred_coords = deformed + self.head(roi_feat, "reg_head", gen, rate)
        pred_logits = self.head(roi_feat, "cls_head", gen, rate)
        m = self.conv(feats1, "mask_head.conv1", padding=1)
        mu = m.mean(dim=(0, 2, 3))
        var = m.var(dim=(0, 2, 3), correction=0)
        n = m.shape[0] * m.shape[2] * m.shape[3]
        m = ((m - mu[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
             * self.w("mask_head.bn.weight")[:, None, None] + self.w("mask_head.bn.bias")[:, None, None])
        m = self.conv(F.relu(m), "mask_head.conv2", padding=1)
        pred_masks = F.interpolate(m, size=(H, W), mode="bilinear", align_corners=True)[:, 0]
        stats = {"mean": mu.detach(), "var": var.detach() * (n / max(n - 1, 1))}
        return {"pred_coords": pred_coords, "pred_logits": pred_logits,
                "pred_masks": pred_masks}, stats


# ---------------------------------------------------------------------------
# Losses and the match
# ---------------------------------------------------------------------------


def bce(logits, t):
    return -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits))


def focal(logits, t, gamma: float = 2.0):
    """Binary focal loss, no alpha, mean over all elements."""
    ce = bce(logits, t)
    return torch.mean((1.0 - torch.exp(-ce)) ** gamma * ce)


def dice_pooled(logits, t, eps: float = 1e-7):
    """One soft Dice over the whole batch; 0 when the batch has no
    foreground."""
    p = torch.sigmoid(logits)
    score = 2.0 * torch.sum(p * t) / (torch.sum(p) + torch.sum(t)).clamp_min(eps)
    return torch.where(torch.sum(t) > 0, 1.0 - score, torch.zeros_like(score))


def match_cost(rcfg: dict, pred_coords, pred_logits, gt_points, gt_labels, gt_valid):
    """The Hungarian cost [B, N, M] in float64: ``cost_point`` x the L2
    distance minus ``cost_class`` x the softmax probability of the ground
    truth's class; padding columns cost 1e9."""
    pc = np.asarray(pred_coords, np.float64)
    z = np.asarray(pred_logits, np.float64)
    gp = np.asarray(gt_points, np.float64)
    lbl = np.clip(np.asarray(gt_labels), 0, z.shape[-1] - 1)
    dist = np.sqrt(((pc[:, :, None, :] - gp[:, None, :, :]) ** 2).sum(-1))
    z = z - z.max(-1, keepdims=True)
    prob = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    B, N, M = dist.shape
    cls = -np.take_along_axis(prob, np.broadcast_to(lbl[:, None, :], (B, N, M)), axis=-1)
    m = rcfg["matcher"]
    cost = m["cost_point"] * dist + m["cost_class"] * cls
    return np.where(np.asarray(gt_valid, bool)[:, None, :], cost, 1e9)


def assignment_cost(cost_b: np.ndarray, assign: np.ndarray, valid: np.ndarray) -> float:
    cols = np.flatnonzero(valid)
    return float(cost_b[assign[cols], cols].sum())


def hungarian(cost: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
    """The matched prediction of each valid ground-truth slot [B, M], -1 in
    padding slots."""
    from scipy.optimize import linear_sum_assignment

    B, N, M = cost.shape
    out = -np.ones((B, M), np.int64)
    for b in range(B):
        cols = np.flatnonzero(gt_valid[b])
        if cols.size:
            rows, c = linear_sum_assignment(cost[b][:, cols])
            out[b, cols[c]] = rows
    return out


def step_losses(rcfg: dict, outputs, pred_cells, iou_cells, batch, src_idx):
    """The six weighted losses of the step."""
    cc = rcfg["criterion"]
    valid = batch["gt_valid"]
    B, M = valid.shape
    out = pred_cells.shape[-1]
    dev = pred_cells.device
    num_points = valid.float().sum().clamp_min(1.0)
    idx = src_idx.clamp_min(0)
    matched = torch.gather(outputs["pred_coords"], 1, idx[..., None].expand(B, M, 2))
    err = ((matched - batch["gt_points"]) ** 2).sum(-1)
    loss_reg = torch.where(valid, err, torch.zeros_like(err)).sum() / (num_points + 1e-7)
    logits = outputs["pred_logits"]
    N = logits.shape[1]
    bg = cc["num_classes"]
    targets = torch.full((B, N + 1), bg, dtype=torch.long, device=dev)
    cols = torch.where(valid & (src_idx >= 0), src_idx, torch.full_like(src_idx, N))
    targets = targets.scatter(1, cols, batch["gt_labels"].long())[:, :N]
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
    weight = torch.where(targets == bg, torch.full_like(nll, cc["eos_coef"]), torch.ones_like(nll))
    loss_cls = (nll * weight).sum() / weight.sum().clamp_min(1e-7)
    vflat = valid.reshape(B * M)
    flat_pred = torch.where(vflat[:, None, None], pred_cells.reshape(B * M, out, out),
                            torch.full((), -1e9, device=dev))
    flat_gt = torch.where(vflat[:, None, None], batch["gt_cell_masks"].reshape(B * M, out, out),
                          torch.zeros((), device=dev))
    flat_iou = torch.where(vflat, iou_cells.reshape(B * M), torch.ones((), device=dev))
    p = torch.sigmoid(flat_pred)
    inter = (p * flat_gt).sum((1, 2))
    union = p.sum((1, 2)) + flat_gt.sum((1, 2)) - inter
    soft_iou = (inter + 1e-7) / (union + 1e-7)
    valid_frac = vflat.float().mean().clamp_min(1e-6)
    return {
        "loss_reg": loss_reg * cc["reg_loss_coef"],
        "loss_cls": loss_cls * cc["cls_loss_coef"],
        "loss_mask": focal(outputs["pred_masks"], batch["gt_semantic"]) * cc["mask_loss_coef"],
        "loss_focal": dice_pooled(flat_pred, flat_gt) * cc["loss_focal"],
        "loss_dice": focal(flat_pred, flat_gt) * cc["loss_dice"] / valid_frac,
        "loss_iou": torch.mean((soft_iou - flat_iou) ** 2) * cc["loss_iou"] / valid_frac,
    }


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def is_trainable(name: str) -> bool:
    """The recipe trains every SAM 2 parameter but the prompt encoder's and
    every prompter parameter; the BatchNorm's running statistics are not
    parameters."""
    if name.startswith("prompter."):
        return "running_" not in name
    return not name.startswith("sam_prompt_encoder.")


class PlainNucleiTrainer:
    """Plain joint training from a state dict ``weights`` (the seed's initial
    weights) and a configuration document (``model``, ``prompter``,
    ``recipe``). ``precision``: ``"fp32"`` or ``{"sam": fmt, "prompter":
    fmt}``."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg_doc: dict, precision="fp32"):
        prec = precision if isinstance(precision, dict) else {"sam": precision,
                                                              "prompter": precision}
        self.rcfg = cfg_doc["recipe"]
        self.names = sorted(n for n in weights if is_trainable(n))
        self.leaves = {n: weights[n].detach().float().clone().requires_grad_(True)
                       for n in self.names}
        W = {k: v.detach().float() for k, v in weights.items()}
        W.update(self.leaves)
        self.sam = PlainSAMTrain({k: v for k, v in W.items() if not k.startswith("prompter.")},
                                 cfg_doc["model"], prec["sam"])
        self.sam.W.update({k: v for k, v in self.leaves.items() if not k.startswith("prompter.")})
        self.prompter = PlainPrompter(W, cfg_doc["prompter"], prec["prompter"])
        self.m = {n: torch.zeros_like(t) for n, t in self.leaves.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.leaves.items()}
        self.t = 0

    @torch.no_grad()
    def load(self, params: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor],
             v: Dict[str, torch.Tensor], t: int) -> None:
        """Take up a training state: the trained leaves, AdamW's moments and
        its step count."""
        for n in self.names:
            self.leaves[n].copy_(params[n])
            self.m[n].copy_(m[n])
            self.v[n].copy_(v[n])
        self.t = t

    def choose_points(self, pred_coords, batch, follow, tie: float):
        """The predicted point nearest each ground-truth point, or the
        program's where its distance is within ``tie`` px of the nearest.
        Returns (points [B, M, 2], chosen indices, gaps: the largest distance
        gap taken, the largest and the count of the program's choices that
        differ)."""
        d = torch.linalg.vector_norm(pred_coords[:, None] - batch["gt_points"][:, :, None],
                                     dim=-1)                                  # [B, M, N]
        own = d.argmin(dim=-1)
        idx = own
        gaps = {"taken": 0.0, "differ": 0.0, "n": 0}
        if follow is not None and tuple(follow.shape) == tuple(own.shape):
            prog = follow.to(d.device)
            dg = d.gather(-1, prog[..., None])[..., 0] - d.gather(-1, own[..., None])[..., 0]
            differ = (prog != own) & batch["gt_valid"]
            take = (dg <= tie) & differ
            idx = torch.where(take, prog, own)
            zero = torch.zeros_like(dg)
            gaps = {"taken": float(torch.where(take, dg, zero).max()),
                    "differ": float(torch.where(differ, dg, zero).max()), "n": int(differ.sum())}
        pts = torch.gather(pred_coords, 1, idx[..., None].expand(*idx.shape, 2))
        pts = torch.where(batch["gt_valid"][..., None], pts, torch.zeros_like(pts))
        return pts, idx, gaps

    def choose_match(self, outputs, batch, follow, tie: float):
        """The Hungarian assignment of the reference's float64 cost, or per
        image the program's where its cost lies within ``tie`` of the
        optimum. Returns (src_idx [B, M], the assignment, gaps as
        :meth:`choose_points`)."""
        valid = batch["gt_valid"].cpu().numpy()
        cost = match_cost(self.rcfg, outputs["pred_coords"].detach().cpu().numpy(),
                          outputs["pred_logits"].detach().cpu().numpy(),
                          batch["gt_points"].cpu().numpy(), batch["gt_labels"].cpu().numpy(),
                          valid)
        own = hungarian(cost, valid)
        out = own.copy()
        gaps = {"taken": 0.0, "differ": 0.0, "n": 0}
        if follow is not None and np.shape(follow) == own.shape:
            prog = np.asarray(follow, np.int64)
            for b in range(own.shape[0]):
                if np.array_equal(prog[b][valid[b]], own[b][valid[b]]):
                    continue
                g = (assignment_cost(cost[b], prog[b], valid[b])
                     - assignment_cost(cost[b], own[b], valid[b]))
                gaps["n"] += 1
                gaps["differ"] = max(gaps["differ"], g)
                if g <= tie:
                    out[b] = prog[b]
                    gaps["taken"] = max(gaps["taken"], g)
        return torch.from_numpy(out).to(outputs["pred_coords"].device), out, gaps

    def forward(self, batch, bank_feats, bank_idx, gens, follow: dict, ties: dict):
        """The step's forward: losses, the prompter's batch statistics, the
        mask decoder's low-res logits of every cell slot [B * M, 4s, 4s], the
        new memories, the choices made and the tie gaps taken."""
        a = self.sam.a
        images = batch["images"]
        B, S = images.shape[0], a.image_size
        M = batch["gt_valid"].shape[1]
        outputs, stats = self.prompter.forward(images, gens["head"])
        nearest, point_idx, point_gaps = self.choose_points(
            outputs["pred_coords"].detach(), batch, follow.get("points"), ties["point_tie"])
        feats, pos = self.sam.encode(images)
        top = feats[-1]
        _, s, _, C = top.shape
        if bank_feats is not None:
            idx = torch.as_tensor(bank_idx, device=images.device).long()
            if idx.shape[0] != B:
                # the program drew for other rows than the batch's: its rows
                # repeat, so that the step still runs and the losses judge it
                idx = idx.repeat((B + idx.shape[0] - 1) // idx.shape[0], 1)[:B]
            memory = bank_feats[idx].reshape(B, -1, a.mem_dim)
            n = idx.shape[1]
            mem_pos = sine_grid(s, s, a.mem_dim, images.device).reshape(s * s, a.mem_dim)
            mem_pos = mem_pos.repeat(n, 1)[None].expand(B, -1, -1)
            curr_pos = pos.reshape(1, s * s, C).expand(B, -1, -1)
            top = self.sam.mem_attention_train(
                top.reshape(B, s * s, C), curr_pos, memory, mem_pos, gens["dropout"],
                a.memory_attention.dropout).reshape(B, s, s, C)
        labels = torch.where(batch["gt_valid"], batch["gt_labels"].long(),
                             torch.full_like(batch["gt_labels"].long(), -1)).reshape(B * M, 1)
        image_indices = torch.arange(B, device=images.device).repeat_interleave(M)
        low, iou = self.sam.decode(top, feats[:-1], nearest.reshape(B * M, 1, 2), labels,
                                   image_indices)
        out = self.rcfg["out_size"]
        pred_cells = F.interpolate(low[:, None], size=(out, out), mode="bilinear",
                                   align_corners=False).reshape(B, M, out, out)
        iou_cells = iou.reshape(B, M)
        with torch.no_grad():
            union = torch.where(batch["gt_valid"][..., None, None], pred_cells,
                                torch.full_like(pred_cells, float("-inf"))).amax(dim=1)
            binary = (union > 0).float()[:, None]
            if out != S:
                binary = F.interpolate(binary, size=(S, S), mode="bilinear", align_corners=False)
            memories = self.sam.mem_encode(top.detach(), binary)
        src_idx, match, match_gaps = self.choose_match(outputs, batch, follow.get("match"),
                                                      ties["match_tie"])
        losses = step_losses(self.rcfg, outputs, pred_cells, iou_cells, batch, src_idx)
        return {"losses": losses, "stats": stats, "cells": low.detach(), "memories": memories,
                "points": point_idx, "match": match,
                "gaps": {"point": point_gaps, "match": match_gaps}}

    def step(self, batch, bank_feats, bank_idx, gens, follow: dict, ties: dict) -> dict:
        """One training step; the leaves are updated in place. Returns the
        forward's record with the losses as floats and ``grads``, the
        gradients AdamW received (the prompter's clipped)."""
        with exact_float32():
            rec = self.forward(batch, bank_feats, bank_idx, gens, follow, ties)
            total = sum(rec["losses"].values())
            gs = torch.autograd.grad(total, [self.leaves[n] for n in self.names],
                                     allow_unused=True)
        grads = {n: (torch.zeros_like(self.leaves[n]) if g is None else g.detach())
                 for n, g in zip(self.names, gs)}
        clip = self.rcfg["clip_grad"]
        if clip > 0:
            pn = [n for n in self.names if n.startswith("prompter.")]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(grads[n])
                                                         for n in pn]))
            scale = torch.clamp(clip / norm.clamp_min(1e-9), max=1.0)
            for n in pn:
                grads[n] = grads[n] * scale
        self.adamw(grads)
        rec["losses"] = {**{k: float(v.detach()) for k, v in rec["losses"].items()},
                         "loss": float(total.detach())}
        rec["grads"] = grads
        return rec

    @torch.no_grad()
    def adamw(self, grads):
        """Decoupled weight decay, then Adam with bias correction."""
        lr, wd = self.rcfg["lr"], self.rcfg["weight_decay"]
        b1, b2 = BETAS
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n in self.names:
            p, g = self.leaves[n], grads[n]
            p.mul_(1 - lr * wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / math.sqrt(bc2) + ADAM_EPS
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
