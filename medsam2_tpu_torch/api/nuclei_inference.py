"""Nuclei instance inference (counterpart of
``medsam2_tpu/api/nuclei_inference.py``; the reference's 2D val engine,
``func_2d/function.py:268-678``, and ``crop_with_overlap``, ``:872-907``):
sliding-window crops -> prompter points -> SAM decode of one mask per cell
-> the similarity-bank write -> NMS merge -> an instance map.

The functions take the port's modules where the JAX package takes
``(params, cfg, rcfg)``: a :class:`~medsam2_tpu_torch.core.sam2_model.SAM2Model`
and a :class:`~medsam2_tpu_torch.prompter.dpa_p2pnet.Prompter`, each on its
device (the card unless the caller built it on the CPU), and a
``torch.Generator`` on the model's device for the bank's draws where JAX
takes a key. Each step is a module-level function, so that a profiler can
wrap it: :func:`predict_points` (prompter), ``encode_and_condition``
(encoder and bank read), :func:`decode_chunk` (one batch of prompts),
:func:`write_memory` (memory encoder and bank write) and
:func:`merge_instances` (host).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from medsam2_tpu_torch.api.automatic_mask_generator import packbits
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.ops.nms import batched_nms_np, point_nms_np
from medsam2_tpu_torch.postproc.amg_utils import batched_mask_to_box
from medsam2_tpu_torch.prompter.dpa_p2pnet import Prompter
from medsam2_tpu_torch.state import similarity_bank as sb
from medsam2_tpu_torch.train.recipe_2d import encode_and_condition


# the reference's eval thresholds (func_2d/function.py:386, 615-620)
POINT_NMS_DIST = 12.0
MASK_NMS_THRESH = 0.6


def crop_with_overlap(h: int, w: int, crop_size: int, overlap: int) -> List[Tuple[int, int]]:
    """Top-left corners of overlapping crops covering [0,h)x[0,w)
    (``func_2d/function.py:872-907`` semantics)."""
    stride = max(crop_size - overlap, 1)
    xs = list(range(0, max(w - crop_size, 0) + 1, stride)) or [0]
    ys = list(range(0, max(h - crop_size, 0) + 1, stride)) or [0]
    if xs[-1] + crop_size < w:
        xs.append(w - crop_size)
    if ys[-1] + crop_size < h:
        ys.append(h - crop_size)
    return [(x, y) for y in ys for x in xs]


@torch.no_grad()
def predict_points(prompter: Prompter, image: torch.Tensor, filtering: bool = False):
    """Prompter inference (``modeling/utils.py:390-432``): foreground points
    with scores, numpy. image [1, H, W, 3] on the prompter's device. For one
    foreground class the argmax-foreground rule equals ``fg_score > 0.5``,
    and the winning class's probability the summed foreground one.
    ``filtering`` keeps only points whose pixel is positive in the
    prompter's semantic mask (``utils.py:423-427``). Returns (points [K, 2],
    scores [K])."""
    outputs, _ = prompter(image)
    # one pull for both: logits [N, C+1] and coords [N, 2]
    both = torch.cat([outputs["pred_logits"][0].float(), outputs["pred_coords"][0].float()],
                     dim=-1).cpu().numpy()
    logits, coords = both[:, :-2], both[:, -2:].copy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    fg_score = probs[:, :-1].sum(-1)
    cls = probs.argmax(-1)
    keep = (cls < probs.shape[-1] - 1) & (fg_score > 0.5)
    # clip into the image (the reference clips x to W-1 / y to H-1 first)
    H, W = image.shape[1], image.shape[2]
    coords[:, 0] = np.clip(coords[:, 0], 0, W - 1)
    coords[:, 1] = np.clip(coords[:, 1], 0, H - 1)
    coords, scores = coords[keep], fg_score[keep]
    if filtering and len(coords):
        sem = outputs["pred_masks"][0].float().cpu().numpy() > 0
        on_mask = sem[coords.astype(int)[:, 1], coords.astype(int)[:, 0]]
        coords, scores = coords[on_mask], scores[on_mask]
    return coords, scores


def decode_chunk(model: SAM2Model, image_embed, high_res, image_pe, coords, labels,
                 packed: bool):
    """One batch of single-point prompts against one image: the eval
    decoder (the dynamic-stability fallback, ``func_2d/function.py:271``),
    upsampled to S. Returns (masks [N, S, S] logits, or ``> 0`` bit-packed
    along the width when ``packed``, ious [N]) on the device."""
    N, S = coords.shape[0], model.cfg.image_size
    sparse, dense = model.sam_prompt_encoder((coords, labels))
    low_res, ious, _, _ = model.sam_mask_decoder(
        image_embed.expand(N, *image_embed.shape[1:]), image_pe, sparse, dense,
        multimask_output=False, high_res_features=[f.expand(N, *f.shape[1:]) for f in high_res],
        dynamic_multimask_via_stability=True)
    up = layers.interpolate(low_res.float().permute(0, 2, 3, 1), (S, S), method="bilinear")[..., 0]
    return (packbits(up > 0) if packed else up), ious[:, 0]


@torch.no_grad()
def decode_cells(model: SAM2Model, points: np.ndarray, bank, generator, image: torch.Tensor,
                 bank_nonempty: bool, max_batch: int = 64, return_memory: bool = False,
                 binary: bool = False):
    """SAM decode of one mask per point against ``image`` [1, S, S, 3],
    conditioned on the similarity ``bank``. Returns (masks [K, S, S], ious
    [K]) numpy: logits, or bool masks when ``binary`` (thresholded and
    bit-packed on the device, unpacked on the host: exact for every
    consumer of ``logits > 0``); plus (image_embed, vision_feats) when
    ``return_memory``, for the bank write (``function.py:511-565``).

    Prompts go in chunks of ``max_batch``, padded with label -1; every point
    has label 0, as the reference's validation (``function.py:416``
    hard-codes ``torch.zeros``), so it takes the negative-point embedding."""
    S, dev = model.cfg.image_size, model.device
    image_embed, high_res, vision_feats = encode_and_condition(
        model, image.to(dev), bank, generator, bank_nonempty, 1)
    image_pe = model.sam_prompt_encoder.get_dense_pe()
    masks, ious = [], []
    for start in range(0, len(points), max_batch):
        chunk = points[start:start + max_batch]
        k, pad = len(chunk), max_batch - len(chunk)
        coords = torch.from_numpy(
            np.pad(chunk, ((0, pad), (0, 0)))[:, None, :].astype(np.float32)).to(dev)
        labels = torch.from_numpy(
            np.pad(np.zeros(k, np.int32), (0, pad), constant_values=-1)[:, None]).to(dev)
        up, iou = decode_chunk(model, image_embed, high_res, image_pe, coords, labels, binary)
        masks.append(up[:k])
        ious.append(iou[:k])
    if masks:
        # one pull for every chunk
        m = torch.cat(masks).cpu().numpy()
        out = (np.unpackbits(m, axis=-1, count=S).astype(bool) if binary else m,
               torch.cat(ious).float().cpu().numpy())
    else:
        out = (np.zeros((0, S, S), bool if binary else np.float32), np.zeros((0,), np.float32))
    if return_memory:
        return out + (image_embed, vision_feats)
    return out


@torch.no_grad()
def write_memory(model: SAM2Model, bank, top_feat, masks: np.ndarray, ious: np.ndarray,
                 image_embed) -> None:
    """The eval-time bank write of one crop (``function.py:511-565``): the
    memory encoder on the union of its decoded masks, binarized as a
    point-prompted mask at eval (``sam2_base.py:676-681``), then
    :func:`~medsam2_tpu_torch.state.similarity_bank.write_similarity_bank`
    with the masks' mean predicted IoU. Writes are deterministic. Updates
    the caller's ``bank`` dict in place, as the JAX package does."""
    union = torch.from_numpy(masks.any(0).astype(np.float32)).to(model.device)[None, None]
    maskmem, _ = model.encode_new_memory(top_feat, union, is_mask_from_pts=True, binarize=True)
    bank.update(sb.write_similarity_bank(bank, maskmem, torch.tensor(np.float32(ious.mean())),
                                         image_embed.reshape(1, -1).float()))


def drop_points_in_processed_boxes(points: np.ndarray, processed_boxes) -> np.ndarray:
    """Boolean keep-mask dropping points strictly inside any previously
    processed crop box (interior test [x1+1, x2-1], ``function.py:365-372``):
    a point detected again in a later overlapping crop is discarded; the
    earlier crop owns it."""
    keep = np.ones(len(points), bool)
    for (px1, py1, px2, py2) in processed_boxes:
        keep &= ~((points[:, 0] >= px1 + 1) & (points[:, 0] <= px2 - 1)
                  & (points[:, 1] >= py1 + 1) & (points[:, 1] <= py2 - 1))
    return keep


def merge_instances(masks: List[np.ndarray], offsets: List[Tuple[int, int]], scores: np.ndarray,
                    boxes: np.ndarray, point_ids: np.ndarray, hw: Tuple[int, int],
                    mask_nms_thresh: float) -> np.ndarray:
    """The reference's two-stage cross-crop merge (``function.py:575-627``):

    1. per-point keep-best: a point decoded in several overlapping crops
       keeps only its highest-scoring instance;
    2. class-agnostic box NMS over the survivors;
    3. paint the instance map in *reversed* NMS order (ascending score, so
       higher-scoring masks overwrite): a mask is painted whole when any of
       its pixels is still uncovered, with its enumeration index as the id
       (ids of fully covered masks are skipped, leaving gaps as the
       reference numbers them; ``remap_label`` normalizes).

    Each mask is given on its crop, placed at the crop's top-left corner
    ``offsets[i]`` (x0, y0): the JAX package's image-sized masks are the
    case of zero offsets, and ``boxes`` are image coordinates."""
    scores = np.asarray(scores, np.float32)
    point_ids = np.asarray(point_ids)
    keep_prior = np.ones(len(point_ids), bool)
    uniq, counts = np.unique(point_ids, return_counts=True)
    for pid in uniq[counts > 1]:
        inds = np.where(point_ids == pid)[0]
        inds = np.delete(inds, np.argmax(scores[inds]))
        keep_prior[inds] = False

    kept = np.where(keep_prior)[0]
    if len(kept) == 0:
        return np.zeros(hw, np.int32)
    keep_by_nms = batched_nms_np(boxes[kept].astype(np.float32), scores[kept],
                                 np.zeros(len(kept)), mask_nms_thresh)
    order = kept[keep_by_nms][::-1]
    inst_map = np.zeros(hw, np.int32)
    for iid, ind in enumerate(order):
        m = masks[ind]
        x0, y0 = offsets[ind]
        region = inst_map[y0:y0 + m.shape[0], x0:x0 + m.shape[1]]
        if m.any() and (region[m] == 0).any():
            region[m] = iid + 1
    return inst_map


def predict_instances(model: SAM2Model, prompter: Prompter, sample: Dict, bank, generator,
                      crop_size: Optional[int] = None, overlap: int = 64,
                      filtering: bool = False) -> np.ndarray:
    """Full-image nuclei instance prediction -> int32 instance map.

    The reference's sliding-window flow (``func_2d/function.py:330-627``):
    per-crop prompter points (optionally ``filtering`` by its semantic mask)
    -> drop points inside already processed crops -> progressive point NMS
    over the accumulated set -> decode every surviving point in *each* crop
    that contains it (crops with fewer than two are skipped, ``:412``) ->
    the crop's union memory written into ``bank`` (in place; later crops
    and images condition on it) ->
    :func:`merge_instances`. The image must be at least ``crop_size``
    (default: the model's image size) on each side."""
    img = np.asarray(sample["image"], np.float32)
    H, W = img.shape[:2]
    crop_size = crop_size or model.cfg.image_size
    max_batch = int(os.environ.get("MEDSAM2_NUCLEI_CHUNK", "64"))
    bank_nonempty = bool(bank["valid"].any())

    processed_boxes: List[Tuple[int, int, int, int]] = []
    acc_points = np.zeros((0, 2), np.float32)
    acc_scores = np.zeros((0,), np.float32)
    point_id_map: Dict[Tuple[float, float], int] = {}
    masks: List[np.ndarray] = []
    offsets: List[Tuple[int, int]] = []
    mask_scores: List[float] = []
    boxes: List[np.ndarray] = []
    mask_pids: List[int] = []
    for (x0, y0) in crop_with_overlap(H, W, crop_size, overlap):
        x1, y1, x2, y2 = x0, y0, x0 + crop_size, y0 + crop_size
        # one upload per crop, shared by the prompter and the SAM decode
        crop = torch.from_numpy(np.ascontiguousarray(
            img[None, y0:y0 + crop_size, x0:x0 + crop_size])).to(prompter.device)
        pts, scores = predict_points(prompter, crop, filtering=filtering)
        if len(pts):
            gpts = pts + np.array([x0, y0], np.float32)
            keep = drop_points_in_processed_boxes(gpts, processed_boxes)
            acc_points = np.concatenate([acc_points, gpts[keep]])
            acc_scores = np.concatenate([acc_scores, scores[keep]])
        processed_boxes.append((x1, y1, x2, y2))
        if len(acc_points) == 0:
            continue
        # progressive NMS over everything accumulated so far (function.py:386)
        keep = point_nms_np(acc_points, acc_scores, POINT_NMS_DIST)
        cur_points = acc_points[keep]
        cur_ids = np.array([point_id_map.setdefault(tuple(p), len(point_id_map))
                            for p in cur_points])
        in_crop = ((cur_points[:, 0] >= x1) & (cur_points[:, 0] < x2)
                   & (cur_points[:, 1] >= y1) & (cur_points[:, 1] < y2))
        if in_crop.sum() <= 1:
            continue
        local = cur_points[in_crop] - np.array([x0, y0], np.float32)
        binm, ious, image_embed, vision_feats = decode_cells(
            model, local, bank, generator, crop, bank_nonempty, max_batch=max_batch,
            return_memory=True, binary=True)
        write_memory(model, bank, vision_feats[-1], binm, ious, image_embed)
        bank_nonempty = True
        pids = cur_ids[in_crop]
        local_boxes = batched_mask_to_box(torch.from_numpy(binm)).numpy()
        for k in range(len(local)):
            m = binm[k]
            masks.append(m)
            offsets.append((x0, y0))
            # merge scores are the raw predicted IoUs (function.py:568-570,
            # 615-620)
            mask_scores.append(float(ious[k]))
            boxes.append(local_boxes[k] + np.float32(m.any()) * np.array([x0, y0, x0, y0],
                                                                         np.float32))
            mask_pids.append(int(pids[k]))

    if not masks:
        return np.zeros((H, W), np.int32)
    return merge_instances(masks, offsets, np.asarray(mask_scores, np.float32),
                           np.stack(boxes), np.asarray(mask_pids), (H, W), MASK_NMS_THRESH)
