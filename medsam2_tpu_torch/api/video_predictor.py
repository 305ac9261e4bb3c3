"""SAM2VideoPredictor: volume / video propagation through the memory bank
(counterpart of ``medsam2_tpu/api/video_predictor.py``).

The session is a host-side dict holding the normalised video on the device
and the recorded prompts. Objects are batched on axis 0. Prompt
(conditioning) frames are processed first and write cond memories; every other
frame from the first conditioning frame on is then tracked by a per-frame
Python loop (the JAX package's ``lax.scan``), with the trunk position
embedding and the positional half of the roped-key cache computed once per
propagation. Several conditioning frames split the frame order into runs, and
the stored prompt-frame outputs are spliced between them.

Ported: ``init_state(images=...)``, ``val_init_state``, ``reset_state``,
``add_new_points``, ``add_new_bbox`` and ``add_new_mask`` on conditioning
frames (each with its memoryless preview), ``propagate_in_video_batch`` and
``propagate_in_video`` forward from the first conditioning frame. Not ported
yet, and raising ``NotImplementedError``: corrections on tracked frames,
``reverse=True``, resuming past tracked frames, hole filling,
``clear_non_cond_mem_around_input``, frame loading from a directory, the
offload and async-loading flags, propagation without the roped-key cache and
``propagate_volumes_batched``.

:func:`_prompt_step` is also the 3D training recipe's prompt-frame step: with
grad enabled it is differentiable and returns ``pred_masks_high_res``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.sam2_model import (SAM2Model, apply_non_overlapping_constraints,
                                               compute_dtype, kcache_shape, use_multimask)
from medsam2_tpu_torch.state import memory_bank as mb
from medsam2_tpu_torch.utils.transforms import preprocess_video


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Model, max_cond_frames: int = 8,
                 fill_hole_area: int = 0, non_overlap_masks: bool = False,
                 use_kcache: bool = True, clear_non_cond_mem_around_input: bool = False):
        if fill_hole_area > 0:
            raise NotImplementedError("hole filling (fill_hole_area > 0) is not ported")
        if clear_non_cond_mem_around_input:
            raise NotImplementedError("clear_non_cond_mem_around_input is not ported")
        if not (use_kcache and kcache_shape(model.cfg)[0] > 0):
            raise NotImplementedError("only the storage-order readout over the roped-key "
                                      "cache is ported")
        self.model = model
        self.cfg = model.cfg
        self.max_cond_frames = max_cond_frames
        self.non_overlap_masks = non_overlap_masks

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _session_spec(self, state) -> mb.BankSpec:
        """Bank sized to the session's prompt count (capped at
        ``max_cond_frames``)."""
        n = max(1, min(len(state["cond_frame_idx"]), self.max_cond_frames))
        return mb.BankSpec.from_config(self.cfg, max_cond_frames=n)

    # ------------------------------------------------------------------
    # Session
    # ------------------------------------------------------------------

    def init_state(self, video_path: Optional[str] = None,
                   images: Optional[np.ndarray] = None,
                   offload_video_to_cpu: bool = False,
                   offload_state_to_cpu: bool = False,
                   async_loading_frames: bool = False) -> Dict:
        """Start a session from an image array [T, H, W, 3] (RGB, uint8 or
        float), resized to the model resolution and normalised on the
        device."""
        if images is None or video_path is not None:
            raise NotImplementedError("init_state takes images=...; frame directories "
                                      "are not ported")
        if offload_video_to_cpu or offload_state_to_cpu or async_loading_frames:
            raise NotImplementedError("offload and async-loading flags are not ported")
        images = np.asarray(images)
        return {
            "images": preprocess_video(images, self.cfg.image_size, self.device),
            "num_frames": int(images.shape[0]),
            "video_height": int(images.shape[1]),
            "video_width": int(images.shape[2]),
            "obj_id_to_idx": {},
            "obj_ids": [],
            "point_inputs_per_obj": {},      # {obj_idx: {frame: (coords, labels)}}
            "mask_inputs_per_obj": {},       # {obj_idx: {frame: [S, S] 0/1 mask}}
            "cond_frame_idx": set(),
            "frames_tracked": set(),
            "tracked": False,
            "is_eval": True,
        }

    def val_init_state(self, imgs_tensor) -> Dict:
        """Session from a [T, 3, S, S] or [T, S, S, 3] array
        (``val_init_state``, ``sam2_video_predictor.py:107``)."""
        arr = np.asarray(imgs_tensor, np.float32)
        if arr.ndim == 4 and arr.shape[1] == 3:
            arr = arr.transpose(0, 2, 3, 1)
        return self.init_state(images=arr)

    def reset_state(self, state: Dict) -> None:
        """Forget every object and prompt; keep the session's frames."""
        state.update(obj_id_to_idx={}, obj_ids=[], point_inputs_per_obj={},
                     mask_inputs_per_obj={}, cond_frame_idx=set(), frames_tracked=set(),
                     tracked=False)

    # ------------------------------------------------------------------
    # Prompts
    # ------------------------------------------------------------------

    def _obj_idx(self, state, obj_id):
        if obj_id not in state["obj_id_to_idx"]:
            if state["tracked"]:
                raise RuntimeError("Cannot add new objects after tracking starts; "
                                   "start a new session with init_state.")
            state["obj_id_to_idx"][obj_id] = len(state["obj_ids"])
            state["obj_ids"].append(obj_id)
            state["point_inputs_per_obj"][state["obj_id_to_idx"][obj_id]] = {}
            state["mask_inputs_per_obj"][state["obj_id_to_idx"][obj_id]] = {}
        return state["obj_id_to_idx"][obj_id]

    def _check_cond_frame(self, state, frame_idx: int) -> None:
        if (frame_idx in state["frames_tracked"] and frame_idx not in state["cond_frame_idx"]
                and not self.cfg.add_all_frames_to_correct_as_cond):
            raise NotImplementedError("corrections on tracked frames are not ported")

    def add_new_points(self, state, frame_idx: int, obj_id, points, labels,
                       clear_old_points: bool = True, normalize_coords: bool = True):
        """Record click prompts (video-resolution pixels unless
        ``normalize_coords=False``); returns (frame_idx, obj_ids, low-res mask
        logits preview [B, 1, h4, w4])."""
        self._check_cond_frame(state, frame_idx)
        obj_idx = self._obj_idx(state, obj_id)
        points = np.asarray(points, np.float32).reshape(-1, 2)
        labels = np.asarray(labels, np.int32).reshape(-1)
        if normalize_coords:
            points = points * (self.cfg.image_size / np.array(
                [state["video_width"], state["video_height"]], np.float32))
        store = state["point_inputs_per_obj"][obj_idx]
        if not clear_old_points and frame_idx in store:
            old_c, old_l = store[frame_idx]
            points = np.concatenate([old_c, points], 0)
            labels = np.concatenate([old_l, labels], 0)
        store[frame_idx] = (points, labels)
        state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        state["cond_frame_idx"].add(frame_idx)
        return self._preview(state, frame_idx)

    def add_new_bbox(self, state, frame_idx: int, obj_id, bbox,
                     clear_old_points: bool = True, normalize_coords: bool = True):
        """Box prompt as two corner points labelled 2/3."""
        bbox = np.asarray(bbox, np.float32).reshape(2, 2)
        return self.add_new_points(state, frame_idx, obj_id, bbox, np.array([2, 3], np.int32),
                                   clear_old_points=clear_old_points,
                                   normalize_coords=normalize_coords)

    def add_new_mask(self, state, frame_idx: int, obj_id, mask):
        """Binary mask prompt [H, W] at video or model resolution, resized
        bilinearly to the model and re-binarised at 0.5
        (``video_predictor.add_new_mask``); the object takes the
        mask-as-output path on this frame."""
        self._check_cond_frame(state, frame_idx)
        obj_idx = self._obj_idx(state, obj_id)
        S = self.cfg.image_size
        m = torch.as_tensor(np.asarray(mask, np.float32))
        if tuple(m.shape) != (S, S):
            m = (layers.interpolate(m[None, :, :, None], (S, S), method="bilinear")[0, :, :, 0]
                 > 0.5).float()
        state["mask_inputs_per_obj"][obj_idx][frame_idx] = m.numpy()
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        state["cond_frame_idx"].add(frame_idx)
        return self._preview(state, frame_idx)

    @torch.no_grad()
    def _preview(self, state, frame_idx: int):
        """Memoryless prompt step for this frame only."""
        spec = self._session_spec(state)
        bank = mb.init_bank(spec, len(state["obj_ids"]), self.device)
        out, _ = self._run_prompt_frame(state, bank, frame_idx, spec)
        return frame_idx, list(state["obj_ids"]), out["pred_masks"]

    def _run_prompt_frame(self, state, bank, frame_idx: int, spec: mb.BankSpec):
        """Assemble per-object prompts (padded to the frame's max point count
        with label -1) and run the prompt step. An object with a mask prompt,
        or without a prompt on this conditioning frame (an empty mask), takes
        the mask-as-output path."""
        B = len(state["obj_ids"])
        S = self.cfg.image_size
        P = max(1, min(self.cfg.max_prompt_points, max(
            (len(state["point_inputs_per_obj"][o].get(frame_idx, ((), ()))[1])
             for o in range(B)), default=1)))
        coords = np.zeros((B, P, 2), np.float32)
        labels = -np.ones((B, P), np.int32)
        use_mask = np.zeros((B,), bool)
        mask_inputs = np.zeros((B, S, S, 1), np.float32)
        max_pts = 0
        for o in range(B):
            pts = state["point_inputs_per_obj"][o].get(frame_idx)
            if pts is None:
                use_mask[o] = True
                msk = state["mask_inputs_per_obj"][o].get(frame_idx)
                if msk is not None:
                    mask_inputs[o, :, :, 0] = msk
                continue
            c, l = pts
            n = min(len(l), P)
            coords[o, :n] = c[:n]
            labels[o, :n] = l[:n]
            max_pts = max(max_pts, n)
        dev = self.device
        return _prompt_step(
            self.model, state["images"], bank, frame_idx,
            torch.from_numpy(coords).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(mask_inputs).to(dev), use_mask, spec=spec,
            multimask_output=use_multimask(self.cfg, True, max_pts),
            is_eval=state["is_eval"], num_frames=state["num_frames"])

    # ------------------------------------------------------------------
    # Propagation
    # ------------------------------------------------------------------

    def propagate_in_video(self, state, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           reverse: bool = False):
        """Generator of (frame_idx, obj_ids, video-resolution mask logits
        [B, 1, H, W])."""
        frames, masks = self.propagate_in_video_batch(state, start_frame_idx,
                                                      max_frame_num_to_track, reverse)
        hw = (state["video_height"], state["video_width"])
        for i, f in enumerate(frames):
            video_res = layers.interpolate(masks[i].permute(0, 2, 3, 1), hw,
                                           method="bilinear").permute(0, 3, 1, 2)
            if self.non_overlap_masks:
                video_res = apply_non_overlapping_constraints(video_res)
            yield f, list(state["obj_ids"]), video_res

    @torch.no_grad()
    def propagate_in_video_batch(self, state, start_frame_idx: Optional[int] = None,
                                 max_frame_num_to_track: Optional[int] = None,
                                 reverse: bool = False):
        """Preflight over the prompt frames, then track forward. Returns
        (frame list, low-res mask logits [num_frames_out, B, 1, h4, w4])."""
        if reverse:
            raise NotImplementedError("reverse propagation is not ported")
        if not state["cond_frame_idx"]:
            raise RuntimeError("No prompts added; call add_new_points first.")
        cond_frames = sorted(state["cond_frame_idx"])
        num_frames = state["num_frames"]
        if start_frame_idx is None:
            start_frame_idx = cond_frames[0]
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        prior = [j for j in range(start_frame_idx)
                 if j in state["frames_tracked"] and j not in state["cond_frame_idx"]]
        if prior:
            raise NotImplementedError("resuming past tracked frames is not ported")
        state["tracked"] = True
        B = len(state["obj_ids"])
        model = self.model
        spec = self._session_spec(state)
        bank = mb.init_bank(spec, B, self.device, kcache_shape=kcache_shape(self.cfg),
                            kcache_dtype=compute_dtype(self.cfg))
        pos_kcache = model.make_pos_kcache(spec)

        cond_out = {}
        for f in cond_frames:
            out, bank = self._run_prompt_frame(state, bank, f, spec)
            cond_out[f] = out["pred_masks"].float()

        end = min(start_frame_idx + max_frame_num_to_track, num_frames - 1)
        order = list(range(start_frame_idx, end + 1))
        images = state["images"]
        trunk_pe = model.image_encoder.trunk.get_pos_embed(
            images.shape[1] // 4, images.shape[2] // 4)
        kw = dict(spec=spec, pos_kcache=pos_kcache, trunk_pe=trunk_pe,
                  num_frames=num_frames, is_eval=state["is_eval"])
        seg: List[torch.Tensor] = []
        run: List[int] = []
        for f in order:
            if f in cond_out:
                if run:
                    seg.append(_track_run(model, images, bank, run, **kw))
                    run = []
                seg.append(cond_out[f][None])
            else:
                run.append(f)
        if run:
            seg.append(_track_run(model, images, bank, run, **kw))
        state["frames_tracked"].update(order)
        return order, torch.cat(seg, dim=0)


def propagate_volumes_batched(*args, **kwargs):
    """Batched multi-volume streaming: not ported yet."""
    raise NotImplementedError("propagate_volumes_batched is not ported")


def _encode_frame(model: SAM2Model, frame, trunk_pos_embed=None):
    """frame [1, S, S, 3] -> (feats, pos) lists, highest-res first (a frozen
    trunk runs without autograd, :meth:`SAM2Model.forward_image`)."""
    out = model.forward_image(frame.to(compute_dtype(model.cfg)),
                              trunk_pos_embed=trunk_pos_embed)
    return model.prepare_backbone_features(out)


def _expand(xs, B: int):
    return [x.expand(B, *x.shape[1:]) for x in xs]


def _prompt_step(model: SAM2Model, images, bank, frame_idx: int, coords, labels,
                 mask_inputs, use_mask: np.ndarray, *, spec: mb.BankSpec,
                 multimask_output: bool, is_eval: bool, num_frames: int):
    """Conditioning-frame step (``video_predictor._prompt_step``): encode,
    run the point path and/or the mask-as-output path per object, encode and
    write the cond memory. A path no object takes is skipped (its outputs
    would be selected away, and so would its gradients). Differentiable when
    grad is enabled (the 3D recipe's prompt frames); the bank is then a new
    dict. Returns (outputs with ``pred_masks``, ``pred_masks_high_res``,
    ``obj_ptr``, ``object_score_logits``, ``maskmem_features``; bank)."""
    cfg = model.cfg
    B = coords.shape[0]
    feats, pos = _encode_frame(model, images[frame_idx:frame_idx + 1])
    feats, pos = _expand(feats, B), _expand(pos, B)
    high_res = feats[:-1] if len(feats) > 1 else None
    pix = feats[-1]
    results = []
    if not use_mask.all():
        Bp, h, w, C = pix.shape
        pix_mem = (pix.reshape(Bp, h * w, C) + model.no_mem_embed.to(pix.dtype)).reshape(
            Bp, h, w, C)
        results.append(model.forward_sam_heads(
            pix_mem, point_inputs={"point_coords": coords, "point_labels": labels},
            high_res_features=high_res, multimask_output=multimask_output,
            eval_dynamic_multimask=is_eval))
    if use_mask.any():
        results.append(model.use_mask_as_output(pix, high_res, mask_inputs))
    if len(results) == 1:
        sam = results[0]
        low_res, high_res_masks, obj_ptr = sam.low_res_masks, sam.high_res_masks, sam.obj_ptr
        obj_score = sam.object_score_logits
    else:
        point_out, mask_out = results
        sel = torch.from_numpy(use_mask).to(pix.device)

        def pick(a, b):
            return torch.where(sel.reshape((B,) + (1,) * (a.ndim - 1)), b, a)

        low_res = pick(point_out.low_res_masks, mask_out.low_res_masks)
        high_res_masks = pick(point_out.high_res_masks, mask_out.high_res_masks)
        obj_ptr = pick(point_out.obj_ptr, mask_out.obj_ptr)
        obj_score = pick(point_out.object_score_logits, mask_out.object_score_logits)
    maskmem, _ = model.encode_new_memory(
        feats[-1], high_res_masks,
        is_mask_from_pts=torch.from_numpy(~use_mask).to(pix.device), binarize=is_eval,
        apply_non_overlap=(cfg.non_overlap_masks_for_mem_enc and is_eval))
    kcache = (model.memory_kcache(maskmem, bank["kcache"].dtype)
              if "kcache" in bank else None)
    bank = mb.write_bank(spec, bank, frame_idx, maskmem, obj_ptr, is_cond=True,
                         kcache=kcache)
    return {"pred_masks": low_res, "pred_masks_high_res": high_res_masks, "obj_ptr": obj_ptr,
            "object_score_logits": obj_score, "maskmem_features": maskmem}, bank


def _track_run(model: SAM2Model, images, bank, frames: List[int], *, spec: mb.BankSpec,
               pos_kcache, trunk_pe, num_frames: int, is_eval: bool):
    """Track a run of consecutive non-conditioning frames (the JAX package's
    ``_scan_track_run``), updating ``bank`` in place. Returns low-res mask
    logits [len(frames), B, 1, h4, w4] fp32."""
    B = bank["cond_feats"].shape[0]
    multimask = use_multimask(model.cfg, False, 0)
    masks = []
    for f in frames:
        feats, pos = _encode_frame(model, images[f:f + 1], trunk_pos_embed=trunk_pe)
        out, bank = model.track_step(
            spec, bank, f, is_init_cond_frame=False,
            current_vision_feats=_expand(feats, B), current_vision_pos=_expand(pos, B),
            multimask_output=multimask, run_mem_encoder=True, is_cond_frame=False,
            num_frames=num_frames, is_eval=is_eval, pos_kcache=pos_kcache)
        masks.append(out["pred_masks"].float())
    return torch.stack(masks, dim=0)
