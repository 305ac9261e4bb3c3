"""SAM2VideoPredictor: volume / video propagation through the memory bank
(counterpart of ``medsam2_tpu/api/video_predictor.py``).

The session is a host-side dict holding the normalised video (on the card,
or on the host with ``offload_video_to_cpu``) and the recorded prompts.
Objects are batched on axis 0. Prompt (conditioning) frames are processed
first and write cond memories; the other frames of the propagation's order
(forward from the start frame, or backward with ``reverse=True``) are then
tracked by a per-frame Python loop (the JAX package's ``lax.scan``), with
the trunk position embedding and the positional half of the roped-key cache
computed once per propagation. Several conditioning frames split the order
into runs, and the stored prompt-frame outputs are spliced between them.

Every propagation keeps each frame's outputs (mask logits and object
pointer). A later propagation whose order starts next to tracked frames (a
resume with ``start_frame_idx``, or the reverse half of a bidirectional
session) first re-encodes their memories into the ring
(:meth:`SAM2VideoPredictor._reconstruct_ring`), as the reference's
persistent output dict still holds them.

A prompt on a frame that was already tracked is a correction
(``sam2_video_predictor.py:292-399``), kept out of the conditioning frames
unless ``add_all_frames_to_correct_as_cond``. The next propagation decodes it
memory-conditioned against the bank as it stood when the frame was tracked
(rebuilt from the retained outputs, so two corrections of one round do not
see each other), in the direction it was tracked; the decode is spliced into
the frame order and its memory re-encoded there. A later propagation reuses
the stored decode until the frame is clicked again. With
``clear_non_cond_mem_around_input`` the non-cond memories and retained
outputs within ``num_maskmem * r`` frames of a newly prompted frame are
dropped, as the reference does (``:1424-1440``).

The memory readout is chosen as the JAX package chooses it: storage order
over the bank's roped-key cache (the default), read order over the same
cache (``MEDSAM2_KV_STORAGE=0``), or read order over raw memory tokens
(``use_kcache=False``); a correction decode reads as the tracked frames do.
:func:`propagate_volumes_batched` streams several volumes, folded onto the
batch axis of one bank (``MEDSAM2_FOLD``) or one after another.

Not ported yet, and raising ``NotImplementedError`` with a pointer to
``ROADMAP.md``: ``propagate_volumes_batched(mesh=...)``.

:func:`_prompt_step` is also the 3D training recipe's prompt-frame step: with
grad enabled it is differentiable and returns ``pred_masks_high_res``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.sam2_model import (SAM2Model, apply_non_overlapping_constraints,
                                               compute_dtype, kcache_shape, use_multimask)
from medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from medsam2_tpu_torch.state import memory_bank as mb
from medsam2_tpu_torch.utils.transforms import IMAGENET_MEAN, IMAGENET_STD, preprocess_video


def _kv_storage_enabled() -> bool:
    """The storage-order readout's switch, read as the JAX package reads it
    (``video_predictor._kv_storage_enabled``): on unless
    ``MEDSAM2_KV_STORAGE=0``, which selects the read order over the cache."""
    return os.environ.get("MEDSAM2_KV_STORAGE", "1") == "1"


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Model, max_cond_frames: int = 8,
                 fill_hole_area: int = 0, non_overlap_masks: bool = False,
                 use_kcache: bool = True, clear_non_cond_mem_around_input: bool = False,
                 clear_non_cond_mem_for_multi_obj: bool = False):
        # clearing acts on single-object sessions only, unless the
        # multi-object flag is set (sam2_video_predictor.py:935-937)
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.clear_non_cond_mem_for_multi_obj = clear_non_cond_mem_for_multi_obj
        self.model = model
        self.cfg = model.cfg
        self.max_cond_frames = max_cond_frames
        self.fill_hole_area = fill_hole_area
        self.non_overlap_masks = non_overlap_masks
        # the roped-key cache: memory keys projected and rotated once at
        # bank-write time
        self.use_kcache = use_kcache and kcache_shape(model.cfg)[0] > 0

    @classmethod
    def for_eval(cls, model: SAM2Model, **kwargs):
        """Predictor with the reference's eval-time overrides
        (``build_sam.py:51-66``): interacted-frame masks binarised for the
        memory encoder, holes up to area 8 filled, the cross-object
        non-overlap constraint on the outputs. The model's weights are
        shared; only its config differs."""
        eval_model = copy.copy(model)
        eval_model.cfg = dataclasses.replace(model.cfg, binarize_mask_from_pts_for_mem_enc=True)
        kwargs.setdefault("fill_hole_area", 8)
        kwargs.setdefault("non_overlap_masks", True)
        return cls(eval_model, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _session_spec(self, state) -> mb.BankSpec:
        """Bank sized to the session's prompt count (capped at
        ``max_cond_frames``)."""
        n = max(1, min(len(state["cond_frame_idx"]), self.max_cond_frames))
        return mb.BankSpec.from_config(self.cfg, max_cond_frames=n)

    def _make_bank(self, spec: mb.BankSpec, B: int):
        if self.use_kcache:
            return mb.init_bank(spec, B, self.device, kcache_shape=kcache_shape(self.cfg),
                                kcache_dtype=compute_dtype(self.cfg))
        return mb.init_bank(spec, B, self.device)

    # ------------------------------------------------------------------
    # Session
    # ------------------------------------------------------------------

    def init_state(self, video_path: Optional[str] = None,
                   images: Optional[np.ndarray] = None,
                   offload_video_to_cpu: bool = False,
                   offload_state_to_cpu: bool = False,
                   async_loading_frames: bool = False) -> Dict:
        """Start a session from an image array [T, H, W, 3] (RGB, uint8 or
        float), resized to the model resolution and normalised, or from a
        directory of ``<index>.jpg`` frames (``utils/misc.py:163-213``).

        ``async_loading_frames``: decode the JPEG frames in a background
        thread, so the session starts at once; the video is joined at first
        use. ``offload_video_to_cpu``: keep the video in host memory and move
        each frame to the card when it is encoded. ``offload_state_to_cpu``:
        keep the retained per-frame outputs in host memory."""
        S = self.cfg.image_size
        loader = None
        if images is None:
            if video_path is None:
                raise ValueError("init_state needs images=... or video_path=...")
            if async_loading_frames:
                loader = _AsyncFrameLoader(video_path, S)
                imgs = None
                num_frames = len(loader)
                video_height, video_width = loader.video_height, loader.video_width
            else:
                arr, video_height, video_width = _load_video_frames_dir(video_path, S)
                num_frames = arr.shape[0]
                imgs = arr if offload_video_to_cpu else torch.from_numpy(arr).to(self.device)
        else:
            images = np.asarray(images)
            video_height, video_width = images.shape[1], images.shape[2]
            num_frames = images.shape[0]
            imgs = preprocess_video(images, S, self.device)
            if offload_video_to_cpu:
                imgs = imgs.cpu().numpy()
        return {
            "images": imgs,                  # [T, S, S, 3] normalised, or None while loading
            "async_loader": loader,
            "offload_video": bool(offload_video_to_cpu),
            "offload_state": bool(offload_state_to_cpu),
            "num_frames": int(num_frames),
            "video_height": int(video_height),
            "video_width": int(video_width),
            "obj_id_to_idx": {},
            "obj_ids": [],
            "point_inputs_per_obj": {},      # {obj_idx: {frame: (coords, labels)}}
            "mask_inputs_per_obj": {},       # {obj_idx: {frame: [S, S] 0/1 mask}}
            "cond_frame_idx": set(),
            # corrections: prompts on tracked frames that stay non-cond
            "noncond_prompt_frame_idx": set(),
            "frames_tracked": {},            # {frame: tracked in reverse}
            # each tracked frame's outputs as (stack, row): low-res mask
            # logits [T, B, 1, h4, w4] and object pointers [T, B, C]
            "last_masks": {},
            "last_ptrs": {},
            # corrections whose decode a propagation has consumed: later
            # rounds reuse it until the frame is clicked again
            "corr_consolidated": set(),
            # frames prompted since the last propagation
            "new_prompt_frames": set(),
            "tracked": False,
            "is_eval": True,
        }

    def _session_images(self, state):
        """The session video [T, S, S, 3]: the device tensor, or a host
        tensor over the offloaded array (its frames move to the card as they
        are encoded). Joins the async loader first."""
        if state.get("async_loader") is not None:
            arr = state["async_loader"].wait()
            state["images"] = arr if state["offload_video"] else torch.from_numpy(arr).to(
                self.device)
            state["async_loader"] = None
        imgs = state["images"]
        return torch.from_numpy(imgs) if isinstance(imgs, np.ndarray) else imgs

    def val_init_state(self, imgs_tensor) -> Dict:
        """Session from a [T, 3, S, S] or [T, S, S, 3] array
        (``val_init_state``, ``sam2_video_predictor.py:107``)."""
        arr = np.asarray(imgs_tensor, np.float32)
        if arr.ndim == 4 and arr.shape[1] == 3:
            arr = arr.transpose(0, 2, 3, 1)
        return self.init_state(images=arr)

    def train_init_state(self, imgs_tensor) -> Dict:
        """:meth:`val_init_state` with ``is_eval`` off: the session runs
        without the decoder's dynamic-multimask fallback, the binarised
        memory masks and the non-overlap constraint, as the reference's
        ``train_init_state`` (``sam2_video_predictor.py``)."""
        state = self.val_init_state(imgs_tensor)
        state["is_eval"] = False
        return state

    def reset_state(self, state: Dict) -> None:
        """Forget every object, prompt and tracked output; keep the
        session's frames."""
        state.update(obj_id_to_idx={}, obj_ids=[], point_inputs_per_obj={},
                     mask_inputs_per_obj={}, cond_frame_idx=set(),
                     noncond_prompt_frame_idx=set(), frames_tracked={}, last_masks={},
                     last_ptrs={}, corr_consolidated=set(), new_prompt_frames=set(),
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

    def _record_prompt_frame(self, state, frame_idx: int) -> None:
        """Classify a prompted frame (``video_predictor._record_prompt_frame``):
        a frame not yet tracked is a conditioning frame; a tracked one is a
        correction, non-cond unless ``add_all_frames_to_correct_as_cond``
        (``sam2_video_predictor.py:292-341``). A new click re-opens a
        consolidated correction."""
        state["corr_consolidated"].discard(frame_idx)
        state["new_prompt_frames"].add(frame_idx)
        if (frame_idx in state["frames_tracked"]
                and not self.cfg.add_all_frames_to_correct_as_cond
                and frame_idx not in state["cond_frame_idx"]):
            state["noncond_prompt_frame_idx"].add(frame_idx)
        else:
            state["noncond_prompt_frame_idx"].discard(frame_idx)
            state["cond_frame_idx"].add(frame_idx)

    def add_new_points(self, state, frame_idx: int, obj_id, points, labels,
                       clear_old_points: bool = True, normalize_coords: bool = True):
        """Record click prompts (video-resolution pixels unless
        ``normalize_coords=False``); returns (frame_idx, obj_ids, low-res mask
        logits preview [B, 1, h4, w4])."""
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
        self._record_prompt_frame(state, frame_idx)
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
        obj_idx = self._obj_idx(state, obj_id)
        S = self.cfg.image_size
        m = torch.as_tensor(np.asarray(mask, np.float32))
        if tuple(m.shape) != (S, S):
            m = (layers.interpolate(m[None, :, :, None], (S, S), method="bilinear")[0, :, :, 0]
                 > 0.5).float()
        state["mask_inputs_per_obj"][obj_idx][frame_idx] = m.numpy()
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        self._record_prompt_frame(state, frame_idx)
        return self._preview(state, frame_idx)

    @torch.no_grad()
    def _preview(self, state, frame_idx: int):
        """Memoryless prompt step for this frame only."""
        spec = self._session_spec(state)
        bank = mb.init_bank(spec, len(state["obj_ids"]), self.device)
        out, _ = self._run_prompt_frame(state, bank, frame_idx, spec)
        return frame_idx, list(state["obj_ids"]), out["pred_masks"]

    def _frame_prompts(self, state, frame_idx: int):
        """Per-object prompts of a frame, as numpy: point coords [B, P, 2]
        and labels [B, P] padded to the frame's max point count with label
        -1, mask prompts [B, S, S, 1], which objects have points and which a
        mask (and no points), and the max point count."""
        B = len(state["obj_ids"])
        S = self.cfg.image_size
        P = max(1, min(self.cfg.max_prompt_points, max(
            (len(state["point_inputs_per_obj"][o].get(frame_idx, ((), ()))[1])
             for o in range(B)), default=1)))
        coords = np.zeros((B, P, 2), np.float32)
        labels = -np.ones((B, P), np.int32)
        mask_inputs = np.zeros((B, S, S, 1), np.float32)
        has_pts = np.zeros((B,), bool)
        has_mask = np.zeros((B,), bool)
        max_pts = 0
        for o in range(B):
            pts = state["point_inputs_per_obj"][o].get(frame_idx)
            msk = state["mask_inputs_per_obj"][o].get(frame_idx)
            if pts is not None:
                c, l = pts
                n = min(len(l), P)
                coords[o, :n] = c[:n]
                labels[o, :n] = l[:n]
                has_pts[o] = True
                max_pts = max(max_pts, n)
            elif msk is not None:
                mask_inputs[o, :, :, 0] = msk
                has_mask[o] = True
        return coords, labels, mask_inputs, has_pts, has_mask, max_pts

    def _run_prompt_frame(self, state, bank, frame_idx: int, spec: mb.BankSpec,
                          write_cond: bool = True):
        """Run the prompt step on a frame's prompts. An object with a mask
        prompt, or without a prompt on this conditioning frame (an empty
        mask), takes the mask-as-output path. ``write_cond=False`` writes the
        memory to the non-cond ring (a correction frame without retained
        outputs)."""
        coords, labels, mask_inputs, has_pts, _, max_pts = self._frame_prompts(state, frame_idx)
        dev = self.device
        return _prompt_step(
            self.model, self._session_images(state), bank, frame_idx,
            torch.from_numpy(coords).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(mask_inputs).to(dev), ~has_pts, spec=spec,
            multimask_output=use_multimask(self.cfg, True, max_pts),
            is_eval=state["is_eval"], num_frames=state["num_frames"], write_cond=write_cond)

    def _assemble_correction(self, state, frame_idx: int):
        """Inputs of a correction decode (``video_predictor._assemble_correction``):
        the frame's prompts, per-object ``corrected`` (points) and
        ``use_mask`` (a mask prompt) flags, its retained outputs and the
        multimask choice. Objects without a prompt on the frame keep their
        previous output."""
        coords, labels, mask_inputs, has_pts, has_mask, max_pts = self._frame_prompts(
            state, frame_idx)
        dev = self.device
        prev_low, prev_ptr = self._last_output(state, frame_idx)
        return dict(coords=torch.from_numpy(coords).to(dev),
                    labels=torch.from_numpy(labels).to(dev),
                    mask_inputs=torch.from_numpy(mask_inputs).to(dev), use_mask=has_mask,
                    corrected=has_pts, prev_low=prev_low, prev_ptr=prev_ptr,
                    multimask_output=use_multimask(self.cfg, False, max_pts))

    # ------------------------------------------------------------------
    # Propagation
    # ------------------------------------------------------------------

    def propagate_in_video(self, state, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           reverse: bool = False):
        """Generator of (frame_idx, obj_ids, video-resolution mask logits
        [B, 1, H, W]), after hole filling (``fill_hole_area``) and the
        non-overlap constraint (``non_overlap_masks``) when configured."""
        frames, masks = self.propagate_in_video_batch(state, start_frame_idx,
                                                      max_frame_num_to_track, reverse)
        hw = (state["video_height"], state["video_width"])
        for i, f in enumerate(frames):
            frame_masks = masks[i]
            if self.fill_hole_area > 0:
                frame_masks = fill_holes_in_mask_scores(frame_masks, self.fill_hole_area)
            video_res = layers.interpolate(frame_masks.permute(0, 2, 3, 1), hw,
                                           method="bilinear").permute(0, 3, 1, 2)
            if self.non_overlap_masks:
                video_res = apply_non_overlapping_constraints(video_res)
            yield f, list(state["obj_ids"]), video_res

    @torch.no_grad()
    def propagate_in_video_batch(self, state, start_frame_idx: Optional[int] = None,
                                 max_frame_num_to_track: Optional[int] = None,
                                 reverse: bool = False):
        """Preflight over the prompt frames, then track the frame order.
        Returns (frame list, low-res mask logits [num_frames_out, B, 1, h4,
        w4]). The order spans ``max_frame_num_to_track + 1`` frames from
        ``start_frame_idx`` (default: the first prompt frame), forward or, with
        ``reverse``, backward; reverse from frame 0 is empty
        (``sam2_video_predictor.py:1063-1079``).

        The preflight writes the cond memories and decodes each fresh
        correction against the bank of its own tracking (cond memories plus
        the ring rebuilt from the retained outputs, a copy); consolidated
        corrections reuse their stored decode, and a correction frame with no
        retained output takes the memoryless prompt decode. At a correction
        frame of the order the run is flushed, the decode spliced in and its
        memory re-encoded as mask-from-points; at a cond frame, with clearing
        active, the surrounding non-cond memories are dropped."""
        if not state["cond_frame_idx"]:
            raise RuntimeError("No prompts added; call add_new_points first.")
        state["tracked"] = True
        num_frames = state["num_frames"]
        B = len(state["obj_ids"])
        model = self.model
        spec = self._session_spec(state)
        bank = self._make_bank(spec, B)
        pos_kcache = model.make_pos_kcache(spec) if self.use_kcache else None
        cond_frames = sorted(state["cond_frame_idx"])
        if start_frame_idx is None:
            start_frame_idx = cond_frames[0]
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        images = self._session_images(state)
        kv_on = self.use_kcache and _kv_storage_enabled()
        is_eval = state["is_eval"]

        stored = {}
        for f in cond_frames:
            out, bank = self._run_prompt_frame(state, bank, f, spec)
            stored[f] = (out["pred_masks"].float(), out["obj_ptr"].float())
        fresh_corr, corr_reuse, corr_mem = set(), {}, {}
        for f in sorted(state["noncond_prompt_frame_idx"]):
            if f not in state["last_masks"]:
                out, bank = self._run_prompt_frame(state, bank, f, spec, write_cond=False)
                stored[f] = (out["pred_masks"].float(), out["obj_ptr"].float())
                corr_mem[f] = (out["maskmem_features"], out["obj_ptr"])
            elif f in state["corr_consolidated"]:
                corr_reuse[f] = self._last_output(state, f)
            else:
                fresh_corr.add(f)
                # decoded in the direction the frame was tracked, against a
                # copy: the preflight's bank does not change
                rev_f = state["frames_tracked"][f]
                bank_f = {k: v.clone() for k, v in bank.items()}
                bank_f, _ = self._reconstruct_ring(state, images, bank_f, f, rev_f, spec)
                out, _ = _correction_step(
                    model, images, bank_f, f, **self._assemble_correction(state, f), spec=spec,
                    is_eval=is_eval, num_frames=num_frames, track_in_reverse=rev_f,
                    pos_kcache=pos_kcache, kv_storage=kv_on)
                corr_reuse[f] = (out["pred_masks"].float(), out["obj_ptr"].float())

        # clear_non_cond_mem_around_input, preflight half: after the
        # correction decodes (click time in the reference), pop the retained
        # outputs around each newly prompted frame, non-cond frames first
        clear_active = (self.clear_non_cond_mem_around_input
                        and (self.clear_non_cond_mem_for_multi_obj or B <= 1))
        clear_w = self.cfg.memory_temporal_stride_for_eval * self.cfg.num_maskmem
        if clear_active:
            new = state["new_prompt_frames"]
            for c in (sorted(new & state["noncond_prompt_frame_idx"])
                      + sorted(new & state["cond_frame_idx"])):
                self._pop_retention_window(state, c, clear_w)
        state["new_prompt_frames"] = set()

        if reverse:
            end = max(start_frame_idx - max_frame_num_to_track, 0)
            order = list(range(start_frame_idx, end - 1, -1)) if start_frame_idx > 0 else []
        else:
            end = min(start_frame_idx + max_frame_num_to_track, num_frames - 1)
            order = list(range(start_frame_idx, end + 1))
        if not order:
            return [], torch.zeros((0, B, 1, 1, 1), device=self.device)

        bank, window = self._reconstruct_ring(state, images, bank, order[0], reverse, spec)

        def at_stored(f: int, bank):
            """Bank work at a spliced frame, after the run before it."""
            if f in corr_reuse:
                return _reencode_memory(model, images, bank, f, *corr_reuse[f], spec=spec,
                                        is_eval=is_eval, mask_from_pts=True)
            if clear_active and f in state["cond_frame_idx"]:
                bank = mb.clear_noncond_window(bank, f, clear_w)
            if f in corr_mem:
                # the fallback decode's memory, restored: a frame sharing its
                # ring slot may have overwritten it since the preflight
                feats_f, ptr_f = corr_mem[f]
                kcache = (model.memory_kcache(feats_f, bank["kcache"].dtype)
                          if "kcache" in bank else None)
                bank = mb.write_bank(spec, bank, f, feats_f, ptr_f, is_cond=False,
                                     kcache=kcache)
            return bank

        trunk_pe = _trunk_pos_embed(model, images)
        masks, ptrs = _run_segments(
            model, images, bank, order, {**stored, **corr_reuse}, at_stored=at_stored,
            spec=spec, pos_kcache=pos_kcache, trunk_pe=trunk_pe, num_frames=num_frames,
            is_eval=is_eval, track_in_reverse=reverse, kv_storage=kv_on)
        keep_m, keep_p = masks, ptrs
        if state["offload_state"]:
            keep_m, keep_p = masks.cpu().numpy(), ptrs.cpu().numpy()
        pre_keys = set(state["last_masks"])
        for i, f in enumerate(order):
            state["frames_tracked"][f] = reverse
            state["last_masks"][f] = (keep_m, i)
            state["last_ptrs"][f] = (keep_p, i)
        if clear_active:
            # replay the run's writes and clears over the retained outputs: a
            # non-cond frame cleared at a cond frame and not tracked again
            # since offers no output to later corrections or resumes
            cond_set = state["cond_frame_idx"]
            held = {f for f in pre_keys if f not in cond_set}
            for f in order:
                if f in cond_set:
                    held.difference_update(range(f - clear_w, f + clear_w + 1))
                else:
                    held.add(f)
            for p in [f for f in state["last_masks"] if f not in cond_set and f not in held]:
                state["last_masks"].pop(p)
                state["last_ptrs"].pop(p)
        state["corr_consolidated"].update(fresh_corr & set(order))
        missed = ((fresh_corr - set(order))
                  | (set(corr_reuse) - fresh_corr - set(order) - set(window)))
        if missed:
            warnings.warn(
                f"corrections on frames {sorted(missed)} are outside this propagation's frame "
                "order (and its resume window) and had no effect; re-propagate with an order "
                "covering them.", stacklevel=2)
        return order, masks

    def _reconstruct_ring(self, state, images, bank, anchor: int, reverse: bool,
                          spec: mb.BankSpec):
        """Re-encode, from their retained outputs, the tracked non-cond
        frames that precede ``anchor`` in the tracking direction, as far back
        as the feature ring and the (possibly longer) pointer ring reach
        (``video_predictor._reconstruct_ring``). They are written oldest in
        scan time first, so frames that share a ring slot leave it as a
        continuous scan would; consolidated corrections re-encode as
        mask-from-points. A tracked frame whose output was popped by
        ``clear_non_cond_mem_around_input`` still owns its ring slots but adds
        no memory. Returns (bank, the re-encoded frames)."""
        window: List[int] = []
        step = -1 if reverse else 1
        owned_f: set = set()
        owned_p: set = set()
        j = anchor - step
        while (0 <= j < state["num_frames"]
               and (len(owned_f) < spec.noncond_ring or len(owned_p) < spec.ptr_ring)):
            if j in state["cond_frame_idx"]:
                j -= step
                continue
            if j not in state["frames_tracked"]:
                break
            owned_f.add(j % spec.noncond_ring)
            owned_p.add(j % spec.ptr_ring)
            if j in state["last_masks"]:
                window.append(j)
            j -= step
        for wf in reversed(window):
            prev_low, prev_ptr = self._last_output(state, wf)
            bank = _reencode_memory(self.model, images, bank, wf, prev_low, prev_ptr,
                                    spec=spec, is_eval=state["is_eval"],
                                    mask_from_pts=wf in state["corr_consolidated"])
        return bank, window

    @staticmethod
    def _pop_retention_window(state, center: int, radius: int) -> None:
        """Drop the retained outputs of the non-cond frames within
        ``[center - radius, center + radius]``: the session half of
        ``_clear_non_cond_mem_around_input``. ``frames_tracked`` keeps them,
        as the reference's ``frames_already_tracked`` does."""
        for p in range(center - radius, center + radius + 1):
            if p not in state["cond_frame_idx"]:
                state["last_masks"].pop(p, None)
                state["last_ptrs"].pop(p, None)

    def _last_output(self, state, frame_idx: int):
        """The frame's retained (mask logits [B, 1, h4, w4], object pointer
        [B, C]) from the latest propagation that covered it, fp32 on the
        card."""
        arr_m, i = state["last_masks"][frame_idx]
        arr_p, j = state["last_ptrs"][frame_idx]
        return (torch.as_tensor(arr_m[i]).to(self.device, torch.float32),
                torch.as_tensor(arr_p[j]).to(self.device, torch.float32))


@torch.no_grad()
def propagate_volumes_batched(model: SAM2Model, spec: mb.BankSpec, videos, prompt_coords,
                              prompt_labels, num_objects: int = 1,
                              prompt_frames: Sequence[int] = (0,),
                              fold: Optional[bool] = None, mesh=None) -> torch.Tensor:
    """Stream several volumes at once (``video_predictor.propagate_volumes_batched``).

    videos [V, T, S, S, 3] normalised; prompt_coords / prompt_labels
    [V, F, O, P, 2] / [V, F, O, P], one prompt set per entry of
    ``prompt_frames`` (a box is its two corners labelled 2 / 3); the rank-4
    / rank-3 form is one prompt frame. Returns low-res logits [V, T, O, 1,
    h4, h4].

    ``fold=True`` puts the volumes on the batch axis of one bank (row =
    volume * O + object): the frame schedule is the same for every volume,
    so one memory-attention call serves them all, read in storage order (or
    in read order over the cache with ``MEDSAM2_KV_STORAGE=0``).
    ``fold=False`` propagates the volumes one after another, each reading
    the cache in read order, as the JAX package's vmapped form does.
    ``fold=None`` reads ``MEDSAM2_FOLD`` (default on)."""
    if mesh is not None:
        raise NotImplementedError("propagate_volumes_batched(mesh=...): parallel/ is not "
                                  "ported yet (ROADMAP.md, queue A)")
    if fold is None:
        fold = os.environ.get("MEDSAM2_FOLD", "1") == "1"
    cfg = model.cfg
    dev = model.device
    videos = torch.as_tensor(videos).to(dev)
    coords = torch.as_tensor(prompt_coords, dtype=torch.float32).to(dev)
    labels = torch.as_tensor(prompt_labels, dtype=torch.int32).to(dev)
    if coords.ndim == 4:          # one prompt frame: [V, O, P, 2]
        coords, labels = coords[:, None], labels[:, None]
    prompt_frames = tuple(prompt_frames)
    if coords.shape[1] != len(prompt_frames):
        raise ValueError(f"prompt_coords has {coords.shape[1]} prompt-frame sets but "
                         f"prompt_frames={prompt_frames!r}")
    if spec.max_cond_frames < len(prompt_frames):
        raise ValueError(f"spec.max_cond_frames={spec.max_cond_frames} cannot hold "
                         f"{len(prompt_frames)} conditioning frames")
    V, T = videos.shape[:2]
    O = num_objects
    S = cfg.image_size
    pos_kcache = model.make_pos_kcache(spec) if kcache_shape(cfg)[0] > 0 else None
    trunk_pe = _trunk_pos_embed(model, videos)

    def stream(images, c, l, rows: int, kv_storage: bool):
        """Prompt frames, then every other frame in order, for one bank of
        ``rows`` rows; c [F, rows, P, 2], l [F, rows, P]."""
        bank = mb.init_bank(spec, rows, dev, kcache_shape=kcache_shape(cfg),
                            kcache_dtype=compute_dtype(cfg))
        stored = {}
        for i, f in enumerate(prompt_frames):
            out, bank = _prompt_step(
                model, images, bank, f, c[i], l[i], torch.zeros(rows, S, S, 1, device=dev),
                np.zeros((rows,), bool), spec=spec, multimask_output=False, is_eval=True,
                num_frames=T)
            stored[f] = (out["pred_masks"].float(), out["obj_ptr"].float())
        masks, _ = _run_segments(model, images, bank, list(range(T)), stored, spec=spec,
                                 pos_kcache=pos_kcache, trunk_pe=trunk_pe, num_frames=T,
                                 is_eval=True, track_in_reverse=False,
                                 kv_storage=kv_storage)
        return masks                                          # [T, rows, 1, h4, h4]

    if fold:
        B = V * O
        masks = stream(videos, coords.transpose(0, 1).reshape(len(prompt_frames), B, -1, 2),
                       labels.transpose(0, 1).reshape(len(prompt_frames), B, -1), B,
                       kv_storage=pos_kcache is not None and _kv_storage_enabled())
        h4 = masks.shape[-1]
        return masks.reshape(T, V, O, 1, h4, h4).transpose(0, 1)
    return torch.stack([stream(videos[v], coords[v], labels[v], O, kv_storage=False)
                        for v in range(V)])


def _select_frame(images, frame_idx: int):
    """The frame(s) of one step on the model's device: [T, S, S, 3] ->
    [1, S, S, 3]; volumes folded on the batch axis, [V, T, S, S, 3] ->
    [V, S, S, 3] (each volume's frame at the shared index)."""
    if images.ndim == 5:
        return images[:, frame_idx]
    return images[frame_idx:frame_idx + 1]


def _trunk_pos_embed(model: SAM2Model, images):
    S = images.shape[-2]
    return model.image_encoder.trunk.get_pos_embed(S // 4, S // 4)


def _encode_frame(model: SAM2Model, frame, trunk_pos_embed=None):
    """frame [n, S, S, 3] -> (feats, pos) lists, highest-res first (a frozen
    trunk runs without autograd, :meth:`SAM2Model.forward_image`). A frame
    held on the host moves to the card here."""
    out = model.forward_image(frame.to(model.device, compute_dtype(model.cfg)),
                              trunk_pos_embed=trunk_pos_embed)
    return model.prepare_backbone_features(out)


def _expand(xs, B: int):
    """Tile encoded features to B rows: one frame is broadcast; n folded
    frames repeat B // n times each (row = volume * objects + object)."""
    out = []
    for x in xs:
        n = x.shape[0]
        if n == B:
            out.append(x)
        elif n == 1:
            out.append(x.expand(B, *x.shape[1:]))
        else:
            out.append(x.repeat_interleave(B // n, dim=0))
    return out


def _prompt_step(model: SAM2Model, images, bank, frame_idx: int, coords, labels,
                 mask_inputs, use_mask: np.ndarray, *, spec: mb.BankSpec,
                 multimask_output: bool, is_eval: bool, num_frames: int,
                 write_cond: bool = True):
    """Conditioning-frame step (``video_predictor._prompt_step``): encode,
    run the point path and/or the mask-as-output path per object, encode and
    write the memory, to a cond slot or with ``write_cond=False`` to the
    non-cond ring. A path no object takes is skipped (its outputs
    would be selected away, and so would its gradients). Differentiable when
    grad is enabled (the 3D recipe's prompt frames); the bank is then a new
    dict. Returns (outputs with ``pred_masks``, ``pred_masks_high_res``,
    ``obj_ptr``, ``object_score_logits``, ``maskmem_features``; bank)."""
    cfg = model.cfg
    B = coords.shape[0]
    feats, pos = _encode_frame(model, _select_frame(images, frame_idx))
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
    bank = mb.write_bank(spec, bank, frame_idx, maskmem, obj_ptr, is_cond=write_cond,
                         kcache=kcache)
    return {"pred_masks": low_res, "pred_masks_high_res": high_res_masks, "obj_ptr": obj_ptr,
            "object_score_logits": obj_score, "maskmem_features": maskmem}, bank


def _correction_step(model: SAM2Model, images, bank, frame_idx: int, *, coords, labels,
                     mask_inputs, use_mask: np.ndarray, corrected: np.ndarray, prev_low,
                     prev_ptr, spec: mb.BankSpec, multimask_output: bool, is_eval: bool,
                     num_frames: int, track_in_reverse: bool, pos_kcache=None,
                     kv_storage: bool = False):
    """Correction-frame step (``video_predictor._correction_step``, the
    reference's re-prompt, ``sam2_video_predictor.py:293-399``): objects
    corrected by points decode memory-conditioned, with their previous logits
    clamped to +/-32 fed back as a mask prompt; objects with a mask take the
    mask-as-output path; the others keep their previous output. The selection
    is encoded with ``is_mask_from_pts=True`` and written to the non-cond
    ring. A path no object takes is skipped. prev_low [B, 1, h4, w4] and
    prev_ptr [B, C]: the frame's retained outputs. Returns ({pred_masks,
    obj_ptr}, bank)."""
    cfg = model.cfg
    S = cfg.image_size
    B = coords.shape[0]
    feats, pos = _encode_frame(model, _select_frame(images, frame_idx))
    feats, pos = _expand(feats, B), _expand(pos, B)
    high_res = feats[:-1] if len(feats) > 1 else None
    dev = feats[-1].device
    prev_low = prev_low.float()
    low_res = prev_low
    high_res_masks = layers.interpolate(prev_low.permute(0, 2, 3, 1), (S, S),
                                        method="bilinear").permute(0, 3, 1, 2)
    obj_ptr = prev_ptr

    def pick(sel: np.ndarray, new, old):
        m = torch.from_numpy(sel).to(dev).reshape((B,) + (1,) * (new.ndim - 1))
        return torch.where(m, new.to(old.dtype), old)       # old: fp32, as JAX promotes

    for sel, path in ((corrected, "points"), (use_mask, "mask")):
        if not sel.any():
            continue
        if path == "points":
            pix = model.prepare_memory_conditioned_features(
                spec, bank, frame_idx, False, feats[-1], pos[-1], num_frames=num_frames,
                is_eval=is_eval, pos_kcache=pos_kcache, track_in_reverse=track_in_reverse,
                kv_storage=kv_storage)
            sam = model.forward_sam_heads(
                pix, point_inputs={"point_coords": coords, "point_labels": labels},
                mask_inputs=prev_low.clamp(-32.0, 32.0).permute(0, 2, 3, 1),
                high_res_features=high_res, multimask_output=multimask_output,
                eval_dynamic_multimask=is_eval)
        else:
            sam = model.use_mask_as_output(feats[-1], high_res, mask_inputs)
        low_res = pick(sel, sam.low_res_masks, low_res)
        high_res_masks = pick(sel, sam.high_res_masks, high_res_masks)
        obj_ptr = pick(sel, sam.obj_ptr, obj_ptr)
    maskmem, _ = model.encode_new_memory(
        feats[-1], high_res_masks, is_mask_from_pts=True, binarize=is_eval,
        apply_non_overlap=(cfg.non_overlap_masks_for_mem_enc and is_eval))
    kcache = (model.memory_kcache(maskmem, bank["kcache"].dtype)
              if "kcache" in bank else None)
    bank = mb.write_bank(spec, bank, frame_idx, maskmem, obj_ptr, is_cond=False,
                         kcache=kcache)
    return {"pred_masks": low_res, "obj_ptr": obj_ptr}, bank


def _reencode_memory(model: SAM2Model, images, bank, frame_idx: int, prev_low, prev_ptr, *,
                     spec: mb.BankSpec, is_eval: bool, mask_from_pts: bool = False):
    """Re-encode a frame's memory from its stored output (mask logits
    [B, 1, h4, w4] and pointer [B, C]) and write it to the non-cond ring
    without decoding again (``video_predictor._reencode_correction``):
    ``mask_from_pts=False`` as a tracked frame's encode did (the ring of a
    resume), True as a correction's consolidation encodes. Returns the bank
    (in place under ``torch.no_grad``)."""
    cfg = model.cfg
    S = cfg.image_size
    feats, _ = _encode_frame(model, _select_frame(images, frame_idx))
    feats = _expand(feats, prev_low.shape[0])
    prev_high = layers.interpolate(prev_low.float().permute(0, 2, 3, 1), (S, S),
                                   method="bilinear").permute(0, 3, 1, 2)
    maskmem, _ = model.encode_new_memory(
        feats[-1], prev_high, is_mask_from_pts=mask_from_pts, binarize=is_eval,
        apply_non_overlap=(cfg.non_overlap_masks_for_mem_enc and is_eval))
    kcache = (model.memory_kcache(maskmem, bank["kcache"].dtype)
              if "kcache" in bank else None)
    return mb.write_bank(spec, bank, frame_idx, maskmem, prev_ptr, is_cond=False,
                         kcache=kcache)


def _track_run(model: SAM2Model, images, bank, frames: List[int], *, spec: mb.BankSpec,
               pos_kcache, trunk_pe, num_frames: int, is_eval: bool,
               track_in_reverse: bool = False, kv_storage: bool = True):
    """Track a run of consecutive non-conditioning frames (the JAX package's
    ``_scan_track_run``), updating ``bank`` in place. Returns (low-res mask
    logits [len(frames), B, 1, h4, w4], object pointers [len(frames), B, C]),
    fp32."""
    B = bank["cond_feats"].shape[0]
    multimask = use_multimask(model.cfg, False, 0)
    masks, ptrs = [], []
    for f in frames:
        feats, pos = _encode_frame(model, _select_frame(images, f), trunk_pos_embed=trunk_pe)
        out, bank = model.track_step(
            spec, bank, f, is_init_cond_frame=False,
            current_vision_feats=_expand(feats, B), current_vision_pos=_expand(pos, B),
            multimask_output=multimask, run_mem_encoder=True, is_cond_frame=False,
            num_frames=num_frames, is_eval=is_eval, pos_kcache=pos_kcache,
            track_in_reverse=track_in_reverse, kv_storage=kv_storage)
        masks.append(out["pred_masks"].float())
        ptrs.append(out["obj_ptr"].float())
    return torch.stack(masks, dim=0), torch.stack(ptrs, dim=0)


def _run_segments(model: SAM2Model, images, bank, order: List[int], stored: Dict,
                 at_stored=None, **kw):
    """Track ``order``, splicing the stored (mask logits, pointer) of its
    prompt and correction frames between the runs of tracked frames;
    ``at_stored(frame, bank) -> bank`` does the bank work of a spliced frame
    once the run before it is done. Returns (masks [len(order), B, 1, h4,
    w4], pointers [len(order), B, C])."""
    masks, ptrs, run = [], [], []

    def flush():
        if run:
            m, p = _track_run(model, images, bank, run, **kw)
            masks.append(m)
            ptrs.append(p)
            run.clear()

    for f in order:
        if f in stored:
            flush()
            if at_stored is not None:
                bank = at_stored(f, bank)
            masks.append(stored[f][0][None])
            ptrs.append(stored[f][1][None])
        else:
            run.append(f)
    flush()
    return torch.cat(masks, dim=0), torch.cat(ptrs, dim=0)


# ---------------------------------------------------------------------------
# Frame directories
# ---------------------------------------------------------------------------


def _frame_paths(video_path: str) -> List[str]:
    names = [p for p in os.listdir(video_path)
             if os.path.splitext(p)[-1].lower() in (".jpg", ".jpeg")]
    names.sort(key=lambda p: int(os.path.splitext(p)[0]))
    if not names:
        raise RuntimeError(f"no JPEG frames found in {video_path}")
    return [os.path.join(video_path, n) for n in names]


def _decode_frame(path: str, image_size: int):
    """One JPEG -> (normalised float32 [S, S, 3], height, width) of the
    original; PIL resizes, as in the JAX package."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    vw, vh = img.size
    img = img.resize((image_size, image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return ((arr - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32), vh, vw


def _load_video_frames_dir(video_path: str, image_size: int):
    """``<index>.jpg`` frames of a directory -> ([T, S, S, 3] float32 host
    array, height, width) (``utils/misc.py:163-213``)."""
    frames = []
    vh = vw = None
    for path in _frame_paths(video_path):
        f, vh, vw = _decode_frame(path, image_size)
        frames.append(f)
    return np.stack(frames), vh, vw


class _AsyncFrameLoader:
    """Background-thread JPEG decoding (the reference's
    AsyncVideoFrameLoader, ``utils/misc.py:104-160``): the first frame is
    decoded at once (it gives the video's size and is the frame a user
    prompts), a daemon thread fills a preallocated host array with the rest,
    and ``wait()`` joins it and hands the whole video over."""

    def __init__(self, video_path: str, image_size: int):
        import threading

        self.paths = _frame_paths(video_path)
        first, self.video_height, self.video_width = _decode_frame(self.paths[0], image_size)
        self.frames = np.empty((len(self.paths), image_size, image_size, 3), np.float32)
        self.frames[0] = first
        self.exception = None

        def _load_rest():
            try:
                for i in range(1, len(self.paths)):
                    self.frames[i] = _decode_frame(self.paths[i], image_size)[0]
            except Exception as e:  # surfaced by wait()
                self.exception = e

        self.thread = threading.Thread(target=_load_rest, daemon=True)
        self.thread.start()

    def __len__(self):
        return len(self.paths)

    def wait(self) -> np.ndarray:
        self.thread.join()
        if self.exception is not None:
            raise RuntimeError("Failure in frame loading thread") from self.exception
        return self.frames
