"""SAM2 model assembly (counterpart of ``medsam2_tpu/core/sam2_model.py``),
the part the 3D propagation and 3D training paths reach.

:class:`SAM2Model` holds the reference's submodules under the reference's
state-dict keys. ``forward_image`` runs the encoder; ``forward_sam_heads`` the
prompt encoder and mask decoder with occlusion handling; ``track_step`` fuses
the current frame with the bank through the memory attention, runs the SAM
heads and writes the new memory. As in the JAX package, three readouts serve
inference: storage order over the bank's roped-key cache (the default), read
order over the same cache gathered by :func:`memory_bank.read_kcache`
(``kv_storage=False``), and read order over raw memory tokens (a bank
without the cache; training). Each reads forward or, with
``track_in_reverse``, backward in time. :meth:`SAM2Model.set_trainable_groups`
marks the 3D recipe's two trainable parameter groups.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from medsam2_tpu_torch.configs import SAM2Config
from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.image_encoder import ImageEncoder
from medsam2_tpu_torch.core.mask_decoder import MaskDecoder
from medsam2_tpu_torch.core.memory import (MemoryAttention, MemoryEncoder,
                                           precompute_memory_kcache,
                                           precompute_pos_kcache)
from medsam2_tpu_torch.core.pos_enc import get_1d_sine_pe, sine_pos_embed
from medsam2_tpu_torch.core.prompt_encoder import PromptEncoder
from medsam2_tpu_torch.state import memory_bank as mb
from medsam2_tpu_torch.utils import tracing

NO_OBJ_SCORE = -1024.0

# The 3D recipe's parameter groups (``recipe_3d._param_labels``,
# reference ``train_3d.py:34-46``); every other parameter is frozen.
TRAINABLE_GROUPS = {
    "sam": ("sam_mask_decoder",),
    "mem": ("obj_ptr_proj", "memory_encoder", "memory_attention", "mask_downsample"),
}


class SamHeadOutputs(NamedTuple):
    low_res_multimasks: torch.Tensor  # [B, M, h4, w4]
    ious: torch.Tensor                # [B, M]
    low_res_masks: torch.Tensor       # [B, 1, h4, w4]
    high_res_masks: torch.Tensor      # [B, 1, H, W]
    obj_ptr: torch.Tensor             # [B, C]
    object_score_logits: torch.Tensor  # [B, 1]


def compute_dtype(cfg: SAM2Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def kcache_shape(cfg: SAM2Config) -> Tuple[int, int]:
    """(num_layers, d_model) of the bank's roped-key cache, or (0, 0) when the
    cache does not apply."""
    if cfg.num_maskmem <= 0 or not cfg.memory_attention.pos_enc_at_cross_attn_keys:
        return (0, 0)
    return (cfg.memory_attention.num_layers, cfg.memory_attention.d_model)


def use_multimask(cfg: SAM2Config, is_init_cond_frame: bool, num_pts: int) -> bool:
    """``SAM2Base._use_multimask`` (``sam2_base.py:802-810``)."""
    return (cfg.multimask_output_in_sam
            and (is_init_cond_frame or cfg.multimask_output_for_tracking)
            and cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num)


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the highest-scoring object per pixel (``sam2_base.py:812-830``).
    pred_masks [B_obj, 1, H, W]."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    max_obj = pred_masks.argmax(dim=0, keepdim=True)
    batch_obj = torch.arange(pred_masks.shape[0], device=pred_masks.device)[:, None, None, None]
    return torch.where(max_obj == batch_obj, pred_masks, pred_masks.clamp(max=-10.0))


class SAM2Model(nn.Module):
    """``SAM2Base`` with random weights from ``seed`` (or loaded from a
    reference state dict, :mod:`medsam2_tpu_torch.checkpoint.convert`).
    Weights are made on the CPU from a seeded generator, then moved to
    ``device``, so one seed gives the same model on every device. The model
    lives on the card unless the caller asks for ``device="cpu"``; without a
    CUDA device the default raises rather than fall back to the CPU. All
    parameters start frozen (inference)."""

    def __init__(self, cfg: SAM2Config, seed: int = 0, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SAM2Model: no CUDA device; pass device='cpu' to run on the CPU")
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.image_encoder = ImageEncoder(cfg, gen)
        self.sam_prompt_encoder = PromptEncoder(cfg, gen)
        self.sam_mask_decoder = MaskDecoder(cfg, gen)
        self.memory_attention = MemoryAttention(cfg.memory_attention, gen)
        self.memory_encoder = MemoryEncoder(cfg.memory_encoder, gen)
        self.maskmem_tpos_enc = layers.trunc_normal((cfg.num_maskmem, 1, 1, cfg.mem_dim), gen)
        self.no_mem_embed = layers.trunc_normal((1, 1, cfg.hidden_dim), gen)
        self.no_mem_pos_enc = layers.trunc_normal((1, 1, cfg.hidden_dim), gen)
        if cfg.use_obj_ptrs_in_encoder:
            self.mask_downsample = layers.Conv2d(1, 1, 4, gen, stride=4)
            if cfg.use_mlp_for_obj_ptr_proj:
                self.obj_ptr_proj = layers.MLP(cfg.hidden_dim, cfg.hidden_dim,
                                               cfg.hidden_dim, 3, gen)
            else:
                self.obj_ptr_proj = layers.Linear(cfg.hidden_dim, cfg.hidden_dim, gen)
        if cfg.proj_tpos_enc_in_obj_ptrs:
            self.obj_ptr_tpos_proj = layers.Linear(cfg.hidden_dim, cfg.mem_dim, gen)
        if cfg.pred_obj_scores and cfg.use_obj_ptrs_in_encoder:
            self.no_obj_ptr = layers.trunc_normal((1, cfg.hidden_dim), gen)
        self.requires_grad_(False)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.no_mem_embed.device

    def set_trainable_groups(self) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
        """Turn on gradients for exactly the recipe's two groups
        (:data:`TRAINABLE_GROUPS`) and freeze the rest. Returns
        {"sam": [(name, parameter)], "mem": [...]} in state-dict order."""
        self.requires_grad_(False)
        groups = {g: [] for g in TRAINABLE_GROUPS}
        owner = {m: g for g, mods in TRAINABLE_GROUPS.items() for m in mods}
        for name, p in self.named_parameters():
            g = owner.get(name.split(".")[0])
            if g is not None:
                p.requires_grad_(True)
                groups[g].append((name, p))
        return groups

    def encoder_trains(self) -> bool:
        return any(p.requires_grad for p in self.image_encoder.parameters())

    # ------------------------------------------------------------------
    # Image features
    # ------------------------------------------------------------------

    def forward_image(self, img_batch, trunk_pos_embed=None) -> Dict:
        """Encode [B, H, W, 3] images and project the decoder's high-res skip
        features (``sam2_base.py:464-476``). A frozen encoder runs under
        ``torch.no_grad`` (the recipe's ``remat="enc_saved"``: nothing of the
        trunk is kept for the backward); the skip projections belong to the
        mask decoder and keep their graph."""
        with tracing.span("image_encoder"):
            with torch.set_grad_enabled(torch.is_grad_enabled() and self.encoder_trains()):
                out = self.image_encoder(img_batch, trunk_pos_embed=trunk_pos_embed)
            if self.cfg.use_high_res_features_in_sam:
                dec = self.sam_mask_decoder
                fpn = list(out["backbone_fpn"])
                fpn[0] = dec.conv_s0(fpn[0])
                fpn[1] = dec.conv_s1(fpn[1])
                out["backbone_fpn"] = fpn
            return out

    def prepare_backbone_features(self, backbone_out: Dict):
        """(features, position encodings) of the last ``num_feature_levels``
        levels, NHWC."""
        n = self.cfg.num_feature_levels
        return backbone_out["backbone_fpn"][-n:], backbone_out["vision_pos_enc"][-n:]

    # ------------------------------------------------------------------
    # SAM heads
    # ------------------------------------------------------------------

    def forward_sam_heads(self, backbone_features, point_inputs: Optional[Dict] = None,
                          mask_inputs=None, high_res_features=None,
                          multimask_output: bool = False,
                          eval_dynamic_multimask: bool = False) -> SamHeadOutputs:
        """``SAM2Base._forward_sam_heads`` (``sam2_base.py:252-410``)."""
        with tracing.span("sam_heads"):
            cfg = self.cfg
            B = backbone_features.shape[0]
            dev = backbone_features.device
            if point_inputs is not None:
                coords = point_inputs["point_coords"]
                labels = point_inputs["point_labels"]
            else:
                coords = torch.zeros(B, 1, 2, device=dev)
                labels = -torch.ones(B, 1, dtype=torch.int32, device=dev)
            sam_mask_prompt = None
            if mask_inputs is not None:
                ms = cfg.sam_image_embedding_size * 4
                sam_mask_prompt = mask_inputs.float()
                if mask_inputs.shape[1] != ms:
                    sam_mask_prompt = layers.interpolate(sam_mask_prompt, (ms, ms),
                                                         method="bilinear", antialias=True)
            pe = self.sam_prompt_encoder
            sparse, dense = pe((coords, labels), masks=sam_mask_prompt)
            low_res_multimasks, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
                backbone_features, pe.get_dense_pe(), sparse, dense,
                multimask_output=multimask_output, high_res_features=high_res_features,
                dynamic_multimask_via_stability=eval_dynamic_multimask)
            if cfg.pred_obj_scores:
                appearing = obj_logits > 0
                low_res_multimasks = torch.where(appearing[:, :, None, None], low_res_multimasks,
                                                 torch.full_like(low_res_multimasks, NO_OBJ_SCORE))
            low_res_multimasks = low_res_multimasks.float()

            sam_token = sam_tokens[:, 0]
            if multimask_output:
                best = ious.argmax(dim=-1)
                bidx = torch.arange(B, device=dev)
                low_res_masks = low_res_multimasks[bidx, best][:, None]
                if sam_tokens.shape[1] > 1:
                    sam_token = sam_tokens[bidx, best]
            else:
                low_res_masks = low_res_multimasks
            # the resize is per mask, so upsampling only the selected mask is exact
            high_res_masks = layers.interpolate(
                low_res_masks.permute(0, 2, 3, 1), (cfg.image_size, cfg.image_size),
                method="bilinear").permute(0, 3, 1, 2)

            if cfg.use_obj_ptrs_in_encoder:
                obj_ptr = self.obj_ptr_proj(sam_token)
            else:
                obj_ptr = sam_token
            if cfg.pred_obj_scores:
                if cfg.soft_no_obj_ptr:
                    lam = torch.sigmoid(obj_logits)
                else:
                    lam = (obj_logits > 0).to(obj_ptr.dtype)
                if cfg.fixed_no_obj_ptr:
                    obj_ptr = lam * obj_ptr
                obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr.to(obj_ptr.dtype)
            return SamHeadOutputs(low_res_multimasks, ious, low_res_masks, high_res_masks,
                                  obj_ptr, obj_logits)

    def use_mask_as_output(self, backbone_features, high_res_features,
                           mask_inputs) -> SamHeadOutputs:
        """A binary mask input turned directly into +/-10 logits
        (``sam2_base.py:412-462``). mask_inputs [B, H, W, 1]."""
        cfg = self.cfg
        out_scale, out_bias = 20.0, -10.0
        mask_f = mask_inputs.float()
        high_res_masks = (mask_f * out_scale + out_bias).permute(0, 3, 1, 2)
        H, W = mask_f.shape[1], mask_f.shape[2]
        low_res_masks = layers.interpolate(mask_f * out_scale + out_bias, (H // 4, W // 4),
                                           method="bilinear",
                                           antialias=True).permute(0, 3, 1, 2)
        B = mask_f.shape[0]
        ious = mask_f.new_ones(B, 1)
        if not cfg.use_obj_ptrs_in_encoder:
            obj_ptr = mask_f.new_zeros(B, cfg.hidden_dim)
        else:
            down = self.mask_downsample(mask_f)
            obj_ptr = self.forward_sam_heads(backbone_features, mask_inputs=down,
                                             high_res_features=high_res_features).obj_ptr
        lam = (mask_f.reshape(B, -1) > 0).any(dim=1, keepdim=True).float()
        obj_logits = out_scale * lam + out_bias
        if cfg.pred_obj_scores:
            if cfg.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr.to(obj_ptr.dtype)
        return SamHeadOutputs(low_res_masks, ious, low_res_masks, high_res_masks,
                              obj_ptr, obj_logits)

    # ------------------------------------------------------------------
    # Memory
    # ------------------------------------------------------------------

    def encode_new_memory(self, pix_feat, pred_masks_high_res, is_mask_from_pts,
                          binarize: bool = False, apply_non_overlap: bool = False):
        """``SAM2Base._encode_new_memory`` (``sam2_base.py:665-703``).
        pix_feat [B, h, w, C]; pred_masks_high_res [B, 1, H, W] logits;
        ``is_mask_from_pts`` a bool or a per-object [B] bool tensor.
        Returns (maskmem_features [B, h*w, D], pos [h*w, D])."""
        with tracing.span("memory_encoder"):
            cfg = self.cfg
            masks = pred_masks_high_res
            if apply_non_overlap:
                masks = apply_non_overlapping_constraints(masks)
            masks = masks.permute(0, 2, 3, 1)
            if binarize and cfg.binarize_mask_from_pts_for_mem_enc:
                binarized = (masks > 0).float()
                sig = torch.sigmoid(masks)
                if isinstance(is_mask_from_pts, bool):
                    mask_for_mem = binarized if is_mask_from_pts else sig
                else:
                    sel = torch.as_tensor(is_mask_from_pts,
                                          device=masks.device).reshape(-1, 1, 1, 1)
                    mask_for_mem = torch.where(sel, binarized, sig)
            else:
                mask_for_mem = torch.sigmoid(masks)
            mask_for_mem = (mask_for_mem * cfg.sigmoid_scale_for_mem_enc
                            + cfg.sigmoid_bias_for_mem_enc)
            dt = compute_dtype(cfg)
            feats, pos = self.memory_encoder(pix_feat.to(dt), mask_for_mem.to(dt))
            B, h, w, D = feats.shape
            return feats.reshape(B, h * w, D), pos.reshape(h * w, D)

    def make_pos_kcache(self, spec: mb.BankSpec):
        """Session-static positional half of the roped-key cache [Fa, L, P, C];
        computed once per propagation."""
        cfg = self.cfg
        mem_h = cfg.sam_image_embedding_size
        spatial = sine_pos_embed(mem_h, mem_h, cfg.mem_dim, device=self.device)
        rows = mb.pos_kcache_rows(spec, self.maskmem_tpos_enc.reshape(cfg.num_maskmem, -1),
                                  spatial.reshape(-1, cfg.mem_dim))
        return precompute_pos_kcache(self.memory_attention, rows, (mem_h, mem_h),
                                     dtype=compute_dtype(cfg))

    def memory_kcache(self, maskmem_features, dtype):
        """This frame's half of the roped-key cache [B, L, P, C]."""
        with tracing.span("memory_encoder"):
            mem_h = self.cfg.sam_image_embedding_size
            return precompute_memory_kcache(self.memory_attention, maskmem_features,
                                            (mem_h, mem_h), dtype=dtype)

    def _obj_ptr_pos(self, spec: mb.BankSpec, ptr_tdiff, num_frames: int, dtype):
        """Temporal sine encoding of the pointer distances, normalised by the
        pointer reach and projected to mem_dim when configured
        (``sam2_base.py:617-634``); one row per pointer token [B, Nt, D]."""
        cfg = self.cfg
        t_diff_max = max(min(int(num_frames), cfg.max_obj_ptrs_in_encoder) - 1, 1)
        tpos_dim = cfg.hidden_dim if cfg.proj_tpos_enc_in_obj_ptrs else cfg.mem_dim
        obj_pos = get_1d_sine_pe(ptr_tdiff.float() / t_diff_max, tpos_dim)
        if cfg.proj_tpos_enc_in_obj_ptrs:
            obj_pos = self.obj_ptr_tpos_proj(obj_pos)
        return obj_pos.repeat_interleave(spec.tokens_per_ptr, dim=1).to(dtype)

    def _memory_conditioned_features_storage(self, spec: mb.BankSpec, bank, frame_idx: int,
                                             curr, curr_pos, q_hw, num_frames: int,
                                             is_eval: bool, pos_kcache, track_in_reverse: bool,
                                             generator=None):
        """Storage-order memory readout (``sam2_model.py:394-452``):
        cross-attention consumes the bank's roped-key cache as stored, with
        per-slot positional rows and validity from
        :func:`memory_bank.kv_storage_layout`. Returns [B, Nq, C]."""
        cfg = self.cfg
        P = spec.mem_spatial
        ptr_tokens, ptr_valid, ptr_tdiff = mb.read_ptrs(
            spec, bank, frame_idx, track_in_reverse=track_in_reverse,
            obj_ptrs_in_past_only=(cfg.only_obj_ptrs_in_the_past_for_eval and is_eval),
            num_frames=num_frames)
        if not cfg.use_obj_ptrs_in_encoder:
            ptr_valid = torch.zeros_like(ptr_valid)
        if cfg.use_obj_ptrs_in_encoder and cfg.add_tpos_enc_to_obj_ptrs:
            ptr_pos = self._obj_ptr_pos(spec, ptr_tdiff, num_frames, curr.dtype)
        else:
            ptr_pos = torch.zeros_like(ptr_tokens, dtype=curr.dtype)
        row_of_slot, slot_valid = mb.kv_storage_layout(spec, bank, frame_idx,
                                                       track_in_reverse=track_in_reverse)
        kv_mask = torch.cat([slot_valid.repeat_interleave(P, dim=1), ptr_valid], dim=1)
        v_slots = torch.cat([bank["cond_feats"], bank["noncond_feats"]], dim=1).to(curr.dtype)
        bundle = {
            "kcache": bank["kcache"],
            "pos_rows": pos_kcache,
            "row_of_slot": row_of_slot,
            "v_slots": v_slots,
            "ptr_tokens": ptr_tokens.to(curr.dtype),
            "ptr_pos": ptr_pos,
            "kv_mask": kv_mask,
        }
        return self.memory_attention(curr, curr_pos, q_hw, kv_bundle=bundle,
                                     generator=generator)

    def _memory_conditioned_features_read(self, spec: mb.BankSpec, bank, frame_idx: int,
                                          curr, curr_pos, q_hw, num_frames: int,
                                          is_eval: bool, track_in_reverse: bool = False,
                                          pos_kcache=None, generator=None):
        """Read-order memory readout (``sam2_model.py:347-391``): memory
        tokens gathered by :func:`memory_bank.read_bank`, cross-attention
        through the flash dispatcher with the low-rank value path. With
        ``pos_kcache`` and a bank that carries the roped-key cache, the
        spatial keys come from the cache in read order
        (:func:`memory_bank.read_kcache`); otherwise from the raw tokens.
        Returns [B, Nq, C]."""
        cfg = self.cfg
        mem_h = cfg.sam_image_embedding_size
        spatial = sine_pos_embed(mem_h, mem_h, cfg.mem_dim, device=curr.device)
        memory, memory_pos, valid, num_ptr, ptr_tdiff = mb.read_bank(
            spec, bank, frame_idx, self.maskmem_tpos_enc.reshape(cfg.num_maskmem, -1),
            spatial.reshape(-1, cfg.mem_dim), track_in_reverse=track_in_reverse,
            obj_ptrs_in_past_only=(cfg.only_obj_ptrs_in_the_past_for_eval and is_eval),
            num_frames=num_frames)
        n_sp = spec.num_spatial_tokens
        if cfg.use_obj_ptrs_in_encoder and cfg.add_tpos_enc_to_obj_ptrs:
            obj_pos = self._obj_ptr_pos(spec, ptr_tdiff, num_frames, memory_pos.dtype)
            memory_pos = torch.cat([memory_pos[:, :n_sp], obj_pos], dim=1)
        if not cfg.use_obj_ptrs_in_encoder:
            memory, memory_pos, valid = memory[:, :n_sp], memory_pos[:, :n_sp], valid[:, :n_sp]
            num_ptr = 0
        k_cache = None
        if pos_kcache is not None and "kcache" in bank:
            k_cache = (mb.read_kcache(spec, bank, frame_idx, track_in_reverse), pos_kcache)
        return self.memory_attention(
            curr, curr_pos, q_hw, memory=memory.to(curr.dtype),
            memory_pos=memory_pos.to(curr.dtype), num_obj_ptr_tokens=num_ptr,
            kv_mask=valid, k_cache=k_cache, generator=generator)

    def prepare_memory_conditioned_features(self, spec: mb.BankSpec, bank, frame_idx: int,
                                            is_init_cond_frame: bool, current_vision_feats,
                                            current_vision_pos, num_frames: int,
                                            is_eval: bool, pos_kcache=None,
                                            track_in_reverse: bool = False,
                                            kv_storage: bool = True, generator=None):
        """``SAM2Base._prepare_memory_conditioned_features`` against the bank.
        With ``pos_kcache`` and a bank that carries the roped-key cache the
        memory is read in storage order, or with ``kv_storage=False`` in read
        order over the cache; otherwise in read order over raw memory tokens.
        ``generator`` turns on the memory-attention dropout. Returns
        [B, h, w, C]."""
        with tracing.span("memory_attention"):
            cfg = self.cfg
            B, h, w, C = current_vision_feats.shape
            curr = current_vision_feats.reshape(B, h * w, C)
            if cfg.num_maskmem == 0:
                return current_vision_feats
            curr_pos = current_vision_pos.reshape(B, h * w, C).to(curr.dtype)
            if is_init_cond_frame:
                if cfg.directly_add_no_mem_embed:
                    return (curr + self.no_mem_embed.to(curr.dtype)).reshape(B, h, w, C)
                tokens = self.no_mem_embed.to(curr.dtype).expand(B, 1, C)
                pos = self.no_mem_pos_enc.to(curr.dtype).expand(B, 1, C)
                out = self.memory_attention(curr, curr_pos, (w, h), memory=tokens,
                                            memory_pos=pos, num_obj_ptr_tokens=0,
                                            generator=generator)
                return out.reshape(B, h, w, C)
            if kv_storage and pos_kcache is not None and "kcache" in bank:
                out = self._memory_conditioned_features_storage(
                    spec, bank, frame_idx, curr, curr_pos, (w, h), num_frames, is_eval,
                    pos_kcache, track_in_reverse, generator)
            else:
                out = self._memory_conditioned_features_read(
                    spec, bank, frame_idx, curr, curr_pos, (w, h), num_frames, is_eval,
                    track_in_reverse, pos_kcache, generator)
            return out.reshape(B, h, w, C)

    # ------------------------------------------------------------------
    # track_step
    # ------------------------------------------------------------------

    def track_step(self, spec: mb.BankSpec, bank, frame_idx: int, is_init_cond_frame: bool,
                   current_vision_feats: List[torch.Tensor],
                   current_vision_pos: List[torch.Tensor], point_inputs=None,
                   mask_inputs=None, multimask_output: bool = False,
                   run_mem_encoder: bool = True, is_cond_frame: bool = False,
                   num_frames: int = 2 ** 30, is_eval: bool = False, pos_kcache=None,
                   track_in_reverse: bool = False, kv_storage: bool = True,
                   generator: Optional[torch.Generator] = None):
        """One frame (``sam2_base.py:705-800``): memory readout -> SAM heads ->
        memory write. ``track_in_reverse``, ``pos_kcache`` and ``kv_storage``
        choose the readout (:meth:`prepare_memory_conditioned_features`);
        ``generator`` turns on the memory-attention dropout.
        Returns (outputs dict, bank); for inference the bank is updated in
        place, in training the returned bank is a new dict
        (:func:`memory_bank.write_bank`)."""
        cfg = self.cfg
        high_res = list(current_vision_feats[:-1]) if len(current_vision_feats) > 1 else None
        if mask_inputs is not None and cfg.use_mask_input_as_output_without_sam:
            sam = self.use_mask_as_output(current_vision_feats[-1], high_res, mask_inputs)
        else:
            pix = self.prepare_memory_conditioned_features(
                spec, bank, frame_idx, is_init_cond_frame, current_vision_feats[-1],
                current_vision_pos[-1], num_frames=num_frames, is_eval=is_eval,
                pos_kcache=pos_kcache, track_in_reverse=track_in_reverse,
                kv_storage=kv_storage, generator=generator)
            sam = self.forward_sam_heads(pix, point_inputs=point_inputs,
                                         mask_inputs=mask_inputs, high_res_features=high_res,
                                         multimask_output=multimask_output,
                                         eval_dynamic_multimask=is_eval)
        out = {"pred_masks": sam.low_res_masks, "pred_masks_high_res": sam.high_res_masks,
               "obj_ptr": sam.obj_ptr, "ious": sam.ious,
               "object_score_logits": sam.object_score_logits}
        if run_mem_encoder and cfg.num_maskmem > 0:
            with tracing.span("memory_encoder"):
                feats, _ = self.encode_new_memory(
                    current_vision_feats[-1], sam.high_res_masks,
                    is_mask_from_pts=(point_inputs is not None), binarize=is_eval,
                    apply_non_overlap=(cfg.non_overlap_masks_for_mem_enc and is_eval))
                kcache = (self.memory_kcache(feats, bank["kcache"].dtype)
                          if "kcache" in bank else None)
            bank = mb.write_bank(spec, bank, frame_idx, feats, sam.obj_ptr,
                                 is_cond=is_cond_frame, kcache=kcache)
        return out, bank
