"""Fixed-shape temporal memory bank (counterpart of
``medsam2_tpu/state/memory_bank.py``), same dict keys and shapes.

Conditioning memories sit in append-once slots [B, Mc, P, D]; non-conditioning
memories in a ring of the last R frames (slot = t % R); object pointers in cond
slots plus a ring of the last (max_obj_ptrs - 1) frames. The roped-key cache
``kcache`` [B, Mc + R, L, P, C] holds the slots in storage order, and
inference attention consumes it as stored (:func:`kv_storage_layout`) or
gathered in read order (:func:`read_kcache`); training, and a bank without
the cache, read raw memory tokens in read order (:func:`read_bank`). Every
readout takes ``track_in_reverse``: tracking backwards, the stride-r targets
and the pointer window lie after the current frame. A slot whose stored frame
index is -1 (never written, or dropped by :func:`clear_noncond_window`) is
read by none of them, wherever it lies in the ring.

For inference :func:`write_bank` updates the bank in place (the cache is
~67 MB at 1024 px for one object; copying it every frame buys nothing in
eager PyTorch) and returns it for call-site symmetry. When grad is enabled
and the memory or the bank requires grad, it writes out of place and returns
a new dict, as the JAX bank does:
a later frame that reads a slot then reads the tensor autograd recorded, not
one changed under it. Frame indices are host integers; slot choice for a cond
write happens on the device, so no write synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from medsam2_tpu_torch.configs import SAM2Config
from medsam2_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class BankSpec:
    """Static geometry of the memory bank (``memory_bank.BankSpec``)."""

    num_maskmem: int          # frames attended (1 current-adjacent + 6 past)
    max_cond_frames: int      # cap on conditioning (prompted) frames
    mem_spatial: int          # P: tokens per memory frame
    mem_dim: int              # D: memory channels (64)
    hidden_dim: int           # C: object-pointer width (256)
    max_obj_ptrs: int         # pointers in cross-attention (16)
    temporal_stride: int = 1  # the eval stride r

    @classmethod
    def from_config(cls, cfg: SAM2Config, max_cond_frames: int = 8):
        if cfg.max_cond_frames_in_attn >= 0:
            max_cond_frames = max(1, min(max_cond_frames, cfg.max_cond_frames_in_attn))
        s = cfg.image_size // cfg.backbone_stride
        return cls(num_maskmem=cfg.num_maskmem, max_cond_frames=max_cond_frames,
                   mem_spatial=s * s, mem_dim=cfg.mem_dim, hidden_dim=cfg.hidden_dim,
                   max_obj_ptrs=cfg.max_obj_ptrs_in_encoder,
                   temporal_stride=cfg.memory_temporal_stride_for_eval)

    @property
    def noncond_ring(self) -> int:
        # every frame the stride-r selection reaches back to, plus t-1
        return max((self.num_maskmem - 2) * self.temporal_stride + 2, self.num_maskmem - 1)

    @property
    def ptr_ring(self) -> int:
        return max(self.max_obj_ptrs - 1, 1)

    @property
    def num_frames_attended(self) -> int:
        return self.max_cond_frames + self.num_maskmem - 1

    @property
    def num_spatial_tokens(self) -> int:
        return self.num_frames_attended * self.mem_spatial

    @property
    def tokens_per_ptr(self) -> int:
        return self.hidden_dim // self.mem_dim

    @property
    def num_ptr_slots(self) -> int:
        return self.max_cond_frames + self.max_obj_ptrs - 1

    @property
    def num_ptr_tokens(self) -> int:
        return self.num_ptr_slots * self.tokens_per_ptr


def init_bank(spec: BankSpec, batch: int, device,
              kcache_shape: Tuple[int, int] = (0, 0), kcache_dtype=torch.bfloat16):
    """Empty bank for ``batch`` objects; with ``kcache_shape`` = (layers,
    d_model) non-zero it also carries the roped-key cache."""
    B = batch

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    def neg(*shape):
        return torch.full(shape, -1, dtype=torch.int32, device=device)

    bank = {
        "cond_feats": zeros(B, spec.max_cond_frames, spec.mem_spatial, spec.mem_dim),
        "cond_frame_idx": neg(B, spec.max_cond_frames),
        "cond_obj_ptr": zeros(B, spec.max_cond_frames, spec.hidden_dim),
        "cond_count": zeros(B, dt=torch.int32),
        "noncond_feats": zeros(B, spec.noncond_ring, spec.mem_spatial, spec.mem_dim),
        "noncond_frame_idx": neg(B, spec.noncond_ring),
        "ptr_ring": zeros(B, spec.ptr_ring, spec.hidden_dim),
        "ptr_frame_idx": neg(B, spec.ptr_ring),
    }
    L, C = kcache_shape
    if L > 0:
        bank["kcache"] = zeros(B, spec.max_cond_frames + spec.noncond_ring, L,
                               spec.mem_spatial, C, dt=kcache_dtype)
    return bank


def write_bank(spec: BankSpec, bank, frame_idx: int, maskmem_feats, obj_ptr,
               is_cond: bool, kcache=None):
    """Store one frame's memory. maskmem_feats [B, P, D]; obj_ptr [B, C];
    kcache [B, L, P, d_model], required iff the bank carries one. In place
    for inference; out of place (a new dict) when grad is enabled and the
    write or the bank requires grad."""
    with tracing.span("bank.write"):
        if ("kcache" in bank) != (kcache is not None):
            raise ValueError("bank kcache presence and write kcache argument disagree")
        frame_idx = int(frame_idx)
        inplace = not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (maskmem_feats, obj_ptr, kcache, *bank.values())))
        if not inplace:
            bank = dict(bank)

        def put(key, slot, value):
            """bank[key][:, slot] = value; ``slot`` a host int or a [1] index
            tensor on the device."""
            t = bank[key]
            value = value.to(t.dtype)
            if inplace and isinstance(slot, int):
                t[:, slot] = value
            elif inplace:
                t.index_copy_(1, slot, value[:, None])
            else:
                idx = slot if torch.is_tensor(slot) else torch.tensor([slot], device=t.device)
                bank[key] = t.index_copy(1, idx, value[:, None])

        dev = bank["cond_feats"].device
        B = bank["cond_feats"].shape[0]
        frame = torch.full((B,), frame_idx, dtype=torch.int32, device=dev)
        if is_cond:
            # re-prompting a stored frame overwrites its slot; else the first
            # empty slot; else evict the slot farthest from the new frame
            stored = bank["cond_frame_idx"][0].long()
            big = torch.iinfo(torch.int32).max
            key = torch.where(stored == frame_idx, big,
                              torch.where(stored < 0, big - 1, (stored - frame_idx).abs()))
            slot = key.argmax().reshape(1)
            put("cond_feats", slot, maskmem_feats)
            put("cond_frame_idx", slot, frame)
            put("cond_obj_ptr", slot, obj_ptr)
            if kcache is not None:
                put("kcache", slot, kcache)
            count = bank["cond_count"]
            if inplace:
                count.add_(1).clamp_(max=spec.max_cond_frames)
            else:
                bank["cond_count"] = (count + 1).clamp(max=spec.max_cond_frames)
        else:
            slot = frame_idx % spec.noncond_ring
            put("noncond_feats", slot, maskmem_feats)
            if kcache is not None:
                put("kcache", spec.max_cond_frames + slot, kcache)
            put("noncond_frame_idx", slot, frame)
            pslot = frame_idx % spec.ptr_ring
            put("ptr_ring", pslot, obj_ptr)
            put("ptr_frame_idx", pslot, frame)
        return bank


def clear_noncond_window(bank, center: int, radius: int):
    """Invalidate every non-cond memory (feature ring and pointer ring)
    whose stored frame lies in ``[center - radius, center + radius]``
    (``memory_bank.clear_noncond_window``; the reference's
    ``_clear_non_cond_mem_around_input``, ``sam2_video_predictor.py:1424-1440``).
    The stored index becomes -1, which no readout's target matches; the
    payloads stay in place, masked. Cond memories are untouched. In place
    for inference; a new dict when grad is enabled and the bank requires
    grad, as :func:`write_bank`."""
    inplace = not (torch.is_grad_enabled() and any(t.requires_grad for t in bank.values()))
    if not inplace:
        bank = dict(bank)
    for key in ("noncond_frame_idx", "ptr_frame_idx"):
        stored = bank[key]
        hit = (stored >= center - radius) & (stored <= center + radius)
        if inplace:
            stored.masked_fill_(hit, -1)
        else:
            bank[key] = stored.masked_fill(hit, -1)
    return bank


def _noncond_target_frames(spec: BankSpec, frame_idx: int,
                           track_in_reverse: bool = False) -> np.ndarray:
    """Stride-r previous-frame arithmetic (``sam2_base.py:535-558``) for
    t_pos = 1..num_maskmem-1. Forward, t_pos 1 is frame - 1 and the others
    sit on the stride-r grid at or below frame - 2; in reverse, frame + 1
    and the grid at or above frame + 2 (a ceiling division)."""
    r = spec.temporal_stride
    t_pos = np.arange(1, spec.num_maskmem, dtype=np.int64)
    t_rel = spec.num_maskmem - t_pos
    if track_in_reverse:
        last = frame_idx + 1
        strided = -((-(frame_idx + 2)) // r) * r + (t_rel - 2) * r
    else:
        last = frame_idx - 1
        strided = ((frame_idx - 2) // r) * r - (t_rel - 2) * r
    return np.where(t_rel == 1, last, strided).astype(np.int64)


def _ring_slots(spec: BankSpec, targets: np.ndarray, device) -> torch.Tensor:
    return tracing.upload(np.remainder(np.clip(targets, 0, None), spec.noncond_ring), device)


def read_kcache(spec: BankSpec, bank, frame_idx: int, track_in_reverse: bool = False):
    """The roped-key cache gathered in read order: the cond slots, then the
    stride-r non-cond targets (the slot arithmetic of :func:`read_bank`).
    Returns [B, Fa, L, P, C]; a stale or empty slot carries finite values
    that :func:`read_bank`'s validity mask excludes."""
    with tracing.span("bank.read"):
        Mc = spec.max_cond_frames
        slots = _ring_slots(spec, _noncond_target_frames(spec, frame_idx, track_in_reverse),
                            bank["kcache"].device)
        nc = bank["kcache"].index_select(1, Mc + slots)
        return torch.cat([bank["kcache"][:, :Mc], nc], dim=1)


def kv_storage_layout(spec: BankSpec, bank, frame_idx: int, track_in_reverse: bool = False):
    """Per storage slot: which positional row it carries and whether it is
    attended. Returns (row_of_slot [Mc + R] int32, slot_valid [B, Mc + R]
    bool); a ring slot is valid iff its stored frame is one of the stride-r
    targets."""
    with tracing.span("bank.read"):
        dev = bank["noncond_frame_idx"].device
        Mc = spec.max_cond_frames
        targets = tracing.upload(_noncond_target_frames(spec, frame_idx, track_in_reverse), dev)
        stored = bank["noncond_frame_idx"].long()                               # [B, R]
        eq = (stored[:, :, None] == targets[None, None, :]) & (targets >= 0)[None, None, :]
        ring_valid = eq.any(dim=-1)
        ring_row = Mc + eq[0].int().argmax(dim=-1).int()      # invalid slots: masked
        cond_valid = bank["cond_frame_idx"] >= 0
        row_of_slot = torch.cat([torch.arange(Mc, dtype=torch.int32, device=dev), ring_row])
        return row_of_slot, torch.cat([cond_valid, ring_valid], dim=1)


def pos_kcache_rows(spec: BankSpec, maskmem_tpos_enc, spatial_pos):
    """Per read-order slot positional rows [Fa, P, mem_dim]: spatial sine pos
    plus the slot's temporal embedding (cond slots take index num_maskmem-1,
    non-cond position j takes num_maskmem - j - 2)."""
    D = spec.mem_dim
    cond_tpos = maskmem_tpos_enc[spec.num_maskmem - 1]
    tpos_idx = spec.num_maskmem - np.arange(1, spec.num_maskmem) - 1
    nc_tpos = maskmem_tpos_enc[tracing.upload(tpos_idx, maskmem_tpos_enc.device)]
    tpos = torch.cat([cond_tpos[None].expand(spec.max_cond_frames, D), nc_tpos], dim=0)
    return spatial_pos[None, :, :] + tpos[:, None, :]


def read_ptrs(spec: BankSpec, bank, frame_idx: int, track_in_reverse: bool = False,
              obj_ptrs_in_past_only: bool = False, num_frames: int = 2 ** 30):
    """Object-pointer readout (``sam2_base.py:583-635``): all cond pointers
    plus up to min(num_frames, max_obj_ptrs) - 1 recent non-cond pointers
    (the frames before the current one, or after it in reverse), split into
    mem_dim tokens. Returns (ptr_tokens [B, Nt, D], ptr_token_valid [B, Nt]
    bool, ptr_tdiff [B, num_ptr_slots])."""
    with tracing.span("bank.read"):
        B = bank["cond_obj_ptr"].shape[0]
        D = spec.mem_dim
        dev = bank["cond_obj_ptr"].device
        cond_idx = bank["cond_frame_idx"]
        cond_valid = cond_idx >= 0
        if obj_ptrs_in_past_only:
            cond_valid = cond_valid & ((cond_idx >= frame_idx) if track_in_reverse
                                       else (cond_idx <= frame_idx))
        eff_max = min(int(num_frames), spec.max_obj_ptrs)
        t_diff = np.arange(1, spec.max_obj_ptrs, dtype=np.int64)
        targets = frame_idx + t_diff if track_in_reverse else frame_idx - t_diff
        in_range = (targets >= 0) & (targets < num_frames) & (t_diff < eff_max)
        pslots = tracing.upload(np.remainder(np.clip(targets, 0, None), spec.ptr_ring), dev)
        ring_ptrs = bank["ptr_ring"].index_select(1, pslots)
        ring_stored = bank["ptr_frame_idx"].index_select(1, pslots)
        ring_valid = ((ring_stored == tracing.upload(targets, dev)[None])
                      & tracing.upload(in_range, dev)[None])
        # a frame both cond and in the pointer window contributes its cond pointer
        dup = (ring_stored[:, :, None] == cond_idx[:, None, :]) & cond_valid[:, None, :]
        ring_valid = ring_valid & ~dup.any(dim=-1)

        all_ptrs = torch.cat([bank["cond_obj_ptr"], ring_ptrs], dim=1)
        all_valid = torch.cat([cond_valid, ring_valid], dim=1)
        all_t = torch.cat([cond_idx, ring_stored], dim=1)
        ptr_tdiff = torch.where(all_valid, (all_t - frame_idx).abs(), torch.zeros_like(all_t))
        tok = spec.tokens_per_ptr
        ptr_tokens = all_ptrs.reshape(B, spec.num_ptr_slots * tok, D)
        ptr_valid = all_valid.repeat_interleave(tok, dim=1)
        return ptr_tokens, ptr_valid, ptr_tdiff


def read_bank(spec: BankSpec, bank, frame_idx: int, maskmem_tpos_enc, spatial_pos,
              track_in_reverse: bool = False, obj_ptrs_in_past_only: bool = False,
              num_frames: int = 2 ** 30):
    """Read-order memory for cross-attention at ``frame_idx``
    (``memory_bank.read_bank``, ``sam2_base.py:494-635``): the cond slots,
    then the stride-r non-cond targets gathered from the ring, then the
    object-pointer tokens. maskmem_tpos_enc [num_maskmem, D]; spatial_pos
    [P, D].

    Returns (memory [B, T, D], memory_pos [B, T, D], valid [B, T] bool,
    num_obj_ptr_tokens, ptr_tdiff [B, num_ptr_slots]); T = Fa * P + the
    pointer tokens. The gathers are differentiable: gradients reach the
    memories of earlier frames."""
    with tracing.span("bank.read"):
        P, D = spec.mem_spatial, spec.mem_dim
        B = bank["cond_feats"].shape[0]
        dev = bank["cond_feats"].device
        Mc = spec.max_cond_frames
        cond_valid = bank["cond_frame_idx"] >= 0                              # [B, Mc]
        cond_tpos = maskmem_tpos_enc[spec.num_maskmem - 1]                    # [D]
        targets_np = _noncond_target_frames(spec, frame_idx, track_in_reverse)  # [F]
        slots = _ring_slots(spec, targets_np, dev)
        targets = tracing.upload(targets_np, dev)
        nc_feats = bank["noncond_feats"].index_select(1, slots)               # [B, F, P, D]
        stored = bank["noncond_frame_idx"].index_select(1, slots).long()
        nc_valid = (stored == targets[None]) & (targets >= 0)[None]
        # t_pos k takes embedding num_maskmem - k - 1 (sam2_base.py:577-579)
        tpos_idx = spec.num_maskmem - torch.arange(1, spec.num_maskmem, device=dev) - 1
        tpos = torch.cat([cond_tpos[None].expand(Mc, D), maskmem_tpos_enc[tpos_idx]], dim=0)

        Fa = spec.num_frames_attended
        memory_sp = torch.cat([bank["cond_feats"], nc_feats], dim=1).reshape(B, Fa * P, D)
        pos_sp = (spatial_pos[None] + tpos[:, None]).reshape(1, Fa * P, D)
        pos_sp = pos_sp.expand(B, Fa * P, D).to(memory_sp.dtype)
        valid_sp = torch.cat([cond_valid, nc_valid], dim=1).repeat_interleave(P, dim=1)

        ptr_tokens, ptr_valid, ptr_tdiff = read_ptrs(
            spec, bank, frame_idx, track_in_reverse=track_in_reverse,
            obj_ptrs_in_past_only=obj_ptrs_in_past_only, num_frames=num_frames)
        memory = torch.cat([memory_sp, ptr_tokens.to(memory_sp.dtype)], dim=1)
        memory_pos = torch.cat([pos_sp, pos_sp.new_zeros(B, spec.num_ptr_tokens, D)], dim=1)
        valid = torch.cat([valid_sp, ptr_valid], dim=1)
        return memory, memory_pos, valid, spec.num_ptr_tokens, ptr_tdiff
