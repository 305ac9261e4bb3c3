"""Fixed-slot similarity-addressed memory bank of 2D training (counterpart of
``medsam2_tpu/state/similarity_bank.py``; reference
``func_2d/function.py:87-243``).

- **Read** (``:92-125``): L2-normalise the stored image embeddings and the
  batch's, softmax the cosine similarities over the valid slots, draw
  ``num_samples`` slots per batch item (with replacement) and concatenate
  their memory features as the cross-attention memory.
- **Write** (``:204-243``): while the bank holds fewer than ``bank_size``
  entries (decided once per batch), append each item; else, per item, find
  the entry least similar to the new memory, then that entry's most similar
  other entry, and replace the latter iff the new memory is less similar
  than that pair and its IoU is within 0.1 of the replaced entry's.

The bank is a dict of tensors on one device: ``feats`` [K, P, mem_dim],
``iou`` [K], ``embeds`` [K, E], ``valid`` [K] bool. Nothing here syncs with
the host: the draws come from ``torch.multinomial`` with an explicit
``torch.Generator`` on the bank's device, and each write is a ``torch.where``
on the chosen slot (the JAX package's ``lax.cond``). Ties in ``argmin`` /
``argmax`` go to the first index, as in JAX; while fewer than two slots are
valid, the pair-similarity row is all -inf and the replacement target is
slot 0 (never written then: the bank is still appending).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_EPS = 1e-12


def init_similarity_bank(num_slots: int, mem_spatial: int, mem_dim: int, embed_dim: int,
                         device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    K = num_slots
    return {"feats": torch.zeros(K, mem_spatial, mem_dim, dtype=dtype, device=device),
            "iou": torch.zeros(K, dtype=torch.float32, device=device),
            "embeds": torch.zeros(K, embed_dim, dtype=dtype, device=device),
            "valid": torch.zeros(K, dtype=torch.bool, device=device)}


def _unit_rows(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(_EPS)


def similarity_logits(bank, cur_embeds):
    """Cosine-similarity sampling logits [B, K] over the slots (``:101-109``):
    their softmax is the reference's multinomial weights. Invalid slots get
    -inf."""
    sim = _unit_rows(cur_embeds) @ _unit_rows(bank["embeds"]).t()
    return torch.where(bank["valid"][None, :], sim, torch.full_like(sim, float("-inf")))


def read_similarity_bank(bank, cur_embeds, generator: Optional[torch.Generator],
                         num_samples: int,
                         indices: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw memories for each batch item. cur_embeds [B, E]. ``indices``
    [B, num_samples] overrides the draw (the tests inject the JAX package's
    categorical draws through it). Returns (memory [B, num_samples * P, D],
    slot indices [B, num_samples])."""
    if indices is None:
        probs = torch.softmax(similarity_logits(bank, cur_embeds.to(bank["embeds"].dtype)), -1)
        idx = torch.multinomial(probs, num_samples, replacement=True, generator=generator)
    else:
        idx = torch.as_tensor(indices, device=bank["feats"].device).long()
    mem = bank["feats"][idx]  # [B, S, P, D]
    B, S, P, D = mem.shape
    return mem.reshape(B, S * P, D), idx


def write_similarity_bank(bank, feats, iou, embeds, bank_size: Optional[int] = None):
    """Insert or replace a batch of memories; returns the new bank (the
    input's tensors are left as they were). feats [B, P, D]; iou a scalar
    tensor (the reference stores the batch-mean IoU for every entry,
    ``:209``); embeds [B, E].

    ``bank_size`` is the reference's logical ``memory_bank_size`` (default:
    the K slots). The reference checks ``len(bank) < memory_bank_size`` once
    per step and then appends the whole batch (``function.py:204-210``), so
    the bank can overshoot the nominal size by up to B - 1 and then stays
    there; callers that want that at batch sizes that do not divide the size
    allocate ``K = B * ceil(size / B)`` slots and pass ``bank_size=size``."""
    B = feats.shape[0]
    K = bank["feats"].shape[0]
    size = K if bank_size is None else min(bank_size, K)
    bank = {k: v.clone() for k, v in bank.items()}
    dev = bank["feats"].device
    iou = torch.as_tensor(iou, dtype=torch.float32, device=dev).reshape(())
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    # the batch-level append / replace decision, taken before the loop
    append_mode = bank["valid"].sum() < size
    for i in range(B):
        valid = bank["valid"]
        count = valid.sum()
        new_feat = feats[i]
        new_norm = _unit_rows(new_feat.reshape(1, -1))[0]
        bank_norm = _unit_rows(bank["feats"].reshape(K, -1))
        pair_sim = bank_norm @ bank_norm.t()
        pair_sim = torch.where(eye | ~(valid[None, :] & valid[:, None]), neg_inf, pair_sim)
        new_sim = bank_norm @ new_norm.to(bank_norm.dtype)
        new_sim_masked = torch.where(valid, new_sim, -neg_inf)
        # tensor indices stay on the device (index_select / gather, never
        # a 0-dim tensor as a Python index, which would sync)
        min_idx = torch.argmin(new_sim_masked).reshape(1)
        row = pair_sim.index_select(0, min_idx)[0]
        max_idx = torch.argmax(row).reshape(1)
        should_replace = ((new_sim_masked.gather(0, min_idx) < row.gather(0, max_idx))
                          & (iou > bank["iou"].gather(0, max_idx) - 0.1))[0]
        # append while in (pre-batch) append mode, else the replacement
        # target if allowed; the count is capped by the K slots
        slot = torch.where(append_mode, torch.clamp(count, max=K - 1), max_idx[0]).reshape(1)
        do_write = (append_mode & (count < K)) | (~append_mode & should_replace)
        for key, new in (("feats", new_feat), ("iou", iou), ("embeds", embeds[i]),
                         ("valid", torch.ones((), dtype=torch.bool, device=dev))):
            old = bank[key].index_select(0, slot)
            bank[key].index_copy_(0, slot, torch.where(do_write, new.to(old.dtype)[None], old))
    return bank
