"""Projection attention, RoPE attention and the two-way transformer
(counterpart of ``medsam2_tpu/core/transformer.py``).

RoPE layout: as in the JAX package, the interleaved RoPE pairs are folded
into a per-head even-then-odd permutation of the q/k projection's output
channels (a shared permutation of q and k leaves QK^T unchanged), so rotations
act on contiguous halves and the bank's roped-key cache holds exactly the
JAX package's values.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.pos_enc import apply_rope_half, axial_rope_cos_sin
from medsam2_tpu_torch.ops.attention import attention, kv_cached_attention


class Attention(nn.Module):
    """q/k/v/out projections (``transformer.py:199-263``)."""

    def __init__(self, embedding_dim: int, num_heads: int, gen: torch.Generator,
                 downsample_rate: int = 1, kv_in_dim: Optional[int] = None):
        super().__init__()
        internal = embedding_dim // downsample_rate
        kv_in = kv_in_dim if kv_in_dim is not None else embedding_dim
        self.num_heads = num_heads
        self.q_proj = layers.Linear(embedding_dim, internal, gen)
        self.k_proj = layers.Linear(kv_in, internal, gen)
        self.v_proj = layers.Linear(kv_in, internal, gen)
        self.out_proj = layers.Linear(internal, embedding_dim, gen)

    def forward(self, q, k, v):
        """q [B, Nq, Cq], k/v [B, Nk, Ckv] -> [B, Nq, Cq]."""
        h = self.num_heads
        out = attention(_split_heads(self.q_proj(q), h), _split_heads(self.k_proj(k), h),
                        _split_heads(self.v_proj(v), h))
        return self.out_proj(_merge_heads(out))


def _split_heads(x, num_heads: int):
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x):
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


@functools.lru_cache(maxsize=16)
def _rope_half_perm(C: int, num_heads: int, device: torch.device) -> torch.Tensor:
    """Per-head even-then-odd channel permutation, kept on ``device``."""
    hd = C // num_heads
    base = np.concatenate([np.arange(0, hd, 2), np.arange(1, hd, 2)])
    perm = np.concatenate([h * hd + base for h in range(num_heads)])
    return torch.from_numpy(perm).to(device)


def _perm(lin: layers.Linear, num_heads: int):
    return _rope_half_perm(lin.weight.shape[0], num_heads, lin.weight.device)


def _linear_perm(lin: layers.Linear, x, perm, with_bias: bool = True):
    """``lin(x)`` with output channels permuted, folded into the weight rows."""
    bias = lin.bias[perm] if (with_bias and lin.bias is not None) else None
    return layers.linear(x, lin.weight[perm], bias)


def roped_k_for_tokens(attn: Attention, tokens, q_hw: Tuple[int, int],
                       rope_theta: float = 10000.0, with_bias: bool = False):
    """Project one memory frame's ``tokens`` [B, P, Dkv] through the permuted
    k projection and rotate by the within-frame axial RoPE. Returns
    [B, P, C_int] in half-split layout. RoPE is linear, so the bank caches the
    memory part (``with_bias=False``) at write time and the positional part
    (``with_bias=True``) once per session."""
    h = attn.num_heads
    kp = _linear_perm(attn.k_proj, tokens, _perm(attn.k_proj, h), with_bias)
    B, P, C_int = kp.shape
    hd = C_int // h
    kp = kp.reshape(B, P, h, hd).transpose(1, 2)
    cos, sin = axial_rope_cos_sin(hd, q_hw[0], q_hw[1], rope_theta, device=kp.device)
    kp = apply_rope_half(kp, cos, sin)
    return kp.transpose(1, 2).reshape(B, P, C_int)


def rope_attn_storage(attn: Attention, q, bundle: dict, layer: int, *,
                      q_hw: Tuple[int, int], rope_theta: float = 10000.0):
    """Memory cross-attention against the bank's roped-key cache in storage
    order (``transformer.rope_attn_storage``): single kv head, low-rank
    values — the raw 64-wide memory features are the values and the v
    projection is applied to the short output.

    ``bundle``: kcache [B, F, L, P, C], pos_rows [Rr, L, P, C], row_of_slot
    [F], v_slots [B, F, P, Dv], ptr_tokens / ptr_pos [B, Nptr, Dv], kv_mask
    [B, F*P + Nptr]."""
    if attn.num_heads != 1:
        raise NotImplementedError("storage-order kv cache assumes 1 kv head")
    C_int = attn.q_proj.weight.shape[0]
    if attn.v_proj.weight.shape[1] >= C_int:
        raise NotImplementedError("storage-order kv cache assumes low-rank values")
    perm = _perm(attn.q_proj, 1)
    qp = _linear_perm(attn.q_proj, q, perm)                    # [B, Nq, C]
    cos, sin = axial_rope_cos_sin(C_int, q_hw[0], q_hw[1], rope_theta, device=q.device)
    qp = apply_rope_half(qp, cos, sin)
    ptr_in = bundle["ptr_tokens"] + bundle["ptr_pos"]
    ptr_k = _linear_perm(attn.k_proj, ptr_in.to(q.dtype), perm)
    out = kv_cached_attention(
        qp, bundle["kcache"], bundle["pos_rows"], bundle["row_of_slot"], ptr_k,
        bundle["v_slots"], bundle["ptr_tokens"].to(q.dtype), bundle["kv_mask"], layer)
    return attn.out_proj(attn.v_proj(out))


def rope_attn_apply(attn: Attention, q, k, v, *, q_hw: Tuple[int, int],
                    rope_theta: float = 10000.0, rope_k_repeat: bool = False,
                    num_k_exclude_rope: int = 0, kv_mask=None, k_cached=None):
    """RoPE attention (``transformer.py:266-331``): the memory
    self-attention, and the read-order memory cross-attention over raw
    memory tokens or over the roped-key cache.

    ``q_hw`` is the (w, h) grid of the query tokens. The last
    ``num_k_exclude_rope`` keys (object pointers) skip the rotation; with
    ``rope_k_repeat`` the q-grid tables tile once per memory frame over the
    other keys. ``k_cached`` [B, Nc, C_int]: the spatial keys already
    projected and rotated (the bank's roped-key cache in read order); ``k``
    then holds only the pointer keys that follow them, which are projected
    here and not rotated. Low-rank value path: when the raw kv width (64
    memory channels) is below the head dim, the raw tokens are the values
    and the v projection is applied to the output, exactly (P (v W) =
    (P v) W, and the bias commutes because masked-softmax rows sum to 1);
    the cross-attention flash call is then D = 256 / Dv = 64."""
    h = attn.num_heads
    perm = _perm(attn.q_proj, h)
    qp = _split_heads(_linear_perm(attn.q_proj, q, perm), h)
    kp = _linear_perm(attn.k_proj, k, perm)
    if k_cached is not None:
        kp = torch.cat([k_cached.to(q.dtype), kp], dim=1)
    kp = _split_heads(kp, h)
    head_dim = qp.shape[-1]
    v_in = attn.v_proj.weight.shape[1]
    factor_v = v_in < head_dim
    if factor_v:
        vp = v[:, None].expand(v.shape[0], h, v.shape[1], v_in)
    else:
        vp = _split_heads(attn.v_proj(v), h)
    cos, sin = axial_rope_cos_sin(head_dim, q_hw[0], q_hw[1], rope_theta, device=q.device)
    qp = apply_rope_half(qp, cos, sin)
    num_k_rope = kp.shape[2] - num_k_exclude_rope
    if k_cached is None and num_k_rope > 0:
        repeat = num_k_rope // qp.shape[2] if rope_k_repeat else 1
        if repeat > 1:
            cos_k, sin_k = cos.repeat(repeat, 1), sin.repeat(repeat, 1)
        else:
            # a memory shorter than one frame (the single no-mem token) takes
            # the first rows: attention over one key returns its value
            # whatever its rotation, as the JAX package's broadcast does
            cos_k, sin_k = cos[:num_k_rope], sin[:num_k_rope]
        k_rot = apply_rope_half(kp[:, :, :num_k_rope], cos_k, sin_k)
        kp = torch.cat([k_rot, kp[:, :, num_k_rope:]], dim=2) if num_k_exclude_rope else k_rot
    out = attention(qp, kp, vp, kv_mask=kv_mask)
    if factor_v:
        wv = attn.v_proj.weight.reshape(h, head_dim, v_in).to(out.dtype)
        out = torch.einsum("bhqe,hde->bhqd", out, wv)
        if attn.v_proj.bias is not None:
            out = out + attn.v_proj.bias.reshape(h, head_dim)[None, :, None, :].to(out.dtype)
    return attn.out_proj(_merge_heads(out))


# ---------------------------------------------------------------------------
# TwoWayTransformer (transformer.py:28-196)
# ---------------------------------------------------------------------------


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, gen: torch.Generator,
                 downsample_rate: int = 2, skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = Attention(dim, num_heads, gen)
        self.norm1 = layers.LayerNorm(dim)
        self.cross_attn_token_to_image = Attention(dim, num_heads, gen, downsample_rate)
        self.norm2 = layers.LayerNorm(dim)
        self.mlp = layers.MLP(dim, mlp_dim, dim, 2, gen)
        self.norm3 = layers.LayerNorm(dim)
        self.norm4 = layers.LayerNorm(dim)
        self.cross_attn_image_to_token = Attention(dim, num_heads, gen, downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int,
                 gen: torch.Generator, downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, num_heads, mlp_dim, gen, downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = Attention(dim, num_heads, gen, downsample_rate)
        self.norm_final_attn = layers.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe [B, H, W, C]; point_embedding [B, N, C]
        -> (queries [B, N, C], keys [B, HW, C])."""
        B, H, W, C = image_embedding.shape
        keys = image_embedding.reshape(B, H * W, C)
        key_pe = image_pe.reshape(B, H * W, C).to(keys.dtype)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
