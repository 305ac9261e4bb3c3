"""Work that one call of folded volume propagation needs: FLOPs and bytes
by layer, from the frozen counts in :mod:`portbench.counts.flops`.

A call streams ``V`` volumes of ``T`` slices, one object each, with a box on
slice 0: slice 0 is the conditioning frame (encoder, heads, memory encoder),
slices 1..T-1 are tracked (encoder, memory attention, heads, memory
encoder). The memory attention of slice t reads the memories that exist:
the conditioning frame and min(t - 1, num_maskmem - 1) earlier slices, and
1 + min(t - 1, min(T, max_obj_ptrs) - 1) object pointers of
hidden_dim / mem_dim tokens each; the frozen count assumes a full bank,
which these inputs never need. Each memory's keys are projected once, when
it is written (the frozen count projects every key at every slice); the
pointer keys are projected at every slice.
"""

from __future__ import annotations

from portbench.counts import flops as F

ACT_BYTES = 2      # bf16 activations
PARAM_BYTES = 4    # float32 parameters


def memory_tokens(a, t: int, T: int):
    """(spatial memory frames, object pointers) read at tracked slice t >= 1."""
    frames = 1 + min(t - 1, a.num_maskmem - 1)
    ptrs = 1 + min(t - 1, min(T, a.max_obj_ptrs_in_encoder) - 1)
    return frames, ptrs


def _spatial(a):
    s = a.sam_image_embedding_size
    return s * s


def key_projection_flops(a, n_tokens: int) -> float:
    ma = a.memory_attention
    return ma.num_layers * 2.0 * n_tokens * ma.kv_in_dim * ma.d_model


def memory_attention_flops(a, t: int, T: int) -> float:
    """One object at tracked slice t, its spatial keys already projected."""
    frames, ptrs = memory_tokens(a, t, T)
    P = _spatial(a)
    n_ptr = ptrs * (a.hidden_dim // a.mem_dim)
    return (F._memory_attention_flops(a, frames * P + n_ptr)
            - key_projection_flops(a, frames * P))


def encoder_flops(a) -> float:
    """Trunk and the FPN's lateral convolutions, one image (the decoder's
    high-res projections, which the frozen neck count includes, run outside
    the encoder)."""
    s = a.sam_image_embedding_size
    d = a.neck.d_model
    skip = 2.0 * (s * 4) ** 2 * d * (d // 8) + 2.0 * (s * 2) ** 2 * d * (d // 4)
    return F._hiera_flops(a) + F._neck_flops(a) - skip


def call_flops(a, V: int, T: int) -> dict:
    """FLOPs of one call by layer, and their total."""
    enc_all = F._hiera_flops(a) + F._neck_flops(a)
    per_slice = F._sam_heads_flops(a) + F._memory_encoder_flops(a) + key_projection_flops(
        a, _spatial(a))
    mem_attn = sum(memory_attention_flops(a, t, T) for t in range(1, T))
    out = {
        "image_encoder": V * T * encoder_flops(a),
        "memory_attention": V * mem_attn,
        "total": V * (T * (enc_all + per_slice) + mem_attn),
    }
    return out


def _param_bytes(weights, prefix: str) -> float:
    return float(sum(t.numel() for k, t in weights.items() if k.startswith(prefix))) * PARAM_BYTES


def call_bytes(a, weights, V: int, T: int) -> dict:
    """Bytes that one call's encoder and memory-attention invocations must
    move at least: each input, weight and output once per invocation (one
    invocation serves the V folded rows of a slice)."""
    S = a.image_size
    s = a.sam_image_embedding_size
    d = a.neck.d_model
    P = s * s
    ma = a.memory_attention
    # encoder: the fp32 frames in, its weights, the four FPN levels out
    fpn_out = sum((s * 2 ** k) ** 2 for k in (-1, 0, 1, 2)) * d * ACT_BYTES
    enc = T * (V * S * S * 3 * 4 + _param_bytes(weights, "image_encoder.") + V * fpn_out)
    # memory attention: queries and their positions in, the cached keys and
    # raw values of the memory and pointer tokens, its weights, the output
    mem = 0.0
    w_mem = _param_bytes(weights, "memory_attention.")
    for t in range(1, T):
        frames, ptrs = memory_tokens(a, t, T)
        n_ptr = ptrs * (a.hidden_dim // a.mem_dim)
        keys = (frames * P * ma.num_layers * ma.d_model + n_ptr * a.mem_dim) * ACT_BYTES
        values = (frames * P + n_ptr) * a.mem_dim * ACT_BYTES
        mem += w_mem + V * (3 * P * d * ACT_BYTES + keys + values)
    return {"image_encoder": enc, "memory_attention": mem}
