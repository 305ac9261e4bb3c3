"""Analytic FLOP counts of the video-propagation pipeline, per component
(counterpart of ``medsam2_tpu/utils/flops.py``): the JAX package's counts,
copied as they are. The reference publishes wall clock only
(``sam2_train/sam2_video_predictor.py:60-62``). Convention: 1 MAC = 2
FLOPs; elementwise and norm ops are ignored (<1% of total). A counting mode
such as ``torch.utils.flop_counter.FlopCounterMode`` bills nothing for the
port's hand-written kernels, which is why the counts are analytic; the
benchmark's MFU and rooflines use its own frozen copy (``portbench/counts``).
"""

from __future__ import annotations


def _hiera_flops(cfg) -> float:
    """Hiera trunk for ONE image (``hieradet.py:176-261`` arithmetic)."""
    t = cfg.trunk
    H = W = cfg.image_size // t.patch_stride[0]
    # patch embed as lowered (space-to-depth 2x2 conv over 8x8x3 blocks)
    f = 2.0 * H * W * t.embed_dim * (8 * 8 * 3)
    for spec in t.block_schedule():
        d_in, d_out = spec["dim"], spec["dim_out"]
        heads, ws, qs = spec["num_heads"], spec["window_size"], spec["q_stride"]
        N = H * W
        f += 2.0 * N * d_in * 3 * d_out                     # fused qkv
        if qs is not None:
            Hq, Wq = H // qs[0], W // qs[1]
        else:
            Hq, Wq = H, W
        Nq = Hq * Wq
        if ws > 0:
            k_seq = ws * ws
            q_seq = k_seq // (qs[0] * qs[1]) if qs is not None else k_seq
            n_win = max(N // k_seq, 1)
            f += 2.0 * 2.0 * n_win * q_seq * k_seq * d_out  # windowed QK^T + PV
        else:
            f += 2.0 * 2.0 * Nq * N * d_out                 # global attention
        f += 2.0 * Nq * d_out * d_out                       # out proj
        if d_in != d_out:
            f += 2.0 * N * d_in * d_out                     # shortcut proj
        f += 2.0 * 2.0 * Nq * d_out * int(d_out * t.mlp_ratio)  # MLP
        H, W = Hq, Wq
    return f


def _neck_flops(cfg) -> float:
    """FPN 1x1 lateral convs + the decoder's high-res skip projections."""
    s = cfg.image_size // cfg.backbone_stride   # stride-16 grid
    d = cfg.neck.d_model
    f = 0.0
    # lateral convs at strides 32,16,8,4 with trunk channels (reversed list)
    res = [s // 2, s, s * 2, s * 4]
    for r, c in zip(res, cfg.neck.backbone_channel_list):
        f += 2.0 * r * r * c * d
    # conv_s0 (stride-4, d->32), conv_s1 (stride-8, d->64)
    f += 2.0 * (s * 4) ** 2 * d * (d // 8)
    f += 2.0 * (s * 2) ** 2 * d * (d // 4)
    return f


def _memory_attention_flops(cfg, total_kv_tokens: int) -> float:
    """All layers, ONE object, ONE frame."""
    ma = cfg.memory_attention
    s = cfg.image_size // cfg.backbone_stride
    Nq = s * s
    Nk = total_kv_tokens
    d = ma.d_model
    f = 0.0
    kv = ma.kv_in_dim
    # the low-rank value path is taken only when kv_in < cross head dim
    # (core/transformer.py rope_attn_apply factor_v condition)
    factored = kv < d // ma.cross_attn_num_heads
    if factored:
        cross_v = (2.0 * Nq * Nk * kv        # cross PV on raw kv-dim values
                   + 2.0 * Nq * kv * d)      # value projection on the output
    else:
        cross_v = (2.0 * Nq * Nk * d         # cross PV at full width
                   + 2.0 * Nk * kv * d)      # v projection on the long kv
    per_layer = (
        4 * 2.0 * Nq * d * d                 # self-attn q,k,v,out projections
        + 2.0 * 2.0 * Nq * Nq * d            # self-attn QK^T + PV
        + 2 * 2.0 * Nq * d * d               # cross q + out projections
        + 2.0 * Nk * kv * d                  # cross k projection (64 -> 256)
        + 2.0 * Nq * Nk * d                  # cross QK^T
        + cross_v
        + 2 * 2.0 * Nq * d * ma.dim_feedforward  # FFN
    )
    return f + ma.num_layers * per_layer


def _sam_heads_flops(cfg) -> float:
    """Two-way decoder + upscaling + obj ptr, ONE object."""
    s = cfg.image_size // cfg.backbone_stride
    N = s * s
    d = cfg.hidden_dim
    di = d // cfg.attention_downsample_rate    # internal attn dim (128)
    nt = cfg.num_multimask_outputs + 2 + (1 if cfg.pred_obj_scores else 0)
    f = 0.0
    for _ in range(cfg.twoway_depth):
        f += 2.0 * N * d * di * 2 * 2          # image-side k,v projections (both cross dirs)
        f += 2.0 * 2.0 * nt * N * di * 2       # token<->image attention both ways
        f += 2.0 * N * di * d                  # image-side out proj (i2t writes back to image)
        f += 2.0 * 2.0 * nt * d * cfg.twoway_mlp_dim  # token MLP (tiny)
    f += 2.0 * N * d * di * 2                  # final token->image k,v
    # output upscaling: deconv d->d/4 at (2s)^2 (k=2,s=2), deconv d/4->d/8 at (4s)^2
    f += 2.0 * N * (2 * 2 * d * (d // 4))
    f += 2.0 * (2 * s) ** 2 * (2 * 2 * (d // 4) * (d // 8))
    # mask tokens @ upscaled embedding
    f += 2.0 * (4 * s) ** 2 * (d // 8) * (cfg.num_multimask_outputs + 1)
    return f


def _memory_encoder_flops(cfg) -> float:
    """Mask downsampler + fuser, ONE object."""
    me = cfg.memory_encoder
    S = cfg.image_size
    s = S // me.mask_downsampler_total_stride
    k2 = me.mask_downsampler_kernel ** 2
    f = 0.0
    c_in, r = 1, S
    while r > s:
        r //= me.mask_downsampler_stride
        c_out = c_in * me.mask_downsampler_stride ** 2
        f += 2.0 * r * r * c_out * k2 * c_in
        c_in = c_out
    f += 2.0 * s * s * c_in * me.in_dim          # mask out proj
    f += 2.0 * s * s * me.in_dim * me.in_dim     # pix feat proj
    for _ in range(me.fuser_num_layers):
        f += 2.0 * s * s * me.in_dim * me.fuser_kernel_size ** 2   # dwconv
        f += 2 * 2.0 * s * s * me.in_dim * 4 * me.in_dim           # pwconvs
    if me.out_dim != me.in_dim:
        f += 2.0 * s * s * me.in_dim * me.out_dim
    return f


def propagation_flops(cfg, spec, num_objects: int = 1) -> dict:
    """Per-frame FLOPs of the tracking pipeline, by component.

    ``spec``: a ``state.memory_bank.BankSpec`` (sets the memory-attention kv
    span: its spatial and pointer tokens). The encoder runs once per frame; the per-object stages scale with
    ``num_objects``."""
    enc = _hiera_flops(cfg) + _neck_flops(cfg)
    total_tokens = spec.num_spatial_tokens + spec.num_ptr_tokens
    mem_attn = _memory_attention_flops(cfg, total_tokens) * num_objects
    heads = _sam_heads_flops(cfg) * num_objects
    mem_enc = _memory_encoder_flops(cfg) * num_objects
    return {
        "encoder": enc,
        "memory_attention": mem_attn,
        "sam_heads": heads,
        "memory_encoder": mem_enc,
        "total": enc + mem_attn + heads + mem_enc,
    }
