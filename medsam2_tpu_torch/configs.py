"""Model configuration for the port (counterpart of ``medsam2_tpu/configs.py``).

The same frozen dataclasses, fields and defaults as the JAX package, so the
port imports nothing of the JAX package and runs where it is absent. The
fields define checkpoint compatibility with the released SAM2 weights
(``sam2_train/sam2_hiera_t.yaml``). ``tests/test_torch_convert.py`` holds the
two packages' configs equal field for field; the port's modules read only
attributes, so they also take a config object of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    """Hiera trunk (reference ``modeling/backbones/hieradet.py:176-201``)."""

    embed_dim: int = 96
    num_heads: int = 1  # initial number of heads
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    q_pool: int = 3  # number of q_pool stages
    q_stride: Tuple[int, int] = (2, 2)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    mlp_ratio: float = 4.0
    patch_kernel: Tuple[int, int] = (7, 7)
    patch_stride: Tuple[int, int] = (4, 4)
    patch_padding: Tuple[int, int] = (3, 3)
    drop_path_rate: float = 0.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        return tuple(sum(self.stages[: i + 1]) - 1 for i in range(len(self.stages)))

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(x + 1 for x in self.stage_ends[:-1])[: self.q_pool]

    def block_schedule(self):
        """Per-block (dim, dim_out, num_heads, window_size, q_stride), as the
        constructor loop at ``hieradet.py:233-261`` builds it: the window size
        lags by one block at stage transitions."""
        out = []
        embed_dim, num_heads = self.embed_dim, self.num_heads
        cur_stage = 1
        for i in range(self.depth):
            dim_out = embed_dim
            window_size = self.window_spec[cur_stage - 1]
            if i in self.global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(embed_dim * self.dim_mul)
                num_heads = int(num_heads * self.head_mul)
                cur_stage += 1
            out.append(dict(dim=embed_dim, dim_out=dim_out, num_heads=num_heads,
                            window_size=window_size,
                            q_stride=self.q_stride if i in self.q_pool_blocks else None))
            embed_dim = dim_out
        return out

    @property
    def channel_list(self) -> Tuple[int, ...]:
        """Per-stage output dims, lowest resolution first (``hieradet.py:263-267``)."""
        sched = self.block_schedule()
        return tuple(sched[i]["dim_out"] for i in self.stage_ends[::-1])


@dataclasses.dataclass(frozen=True)
class FpnNeckConfig:
    """FPN neck (reference ``modeling/backbones/image_encoder.py:45-99``)."""

    d_model: int = 256
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    kernel_size: int = 1
    stride: int = 1
    padding: int = 0
    fpn_interp_model: str = "nearest"
    fuse_type: str = "sum"
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    num_pos_feats: int = 256  # PositionEmbeddingSine width


@dataclasses.dataclass(frozen=True)
class MemoryAttentionConfig:
    """Memory attention stack (reference yaml ``memory_attention``)."""

    d_model: int = 256
    num_layers: int = 4
    dim_feedforward: int = 2048
    dropout: float = 0.1
    activation: str = "relu"
    pos_enc_at_input: bool = True
    pos_enc_at_attn: bool = False
    pos_enc_at_cross_attn_keys: bool = True
    pos_enc_at_cross_attn_queries: bool = False
    rope_theta: float = 10000.0
    rope_feat_sizes: Tuple[int, int] = (32, 32)
    self_attn_num_heads: int = 1
    cross_attn_num_heads: int = 1
    kv_in_dim: int = 64  # memory channels fed to the cross-attention k/v projections


@dataclasses.dataclass(frozen=True)
class MemoryEncoderConfig:
    """Memory encoder (reference yaml ``memory_encoder``)."""

    out_dim: int = 64
    in_dim: int = 256
    mask_downsampler_kernel: int = 3
    mask_downsampler_stride: int = 2
    mask_downsampler_padding: int = 1
    mask_downsampler_total_stride: int = 16
    fuser_num_layers: int = 2
    fuser_kernel_size: int = 7
    fuser_padding: int = 3
    fuser_layer_scale_init: float = 1e-6
    num_pos_feats: int = 64


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    """Full SAM2 model (reference ``SAM2Base.__init__``, ``sam2_base.py:23-94``)."""

    trunk: HieraConfig = HieraConfig()
    neck: FpnNeckConfig = FpnNeckConfig()
    memory_attention: MemoryAttentionConfig = MemoryAttentionConfig()
    memory_encoder: MemoryEncoderConfig = MemoryEncoderConfig()

    scalp: int = 1
    image_size: int = 1024
    backbone_stride: int = 16
    num_maskmem: int = 7
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = False
    use_mask_input_as_output_without_sam: bool = True
    max_cond_frames_in_attn: int = -1
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    memory_temporal_stride_for_eval: int = 1
    add_all_frames_to_correct_as_cond: bool = False
    non_overlap_masks_for_mem_enc: bool = False
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = False
    proj_tpos_enc_in_obj_ptrs: bool = False
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    twoway_depth: int = 2
    twoway_mlp_dim: int = 2048
    twoway_num_heads: int = 8
    attention_downsample_rate: int = 2
    mask_in_chans: int = 16
    # dense prompt embeddings force-resized to this spatial size when set (the
    # fork's nuclei-crop behaviour); None keeps them at image_size / 16
    dense_embed_size: Optional[int] = None
    # cap on sparse prompt points fed to the prompt encoder (padded with -1 labels)
    max_prompt_points: int = 8
    # compute dtype of the hot path ("bfloat16" or "float32"); parameters stay fp32
    compute_dtype: str = "bfloat16"

    @property
    def hidden_dim(self) -> int:
        return self.memory_attention.d_model

    @property
    def mem_dim(self) -> int:
        return self.memory_encoder.out_dim

    @property
    def num_feature_levels(self) -> int:
        return 3 if self.use_high_res_features_in_sam else 1

    @property
    def sam_image_embedding_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def low_res_mask_size(self) -> int:
        return 4 * self.sam_image_embedding_size


def sam2_hiera_t(**overrides) -> SAM2Config:
    """sam2_hiera_t preset (``sam2_train/sam2_hiera_t.yaml:9-15``)."""
    trunk = HieraConfig(stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9))
    return SAM2Config(trunk=trunk, **overrides)


def sam2_hiera_s(**overrides) -> SAM2Config:
    """sam2_hiera_s preset (``sam2_train/sam2_hiera_s.yaml:9-15``)."""
    trunk = HieraConfig(stages=(1, 2, 11, 2), global_att_blocks=(7, 10, 13))
    return SAM2Config(trunk=trunk, **overrides)


def sam2_hiera_b_plus(**overrides) -> SAM2Config:
    """sam2_hiera_b+ preset (upstream SAM2 family; embed_dim 112, heads 2)."""
    trunk = HieraConfig(
        embed_dim=112, num_heads=2, stages=(2, 3, 16, 3), global_att_blocks=(12, 16, 20)
    )
    neck = FpnNeckConfig(backbone_channel_list=(896, 448, 224, 112))
    return SAM2Config(trunk=trunk, neck=neck, **overrides)


def sam2_hiera_l(**overrides) -> SAM2Config:
    """sam2_hiera_l preset (upstream SAM2 family; embed_dim 144, heads 2)."""
    trunk = HieraConfig(
        embed_dim=144,
        num_heads=2,
        stages=(2, 6, 36, 4),
        global_att_blocks=(23, 33, 43),
        window_spec=(8, 4, 16, 8),
    )
    neck = FpnNeckConfig(backbone_channel_list=(1152, 576, 288, 144))
    return SAM2Config(trunk=trunk, neck=neck, **overrides)


def nuclei_256(**overrides) -> SAM2Config:
    """The fork's 256-px nuclei-crop recipe: 256 input, dense embeds forced to 16x16
    (``sam2_base.py:159-160``, ``prompt_encoder.py:190``, ``func_2d/function.py:44``)."""
    cfg = dict(image_size=256, dense_embed_size=16)
    cfg.update(overrides)
    return sam2_hiera_s(**cfg)


PRESETS = {
    "sam2_hiera_t": sam2_hiera_t,
    "sam2_hiera_s": sam2_hiera_s,
    "sam2_hiera_b+": sam2_hiera_b_plus,
    "sam2_hiera_l": sam2_hiera_l,
    "nuclei_256": nuclei_256,
}


def get_config(name: str, **overrides) -> SAM2Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](**overrides)
