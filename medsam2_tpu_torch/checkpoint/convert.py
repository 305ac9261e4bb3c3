"""Weights into the port: reference-keyed state dicts.

The port's modules carry the reference's (PyTorch SAM2) parameter names and
layouts, so a reference state dict loads with ``strict=True``:

- :func:`state_dict_from_jax` turns the JAX package's parameter tree (numpy
  leaves, e.g. ``jax.tree_util.tree_map(np.asarray, sam2_init(...))``) into
  that state dict. It re-implements, in numpy, the mapping of
  ``medsam2_tpu.checkpoint.convert.export_state_dict``.
- :func:`prompter_state_dict_from_jax` does the same for the JAX package's
  DPA-P2PNet prompter tree, onto the port's
  :class:`~medsam2_tpu_torch.prompter.dpa_p2pnet.Prompter`.
- :func:`load_reference_state_dict` loads such a dict, or a released ``.pt``
  checkpoint's ``model`` dict, into a :class:`SAM2Model` (or a prompter).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from medsam2_tpu_torch.configs import SAM2Config


def state_dict_from_jax(params, cfg: SAM2Config) -> Dict[str, np.ndarray]:
    """Reference-named flat state dict (numpy values) from a JAX parameter
    tree with numpy leaves. Linear [in, out] -> [out, in]; conv HWIO -> OIHW;
    conv-transpose (kh, kw, out, in) -> (in, out, kh, kw); LayerNorm
    scale/bias -> weight/bias; channels-last position tables -> [1, C, h, w]."""
    sd: Dict[str, np.ndarray] = {}

    def linear(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[prefix + ".bias"] = np.asarray(p["b"])

    def conv(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        if "b" in p:
            sd[prefix + ".bias"] = np.asarray(p["b"])

    def ln(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["scale"])
        sd[prefix + ".bias"] = np.asarray(p["bias"])

    def embed(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["w"])

    def mlp(prefix, p):
        for i, lp in enumerate(p["layers"]):
            linear(f"{prefix}.layers.{i}", lp)

    def attn(prefix, p):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{prefix}.{n}", p[n])

    trunk = params["image_encoder"]["trunk"]
    conv("image_encoder.trunk.patch_embed.proj", trunk["patch_embed"]["proj"])
    sd["image_encoder.trunk.pos_embed"] = np.asarray(trunk["pos_embed"]).transpose(2, 0, 1)[None]
    sd["image_encoder.trunk.pos_embed_window"] = (
        np.asarray(trunk["pos_embed_window"]).transpose(2, 0, 1)[None])
    for i, bp in enumerate(trunk["blocks"]):
        pfx = f"image_encoder.trunk.blocks.{i}"
        ln(pfx + ".norm1", bp["norm1"])
        linear(pfx + ".attn.qkv", bp["attn"]["qkv"])
        linear(pfx + ".attn.proj", bp["attn"]["proj"])
        ln(pfx + ".norm2", bp["norm2"])
        mlp(pfx + ".mlp", bp["mlp"])
        if "proj" in bp:
            linear(pfx + ".proj", bp["proj"])
    for i, cp in enumerate(params["image_encoder"]["neck"]["convs"]):
        conv(f"image_encoder.neck.convs.{i}.conv", cp)

    pe = params["sam_prompt_encoder"]
    sd["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = (
        np.asarray(pe["pe_layer"]["gaussian_matrix"]))
    for i, p in enumerate(pe["point_embeddings"]):
        embed(f"sam_prompt_encoder.point_embeddings.{i}", p)
    embed("sam_prompt_encoder.not_a_point_embed", pe["not_a_point_embed"])
    embed("sam_prompt_encoder.no_mask_embed", pe["no_mask_embed"])
    mdn = pe["mask_downscaling"]
    conv("sam_prompt_encoder.mask_downscaling.0", mdn["conv1"])
    ln("sam_prompt_encoder.mask_downscaling.1", mdn["ln1"])
    conv("sam_prompt_encoder.mask_downscaling.3", mdn["conv2"])
    ln("sam_prompt_encoder.mask_downscaling.4", mdn["ln2"])
    conv("sam_prompt_encoder.mask_downscaling.6", mdn["conv3"])

    dec = params["sam_mask_decoder"]
    tf = dec["transformer"]
    for i, lp in enumerate(tf["layers"]):
        pfx = f"sam_mask_decoder.transformer.layers.{i}"
        attn(pfx + ".self_attn", lp["self_attn"])
        ln(pfx + ".norm1", lp["norm1"])
        attn(pfx + ".cross_attn_token_to_image", lp["cross_attn_token_to_image"])
        ln(pfx + ".norm2", lp["norm2"])
        mlp(pfx + ".mlp", lp["mlp"])
        ln(pfx + ".norm3", lp["norm3"])
        ln(pfx + ".norm4", lp["norm4"])
        attn(pfx + ".cross_attn_image_to_token", lp["cross_attn_image_to_token"])
    attn("sam_mask_decoder.transformer.final_attn_token_to_image",
         tf["final_attn_token_to_image"])
    ln("sam_mask_decoder.transformer.norm_final_attn", tf["norm_final_attn"])
    embed("sam_mask_decoder.iou_token", dec["iou_token"])
    embed("sam_mask_decoder.mask_tokens", dec["mask_tokens"])
    conv("sam_mask_decoder.output_upscaling.0", dec["output_upscaling"]["dc1"])
    ln("sam_mask_decoder.output_upscaling.1", dec["output_upscaling"]["ln"])
    conv("sam_mask_decoder.output_upscaling.3", dec["output_upscaling"]["dc2"])
    for i, mp in enumerate(dec["output_hypernetworks_mlps"]):
        mlp(f"sam_mask_decoder.output_hypernetworks_mlps.{i}", mp)
    mlp("sam_mask_decoder.iou_prediction_head", dec["iou_prediction_head"])
    if cfg.use_high_res_features_in_sam:
        conv("sam_mask_decoder.conv_s0", dec["conv_s0"])
        conv("sam_mask_decoder.conv_s1", dec["conv_s1"])
    if cfg.pred_obj_scores:
        embed("sam_mask_decoder.obj_score_token", dec["obj_score_token"])
        if cfg.pred_obj_scores_mlp:
            mlp("sam_mask_decoder.pred_obj_score_head", dec["pred_obj_score_head"])
        else:
            linear("sam_mask_decoder.pred_obj_score_head", dec["pred_obj_score_head"])

    for i, lp in enumerate(params["memory_attention"]["layers"]):
        pfx = f"memory_attention.layers.{i}"
        attn(pfx + ".self_attn", lp["self_attn"])
        attn(pfx + ".cross_attn_image", lp["cross_attn_image"])
        linear(pfx + ".linear1", lp["linear1"])
        linear(pfx + ".linear2", lp["linear2"])
        ln(pfx + ".norm1", lp["norm1"])
        ln(pfx + ".norm2", lp["norm2"])
        ln(pfx + ".norm3", lp["norm3"])
    ln("memory_attention.norm", params["memory_attention"]["norm"])

    me = params["memory_encoder"]
    n_ds = len(me["mask_downsampler"])
    for i, lp in enumerate(me["mask_downsampler"]):
        conv(f"memory_encoder.mask_downsampler.encoder.{3 * i}", lp["conv"])
        ln(f"memory_encoder.mask_downsampler.encoder.{3 * i + 1}", lp["ln"])
    conv(f"memory_encoder.mask_downsampler.encoder.{3 * n_ds}", me["mask_out_proj"])
    conv("memory_encoder.pix_feat_proj", me["pix_feat_proj"])
    for i, fp in enumerate(me["fuser"]):
        pfx = f"memory_encoder.fuser.layers.{i}"
        conv(pfx + ".dwconv", fp["dwconv"])
        ln(pfx + ".norm", fp["norm"])
        linear(pfx + ".pwconv1", fp["pwconv1"])
        linear(pfx + ".pwconv2", fp["pwconv2"])
        sd[pfx + ".gamma"] = np.asarray(fp["gamma"])
    if "out_proj" in me:
        conv("memory_encoder.out_proj", me["out_proj"])

    sd["maskmem_tpos_enc"] = np.asarray(params["maskmem_tpos_enc"])[:, None, None, :]
    sd["no_mem_embed"] = np.asarray(params["no_mem_embed"])
    sd["no_mem_pos_enc"] = np.asarray(params["no_mem_pos_enc"])
    if cfg.use_obj_ptrs_in_encoder:
        conv("mask_downsample", params["mask_downsample"])
        if cfg.use_mlp_for_obj_ptr_proj:
            mlp("obj_ptr_proj", params["obj_ptr_proj"])
        else:
            linear("obj_ptr_proj", params["obj_ptr_proj"])
    if cfg.proj_tpos_enc_in_obj_ptrs:
        linear("obj_ptr_tpos_proj", params["obj_ptr_tpos_proj"])
    if cfg.pred_obj_scores and cfg.use_obj_ptrs_in_encoder:
        sd["no_obj_ptr"] = np.asarray(params["no_obj_ptr"])
    return sd


# JAX leaf names -> state-dict names (LayerNorm / GroupNorm ``scale`` beside a
# ``bias``; SR_PFO's lone ``scale`` keeps its name)
_PROMPTER_LEAF = {"w": "weight", "b": "bias", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}


def prompter_state_dict_from_jax(params, pcfg) -> Dict[str, np.ndarray]:
    """The port prompter's state dict (numpy values) from the JAX package's
    prompter tree with numpy leaves (``prompter_init``, or the ``prompter``
    half of the nuclei recipe's joint params). The port's modules carry the
    tree's names, so the mapping walks the tree: dict keys and list indices
    join with dots; ``w`` / ``b`` / ``scale`` become ``weight`` / ``bias``,
    the mask head's BN ``mean`` / ``var`` its ``running_mean`` /
    ``running_var`` buffers; conv HWIO -> OIHW, linear [in, out] -> [out, in].
    ``pcfg`` (a ``PrompterConfig`` of either package) must describe the
    tree."""
    mh = params["mask_head"]
    if ("bn" in mh) != (pcfg.mask_norm == "bn") or ("sr_pfo" in params) != pcfg.use_sr_pfo:
        raise ValueError(f"the prompter tree does not match {pcfg}")
    sd: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, value in items:
            if isinstance(value, (dict, list, tuple)):
                walk(f"{prefix}{key}.", value)
                continue
            a = np.asarray(value)
            name = _PROMPTER_LEAF.get(key, key)
            if key == "scale":
                name = "weight" if "bias" in node else "scale"
            if key == "w" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif key == "w" and a.ndim == 2:
                a = a.T
            sd[prefix + name] = a

    walk("", params)
    return sd


def load_reference_state_dict(model: torch.nn.Module, sd) -> None:
    """Load a reference-keyed state dict (numpy or torch values; a released
    checkpoint's ``ckpt["model"]``) with ``strict=True``."""
    tensors = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
               for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)
