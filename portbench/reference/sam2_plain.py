"""Plain PyTorch SAM 2: the image encoder, prompt encoder, mask decoder,
memory encoder and memory attention, and the propagation of one box prompt
through a volume, written from the upstream SAM 2 description
(``sam2/modeling``: ``hieradet.py``, ``image_encoder.py``,
``prompt_encoder.py``, ``mask_decoder.py``, ``transformer.py``,
``memory_attention.py``, ``memory_encoder.py``, ``sam2_base.py``).

It is the yardstick that decides whether the program's outputs are correct.
It imports nothing of the program: it takes a state dict (the upstream key
names) and the ``model`` block of a configuration file, and computes in
float32 with TF32 off, one volume and one object at a time, channels last.
The memory of a frame is a Python list of the earlier frames' memories and
pointers, as upstream keeps it: no fixed-shape bank, no masks, no key cache,
no kernels. The object pointers' rotation follows upstream's complex form
(interleaved channel pairs).

``precision="fp8"`` is the control: every matrix product and convolution
takes operands rounded to float8 e4m3 with a per-tensor scale, as an fp8
path would; everything else stays float32.

As the port does, box prompts on the conditioning frame decode with the
single-mask output and the stability fallback (``eval``), and the tracked
frames with the three-mask output. To judge a propagation,
:meth:`PlainSAM2.propagate` takes the judged masks and judges each frame
given the judged frames before it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.arch import arch

NO_OBJ_SCORE = -1024.0
STABILITY_DELTA = 0.05
STABILITY_THRESH = 0.98
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def sine_grid(h: int, w: int, num_pos_feats: int, device) -> torch.Tensor:
    """``PositionEmbeddingSine`` (normalised, scale 2 pi, temperature 1e4) as
    [h, w, C]: [pos_y ; pos_x], each interleaving sin and cos."""
    npf = num_pos_feats // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / npf)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=3).flatten(2)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=3).flatten(2)
    return torch.cat((py, px), dim=2)


def axial_cis(dim: int, end_x: int, end_y: int, theta: float, device) -> torch.Tensor:
    """Upstream ``compute_axial_cis``: [end_x * end_y, dim // 2] complex."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 4, device=device)[: dim // 4].float() / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    t_x = t % end_x
    t_y = torch.div(t, end_x, rounding_mode="floor")
    fx = torch.polar(torch.ones(t.numel(), freqs.numel(), device=device), torch.outer(t_x, freqs))
    fy = torch.polar(torch.ones(t.numel(), freqs.numel(), device=device), torch.outer(t_y, freqs))
    return torch.cat([fx, fy], dim=-1)


def rotate(x: torch.Tensor, cis: torch.Tensor) -> torch.Tensor:
    """Upstream ``apply_rotary_enc`` on one tensor [B, h, N, d]; the table
    repeats along N when N is a multiple of its length."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    r = xc.shape[-2] // cis.shape[0]
    if r > 1:
        cis = cis.repeat(r, 1)
    return torch.view_as_real(xc * cis).flatten(3)


class PlainSAM2:
    """The reference model over a state dict ``weights`` (float32 copies are
    taken) and a configuration's ``model`` block."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.W = {k: v.detach().float() for k, v in weights.items()}
        self.a = arch(model)
        self.fp8 = precision == "fp8"

    # ------------------------------------------------------------------
    # Primitives
    # ------------------------------------------------------------------

    def _q(self, x):
        return fp8_round(x) if self.fp8 else x

    def lin(self, x, name: str):
        y = self._q(x) @ self._q(self.W[name + ".weight"]).t()
        b = self.W.get(name + ".bias")
        return y if b is None else y + b

    def conv(self, x, name: str, stride: int = 1, padding: int = 0, groups: int = 1):
        """NHWC convolution with the upstream OIHW weight."""
        y = F.conv2d(self._q(x.permute(0, 3, 1, 2)), self._q(self.W[name + ".weight"]),
                     self.W.get(name + ".bias"), stride, padding, 1, groups)
        return y.permute(0, 2, 3, 1)

    def conv_t(self, x, name: str, stride: int = 2):
        y = F.conv_transpose2d(self._q(x.permute(0, 3, 1, 2)), self._q(self.W[name + ".weight"]),
                               self.W.get(name + ".bias"), stride)
        return y.permute(0, 2, 3, 1)

    def ln(self, x, name: str, eps: float):
        return F.layer_norm(x, (x.shape[-1],), self.W[name + ".weight"],
                            self.W[name + ".bias"], eps)

    def mlp(self, x, name: str, n: int, act=F.relu, sigmoid: bool = False):
        for i in range(n):
            x = self.lin(x, f"{name}.layers.{i}")
            if i < n - 1:
                x = act(x)
        return torch.sigmoid(x) if sigmoid else x

    def sdpa(self, q, k, v):
        """softmax(q k^T / sqrt(d)) v over [..., N, d]."""
        s = (self._q(q) @ self._q(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
        return self._q(torch.softmax(s, dim=-1)) @ self._q(v)

    # ------------------------------------------------------------------
    # Image encoder: Hiera + FPN (hieradet.py, image_encoder.py)
    # ------------------------------------------------------------------

    @staticmethod
    def _partition(x, ws: int):
        B, H, W, C = x.shape
        ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(-1, ws, ws, C), (Hp, Wp)

    @staticmethod
    def _unpartition(windows, ws: int, pad_hw, hw):
        Hp, Wp = pad_hw
        H, W = hw
        B = windows.shape[0] // (Hp * Wp // ws // ws)
        x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, Hp, Wp, -1)[:, :H, :W, :]

    @staticmethod
    def _pool(x, stride):
        return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)

    def _block(self, x, i: int, spec: dict):
        p = f"image_encoder.trunk.blocks.{i}"
        shortcut = x
        x = self.ln(x, p + ".norm1", 1e-6)
        if spec["dim"] != spec["dim_out"]:
            shortcut = self.lin(x, p + ".proj")
            if spec["q_stride"] is not None:
                shortcut = self._pool(shortcut, spec["q_stride"])
        ws = spec["window_size"]
        H, W = x.shape[1], x.shape[2]
        pad_hw = (H, W)
        if ws > 0:
            x, pad_hw = self._partition(x, ws)
        # MultiScaleAttention
        B, h, w, _ = x.shape
        heads, dout = spec["num_heads"], spec["dim_out"]
        qkv = self.lin(x.reshape(B, h * w, -1), p + ".attn.qkv").reshape(B, h * w, 3, heads, -1)
        q, k, v = qkv.unbind(2)
        if spec["q_stride"] is not None:
            q = self._pool(q.reshape(B, h, w, -1), spec["q_stride"])
            h, w = q.shape[1], q.shape[2]
            q = q.reshape(B, h * w, heads, -1)
        o = self.sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        x = self.lin(o.transpose(1, 2).reshape(B, h, w, dout), p + ".attn.proj")
        if spec["q_stride"] is not None:
            ws = ws // spec["q_stride"][0]
            H, W = shortcut.shape[1], shortcut.shape[2]
            pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws) if ws > 0 else (H, W)
        if spec["window_size"] > 0:
            x = self._unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.ln(x, p + ".norm2", 1e-6), p + ".mlp", 2, act=F.gelu)

    def trunk(self, img):
        """img [B, S, S, 3] -> per-stage outputs, highest resolution first."""
        t = self.a.trunk
        x = self.conv(img, "image_encoder.trunk.patch_embed.proj", t.patch_stride[0],
                      t.patch_padding[0])
        h, w = x.shape[1], x.shape[2]
        pe = F.interpolate(self.W["image_encoder.trunk.pos_embed"], size=(h, w), mode="bicubic")
        win = self.W["image_encoder.trunk.pos_embed_window"]
        pe = pe + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        x = x + pe.permute(0, 2, 3, 1)
        outs = []
        for i, spec in enumerate(t.block_schedule()):
            x = self._block(x, i, spec)
            if i in t.stage_ends:
                outs.append(x)
        return outs

    def encode(self, img):
        """Encoder + FPN + the decoder's high-res projections. Returns
        (features, positions), highest resolution first, the last level the
        one the memory attention and the heads read."""
        nk = self.a.neck
        xs = self.trunk(img)
        n = len(xs) - 1
        feats = [None] * (n + 1)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.conv(xs[i], f"image_encoder.neck.convs.{n - i}.conv")
            if i in nk.fpn_top_down_levels and prev is not None:
                td = F.interpolate(prev.permute(0, 3, 1, 2), scale_factor=2.0,
                                   mode=nk.fpn_interp_model).permute(0, 2, 3, 1)
                prev = lateral + td
                if nk.fuse_type == "avg":
                    prev = prev / 2
            else:
                prev = lateral
            feats[i] = prev
        if self.a.scalp > 0:
            feats = feats[: -self.a.scalp]
        if self.a.use_high_res_features_in_sam:
            feats[0] = self.conv(feats[0], "sam_mask_decoder.conv_s0")
            feats[1] = self.conv(feats[1], "sam_mask_decoder.conv_s1")
        last = feats[-1]
        pos = sine_grid(last.shape[1], last.shape[2], nk.num_pos_feats, last.device)
        return feats, pos

    # ------------------------------------------------------------------
    # Prompt encoder and mask decoder (prompt_encoder.py, mask_decoder.py,
    # transformer.py)
    # ------------------------------------------------------------------

    def _pe(self, coords01):
        g = self.W["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        c = (2.0 * coords01 - 1.0) @ g * (2 * math.pi)
        return torch.cat([c.sin(), c.cos()], dim=-1)

    def prompt(self, coords, labels, batch: int):
        """coords [B, P, 2] pixels (x, y), labels [B, P]; a padding point
        (label -1) is appended. Returns sparse [B, P + 1, C], dense
        [B, s, s, C]."""
        a = self.a
        dev = coords.device
        coords = torch.cat([coords.float() + 0.5, torch.zeros(batch, 1, 2, device=dev)], 1)
        labels = torch.cat([labels.long(), -torch.ones(batch, 1, dtype=torch.long, device=dev)], 1)
        pe = self._pe(coords / a.image_size)
        pe = torch.where((labels == -1)[..., None], torch.zeros_like(pe), pe)
        pe = pe + torch.where((labels == -1)[..., None],
                              self.W["sam_prompt_encoder.not_a_point_embed.weight"][0], 0.0)
        for lbl in range(4):
            pe = pe + torch.where((labels == lbl)[..., None],
                                  self.W[f"sam_prompt_encoder.point_embeddings.{lbl}.weight"][0],
                                  0.0)
        s = a.sam_image_embedding_size
        dense = self.W["sam_prompt_encoder.no_mask_embed.weight"].reshape(1, 1, 1, -1)
        dense = dense.expand(batch, s, s, dense.shape[-1])
        if a.dense_embed_size is not None:
            d = a.dense_embed_size
            dense = F.interpolate(dense.permute(0, 3, 1, 2), (d, d), mode="bilinear",
                                  align_corners=False).permute(0, 2, 3, 1)
        return pe, dense

    def _attn(self, name: str, q, k, v, heads: int):
        q, k, v = self.lin(q, name + ".q_proj"), self.lin(k, name + ".k_proj"), self.lin(v, name + ".v_proj")

        def split(x):
            B, N, C = x.shape
            return x.reshape(B, N, heads, C // heads).transpose(1, 2)

        o = self.sdpa(split(q), split(k), split(v))
        B, h, N, d = o.shape
        return self.lin(o.transpose(1, 2).reshape(B, N, h * d), name + ".out_proj")

    def _twoway(self, src, pos, tokens):
        a = self.a
        p = "sam_mask_decoder.transformer"
        heads = a.twoway_num_heads
        B, H, W, C = src.shape
        keys = src.reshape(B, H * W, C)
        key_pe = pos.reshape(B, H * W, C)
        queries = tokens
        for li in range(a.twoway_depth):
            lp = f"{p}.layers.{li}"
            if li == 0:
                queries = self._attn(lp + ".self_attn", queries, queries, queries, heads)
            else:
                q = queries + tokens
                queries = queries + self._attn(lp + ".self_attn", q, q, queries, heads)
            queries = self.ln(queries, lp + ".norm1", 1e-5)
            q, k = queries + tokens, keys + key_pe
            queries = self.ln(queries + self._attn(lp + ".cross_attn_token_to_image", q, k, keys,
                                                   heads), lp + ".norm2", 1e-5)
            queries = self.ln(queries + self.mlp(queries, lp + ".mlp", 2), lp + ".norm3", 1e-5)
            q, k = queries + tokens, keys + key_pe
            keys = self.ln(keys + self._attn(lp + ".cross_attn_image_to_token", k, q, queries,
                                             heads), lp + ".norm4", 1e-5)
        q, k = queries + tokens, keys + key_pe
        queries = self.ln(queries + self._attn(p + ".final_attn_token_to_image", q, k, keys, heads),
                          p + ".norm_final_attn", 1e-5)
        return queries, keys

    def heads(self, pix, high_res, coords, labels, multimask: bool, dynamic: bool):
        """``_forward_sam_heads`` with point prompts (or none: ``coords`` None)
        up to the choice of output. pix [B, s, s, C]. Returns the candidate
        low-res masks [B, K, 4s, 4s] (the three multimask outputs; or the
        single-mask output and the best multimask one under the stability
        fallback), the scores that choose among them [B, K] (the reference
        prefers the highest), their tokens for the object pointer, and
        whether the object appears."""
        a = self.a
        p = "sam_mask_decoder"
        B = pix.shape[0]
        dev = pix.device
        if coords is None:
            coords = torch.zeros(B, 1, 2, device=dev)
            labels = -torch.ones(B, 1, dtype=torch.long, device=dev)
        sparse, dense = self.prompt(coords, labels, B)
        s = a.sam_image_embedding_size
        ys = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        gy, gx = torch.meshgrid(ys, ys, indexing="ij")
        image_pe = self._pe(torch.stack([gx, gy], dim=-1))[None].expand(B, s, s, -1)
        n_mask = a.num_multimask_outputs + 1
        out_tokens = torch.cat([self.W[p + ".obj_score_token.weight"], self.W[p + ".iou_token.weight"],
                                self.W[p + ".mask_tokens.weight"]], dim=0)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], dim=1)
        src = pix + dense
        hs, src = self._twoway(src, image_pe, tokens)
        iou_tok, mask_toks = hs[:, 1], hs[:, 2: 2 + n_mask]
        src = src.reshape(B, s, s, -1)
        feat_s0, feat_s1 = high_res
        up = F.gelu(self.ln(self.conv_t(src, p + ".output_upscaling.0") + feat_s1,
                            p + ".output_upscaling.1", 1e-6))
        up = F.gelu(self.conv_t(up, p + ".output_upscaling.3") + feat_s0)
        hyper = torch.stack([self.mlp(mask_toks[:, i], f"{p}.output_hypernetworks_mlps.{i}", 3)
                             for i in range(n_mask)], dim=1)                 # [B, M, C/8]
        masks = torch.einsum("bmc,bhwc->bmhw", self._q(hyper), self._q(up))
        iou = self.mlp(iou_tok, p + ".iou_prediction_head", a.iou_head_depth,
                       sigmoid=a.iou_prediction_use_sigmoid)
        obj_logit = self.mlp(hs[:, 0], p + ".pred_obj_score_head", 3)        # [B, 1]
        appearing = obj_logit > 0                                           # [B, 1]
        if multimask:
            cands, scores, tokens = masks[:, 1:], iou[:, 1:], mask_toks[:, 1:]
        elif dynamic:
            # the stability fallback: the single-mask output while its
            # stability score reaches the threshold, else the best of the
            # three; its score margin is (score - thresh, thresh - score)
            bidx = torch.arange(B, device=dev)
            best = iou[:, 1:].argmax(dim=-1)
            single = masks[:, 0:1]
            flat = single.flatten(-2)
            area_i = (flat > STABILITY_DELTA).sum(-1).float()
            area_u = (flat > -STABILITY_DELTA).sum(-1).float()
            stab = torch.where(area_u > 0, area_i / area_u.clamp_min(1), torch.ones_like(area_u))
            cands = torch.cat([single, masks[:, 1:][bidx, best][:, None]], dim=1)
            scores = torch.cat([stab - STABILITY_THRESH, STABILITY_THRESH - stab], dim=1)
            tokens = mask_toks[:, 0:1].expand(B, 2, -1)
        else:
            cands, scores, tokens = masks[:, 0:1], iou[:, 0:1], mask_toks[:, 0:1]
        cands = torch.where(appearing[:, :, None, None], cands,
                            torch.full_like(cands, NO_OBJ_SCORE))
        return {"cands": cands, "scores": scores, "tokens": tokens, "appearing": appearing}

    def select(self, heads: dict, choice: torch.Tensor):
        """The chosen candidate of :meth:`heads` per row: (low-res mask
        [B, 1, 4s, 4s], high-res mask [B, 1, S, S], object pointer [B, C])."""
        a = self.a
        bidx = torch.arange(choice.shape[0], device=choice.device)
        low = heads["cands"][bidx, choice][:, None]
        high = F.interpolate(low, size=(a.image_size, a.image_size), mode="bilinear",
                             align_corners=False)
        ptr = self.mlp(heads["tokens"][bidx, choice], "obj_ptr_proj", 3)
        lam = heads["appearing"].float()
        ptr = lam * ptr + (1 - lam) * self.W["no_obj_ptr"]
        return low, high, ptr

    # ------------------------------------------------------------------
    # Memory encoder and memory attention (memory_encoder.py,
    # memory_attention.py, sam2_base.py)
    # ------------------------------------------------------------------

    def mem_encode(self, pix, high_mask):
        """pix [B, s, s, C] (the frame's own features), high_mask [B, 1, S, S]
        logits -> memory features [B, s*s, mem_dim]."""
        a = self.a
        me = a.memory_encoder
        p = "memory_encoder"
        m = torch.sigmoid(high_mask) * a.sigmoid_scale_for_mem_enc + a.sigmoid_bias_for_mem_enc
        x = m.permute(0, 2, 3, 1)
        n = int(math.log2(me.mask_downsampler_total_stride) // math.log2(me.mask_downsampler_stride))
        for i in range(n):
            x = self.conv(x, f"{p}.mask_downsampler.encoder.{3 * i}", me.mask_downsampler_stride,
                          me.mask_downsampler_padding)
            x = F.gelu(self.ln(x, f"{p}.mask_downsampler.encoder.{3 * i + 1}", 1e-6))
        x = self.conv(x, f"{p}.mask_downsampler.encoder.{3 * n}")
        x = self.conv(pix, p + ".pix_feat_proj") + x
        for li in range(me.fuser_num_layers):
            lp = f"{p}.fuser.layers.{li}"
            y = self.conv(x, lp + ".dwconv", padding=me.fuser_padding, groups=x.shape[-1])
            y = self.lin(F.gelu(self.lin(self.ln(y, lp + ".norm", 1e-6), lp + ".pwconv1")),
                         lp + ".pwconv2")
            x = x + self.W[lp + ".gamma"] * y
        if me.out_dim != me.in_dim:
            x = self.conv(x, p + ".out_proj")
        B, h, w, D = x.shape
        return x.reshape(B, h * w, D)

    def _rope_attn(self, name: str, q, k, v, cis, num_k_exclude: int = 0):
        """Upstream ``RoPEAttention`` with one head: q/k rotated by the axial
        table (the table repeats over the memory frames of k), the last
        ``num_k_exclude`` keys (object pointers) not rotated."""
        q = self.lin(q, name + ".q_proj")[:, None]
        k = self.lin(k, name + ".k_proj")[:, None]
        v = self.lin(v, name + ".v_proj")[:, None]
        q = rotate(q, cis)
        n_rope = k.shape[2] - num_k_exclude
        k = torch.cat([rotate(k[:, :, :n_rope], cis), k[:, :, n_rope:]], dim=2)
        o = self.sdpa(q, k, v)[:, 0]
        return self.lin(o, name + ".out_proj")

    def mem_attention(self, curr, curr_pos, memory, memory_pos, num_ptr_tokens: int):
        """curr/curr_pos [B, N, C]; memory/memory_pos [B, Nk, mem_dim]."""
        ma = self.a.memory_attention
        side = int(round(math.sqrt(curr.shape[1])))
        cis = axial_cis(ma.d_model // ma.self_attn_num_heads, side, side, ma.rope_theta,
                        curr.device)
        x = curr + 0.1 * curr_pos if ma.pos_enc_at_input else curr
        for li in range(ma.num_layers):
            lp = f"memory_attention.layers.{li}"
            t2 = self.ln(x, lp + ".norm1", 1e-5)
            q = t2 + curr_pos if ma.pos_enc_at_attn else t2
            x = x + self._rope_attn(lp + ".self_attn", q, q, t2, cis)
            t2 = self.ln(x, lp + ".norm2", 1e-5)
            q = t2 + curr_pos if ma.pos_enc_at_cross_attn_queries else t2
            k = memory + memory_pos if ma.pos_enc_at_cross_attn_keys else memory
            x = x + self._rope_attn(lp + ".cross_attn_image", q, k, memory, cis, num_ptr_tokens)
            t2 = self.ln(x, lp + ".norm3", 1e-5)
            act = F.relu if ma.activation == "relu" else F.gelu
            x = x + self.lin(act(self.lin(t2, lp + ".linear1")), lp + ".linear2")
        return self.ln(x, "memory_attention.norm", 1e-5)

    # ------------------------------------------------------------------
    # Propagation
    # ------------------------------------------------------------------

    @torch.no_grad()
    def propagate(self, frames, box_coords, box_labels, follow=None,
                  tie: float = 0.0) -> Dict[str, torch.Tensor]:
        """One volume, one object: frames [T, S, S, 3] normalised, the box on
        frame 0 as two corners [2, 2] (x, y) labelled [2] (2, 3). Frame 0 is
        the conditioning frame; frames 1..T-1 are tracked forward.

        Where the decoder chooses among candidate masks by a score, the
        reference takes its highest-scoring one. With ``follow`` (the judged
        low-res logits [T, 1, 4s, 4s]) each frame is judged given the judged
        answers before it, as a served model's reference runs over the
        served tokens: the memory of frame t is encoded from the judged mask
        of frame t, and where the candidate nearest the judged mask scores
        within ``tie`` of the best, the reference takes that candidate (its
        object pointer too). Returns ``low`` [T, 1, 4s, 4s] (the chosen
        candidates), and with ``follow`` also, per frame, ``err``
        (||follow - chosen|| / ||chosen||) and ``gap`` (by how much the
        score of the candidate nearest the judged mask lies below the
        best)."""
        with exact_float32():
            return self._propagate(frames, box_coords, box_labels, follow, tie)

    def _choose(self, heads: dict, follow_t, tie: float, out: dict):
        scores = heads["scores"][0]
        best = scores.argmax()
        if follow_t is None:
            return best.reshape(1)
        cands = heads["cands"][0]                                            # [K, h, w]
        d = (cands - follow_t.float()).flatten(1).norm(dim=1)
        rel = d / cands.flatten(1).norm(dim=1).clamp_min(1e-30)
        near = rel.argmin()
        gap = scores[best] - scores[near]
        k = torch.where(gap <= tie, near, best)
        out["err"].append(rel[k])
        out["gap"].append(gap)
        return k.reshape(1)

    def _propagate(self, frames, box_coords, box_labels, follow, tie):
        a = self.a
        T = frames.shape[0]
        s = a.sam_image_embedding_size
        dev = frames.device
        mem_pos = sine_grid(s, s, a.mem_dim, dev).reshape(s * s, a.mem_dim)
        tpos = self.W["maskmem_tpos_enc"].reshape(a.num_maskmem, a.mem_dim)
        cond: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        noncond: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        out: Dict[str, List[torch.Tensor]] = {"low": [], "err": [], "gap": []}
        tok = a.hidden_dim // a.mem_dim
        max_ptrs = min(T, a.max_obj_ptrs_in_encoder)
        for t in range(T):
            feats, pos = self.encode(frames[t: t + 1].float())
            pix = feats[-1]
            B, h, w, C = pix.shape
            if t == 0:
                cur = pix + self.W["no_mem_embed"].reshape(1, 1, 1, C)
                heads = self.heads(cur, feats[:-1], box_coords[None].float(),
                                   box_labels[None].long(), multimask=False, dynamic=True)
            else:
                mems, poss = [], []
                for f in sorted(cond):
                    mems.append(cond[f][0])
                    poss.append(mem_pos + tpos[a.num_maskmem - 1])
                for t_pos in range(1, a.num_maskmem):
                    prev = t - (a.num_maskmem - t_pos)
                    if prev in noncond:
                        mems.append(noncond[prev][0])
                        poss.append(mem_pos + tpos[a.num_maskmem - t_pos - 1])
                ptrs = [cond[f][1] for f in sorted(cond) if f <= t]
                for t_diff in range(1, max_ptrs):
                    prev = t - t_diff
                    if prev < 0:
                        break
                    if prev in noncond:
                        ptrs.append(noncond[prev][1])
                ptr_tokens = torch.stack(ptrs, 0).reshape(len(ptrs) * tok, a.mem_dim)
                memory = torch.cat(mems + [ptr_tokens], 0)[None]
                memory_pos = torch.cat(poss + [torch.zeros_like(ptr_tokens)], 0)[None]
                curr = pix.reshape(1, h * w, C)
                curr_pos = pos.reshape(1, h * w, C)
                cur = self.mem_attention(curr, curr_pos, memory, memory_pos,
                                         ptr_tokens.shape[0]).reshape(1, h, w, C)
                heads = self.heads(cur, feats[:-1], None, None, multimask=True, dynamic=True)
            choice = self._choose(heads, None if follow is None else follow[t, 0], tie, out)
            low, high, ptr = self.select(heads, choice)
            if follow is not None:
                # the judged mask is this frame's served answer: the memory
                # of later frames is encoded from it
                high = F.interpolate(follow[t: t + 1].float(), size=high.shape[-2:],
                                     mode="bilinear", align_corners=False)
            mem = self.mem_encode(pix, high)[0]
            (cond if t == 0 else noncond)[t] = (mem, ptr[0])
            out["low"].append(low[0])
        res = {"low": torch.stack(out["low"], 0)}
        if follow is not None:
            res["err"] = torch.stack(out["err"])
            res["gap"] = torch.stack(out["gap"])
        return res
