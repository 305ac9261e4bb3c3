"""Work that one joint nuclei training step needs: FLOPs of the whole step
and of each hooked layer's forward, and the forward bytes of each hooked
layer, from the shapes alone.

A step of ``B`` images of ``S`` px with ``M`` cell slots each runs, forward:
the prompter (its ResNet, two FPNs, the proposal heads, the mask head),
SAM 2's image encoder with the decoder's two skip projections, the memory
attention over ``B`` drawn memories of (S / 16)^2 tokens each (from the
second step on, as every step of the window), the prompt encoder, the mask
decoder once per cell slot (``B * M`` prompts), and the memory encoder on
each image's union mask. Everything but the prompt and memory encoders
trains, so its backward costs twice its forward (1 MAC = 2 FLOPs;
normalisations, activations, sampling and the losses are left out, under
1 % of the total). The SAM 2 counts are those of
:mod:`portbench.counts.flops`; the prompter's are counted here.
"""

from __future__ import annotations

from portbench.counts import flops as F
from portbench.counts.propagation import encoder_flops
from portbench.reference.nuclei_plain import RESNETS

ACT_BYTES = 2      # SAM 2's bf16 activations
FP32 = 4           # parameters, the prompter's activations, the input images


def _conv(h: int, w: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * h * w * c_in * c_out * k * k


def resnet_flops(name: str, S: int):
    """(FLOPs of one image, the four stage outputs as (side, channels))."""
    depths, widths, bottleneck = RESNETS[name]
    r = S // 2
    f = _conv(r, r, 3, 64, 7)
    r //= 2                                                  # max pool
    c_in, levels = 64, []
    for s, (depth, c_out) in enumerate(zip(depths, widths)):
        for b in range(depth):
            stride = 2 if (b == 0 and s > 0) else 1
            r_out = r // stride
            if bottleneck:
                mid = c_out // 4
                f += _conv(r, r, c_in, mid, 1) + _conv(r_out, r_out, mid, mid, 3)
                f += _conv(r_out, r_out, mid, c_out, 1)
            else:
                f += _conv(r_out, r_out, c_in, c_out, 3) + _conv(r_out, r_out, c_out, c_out, 3)
            if stride != 1 or c_in != c_out:
                f += _conv(r_out, r_out, c_in, c_out, 1)
            r, c_in = r_out, c_out
        levels.append((r, c_out))
    return f, levels


def prompter_flops(p: dict, S: int) -> float:
    """The prompter's training forward for ONE image (no SAM feature, so no
    SR_PFO)."""
    f, levels = resnet_flops(p["backbone"], S)
    d = p["hidden_dim"]
    L = p["num_levels"]
    laterals = sum(_conv(r, r, c, d, 1) for r, c in levels)
    f += 2 * laterals                                        # both FPNs' laterals
    f += sum(_conv(r, r, d, d, 3) for r, _ in levels[:L])   # neck's output convs
    f += _conv(levels[0][0], levels[0][0], d, d, 3)         # neck1's finest
    n = -(-S // p["space"]) ** 2                             # proposals
    mlp = 2.0 * n * (d * d + d * 2)                          # one hidden layer, 2 outputs
    f += 2 * mlp + 2.0 * n * (d * d + d * (p["num_classes"] + 1))   # deform, reg; cls
    f += _conv(-(-S // p["space"]), -(-S // p["space"]), d * L, d, 3)
    r0 = levels[0][0]
    f += _conv(r0, r0, d, d, 3) + _conv(r0 + 2, r0 + 2, d, 1, 1)    # mask head
    return f


def memory_tokens(a, batch: int) -> int:
    """The memory one image attends to: ``batch`` drawn memories."""
    s = a.sam_image_embedding_size
    return batch * s * s


def step_flops(a, p: dict, batch: int, cells: int) -> dict:
    """FLOPs of one step: ``total`` (forward and backward of every trained
    part, the memory encoder's forward) and the forward of each hooked
    layer (``image_encoder``: the trunk and the FPN laterals; ``prompter``)."""
    enc_fwd = batch * encoder_flops(a)
    skips = batch * (F._hiera_flops(a) + F._neck_flops(a)) - enc_fwd
    prompter_fwd = batch * prompter_flops(p, a.image_size)
    mem_attn_fwd = batch * F._memory_attention_flops(a, memory_tokens(a, batch))
    heads_fwd = batch * cells * F._sam_heads_flops(a)
    trained_fwd = enc_fwd + skips + prompter_fwd + mem_attn_fwd + heads_fwd
    mem_enc_fwd = batch * F._memory_encoder_flops(a)
    return {"image_encoder": enc_fwd, "prompter": prompter_fwd,
            "total": 3.0 * trained_fwd + mem_enc_fwd}


def _param_bytes(weights, prefix: str, skip: str = None) -> float:
    return float(sum(t.numel() for k, t in weights.items()
                     if k.startswith(prefix) and not (skip and k.startswith(skip)))) * FP32


def step_bytes(a, p: dict, weights, batch: int) -> dict:
    """Bytes one step's forward of each hooked layer must move at least:
    its input, its weights and its outputs, each once."""
    S = a.image_size
    s = a.sam_image_embedding_size
    d = a.neck.d_model
    # encoder: the bf16 images in, its weights, the FPN levels and their
    # positions out (the lowest level dropped by ``scalp``)
    sides = [s * 2 ** k for k in (2, 1, 0, -1)][: 4 - a.scalp]
    fpn_out = 2 * sum(r * r for r in sides) * d * ACT_BYTES
    enc = batch * S * S * 3 * ACT_BYTES + _param_bytes(weights, "image_encoder.") + batch * fpn_out
    # prompter: the fp32 images in, its weights but SR_PFO's (not run), the
    # points, logits and mask out, and the pyramid it returns
    _, levels = resnet_flops(p["backbone"], S)
    n = -(-S // p["space"]) ** 2
    outs = n * (2 + p["num_classes"] + 1) + S * S
    outs += sum(r * r for r, _ in levels[: p["num_levels"]]) * p["hidden_dim"]
    prm = (batch * S * S * 3 * FP32 + _param_bytes(weights, "prompter.", "prompter.sr_pfo.")
           + batch * outs * FP32)
    return {"image_encoder": enc, "prompter": prm}
