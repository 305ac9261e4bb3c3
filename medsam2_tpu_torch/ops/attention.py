"""Scaled dot-product attention: plain PyTorch path + two CUDA kernels.

Counterpart of ``medsam2_tpu/ops/attention.py``. Every attention of the model
goes through :func:`attention`; the memory cross-attention over the bank goes
through :func:`kv_cached_attention`.

- :func:`sdpa_plain` is ``sdpa_xla``: fp32 softmax, products accumulated in
  fp32, probabilities cast to the value dtype before the PV product.
- :func:`flash_attention` replaces the Pallas ``_flash_kernel``; on a CUDA
  tensor it launches ``csrc/flash_attention.cu``, on a CPU tensor it runs
  :func:`flash_attention_plain`, which spells out the kernel's math (masked
  probabilities are zeroed, a row with every key masked returns 0).
- :func:`kv_cached_attention` replaces ``_kv_cached_kernel``; on CUDA it
  launches ``csrc/kv_cached_attention.cu``, on CPU it runs
  :func:`kv_cached_attention_plain`.

There is no fallback: a CUDA tensor either reaches its kernel or the wrapper
raises. Shapes follow the JAX package: q [B, H, Nq, D], k [B, H, Nk, D],
v [B, H, Nk, Dv], kv_mask [B, Nk] bool (True = attend).
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30

# Head dims the flash kernel is instantiated for, D and Dv independently
# (csrc/attention_tile.cuh).
KERNEL_HEAD_DIMS = (64, 96, 128, 256)
# (C, Dv) the kv-cached kernel is instantiated for: d_model and mem_dim of
# every SAM2 variant (csrc/kv_cached_attention.cu).
KV_CACHED_WIDTHS = (256, 64)


def _check_device(t: torch.Tensor, name: str) -> bool:
    """True for CUDA, False for CPU; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: unsupported device {t.device}")


def sdpa_plain(q, k, v, kv_mask=None, scale=None):
    """Plain attention matching ``sdpa_xla`` (and torch's math SDPA).

    ``v`` may have another head dim than q/k (the low-rank value path)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, kv_mask=None, scale=None):
    """The flash kernel's math in plain PyTorch: -1e30 on masked logits,
    probabilities multiplied by the mask, fp32 row sums, probabilities cast to
    the value dtype for the PV product, and ``l == 0 -> 1`` so a fully masked
    row returns zeros (``medsam2_tpu/ops/attention.py:71-95``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is None:
        maskf = torch.ones(k.shape[0], k.shape[2], device=q.device)
    else:
        maskf = kv_mask.float()
    maskf = maskf[:, None, None, :]
    s = torch.where(maskf > 0, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * maskf
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernels load 16-byte
    vectors)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODE[t.dtype]


def _raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def flash_attention(q, k, v, kv_mask=None, scale=None):
    """Flash attention forward. q [B,H,Nq,D], k [B,H,Nk,D], v [B,H,Nk,Dv],
    kv_mask [B,Nk] bool. Returns [B,H,Nq,Dv] in q's dtype.

    CUDA tensors launch ``csrc/flash_attention.cu`` (replaces the Pallas
    ``_flash_kernel``); CPU tensors run :func:`flash_attention_plain`."""
    if not _check_device(q, "flash_attention"):
        return flash_attention_plain(q, k, v, kv_mask, scale)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    Dv = v.shape[3]
    if k.shape != (B, H, Nk, D) or v.shape[:3] != (B, H, Nk):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if D not in KERNEL_HEAD_DIMS or Dv not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got D={D} Dv={Dv}")
    code = _dtype_code(q, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if not (k.is_cuda and v.is_cuda):
        raise RuntimeError("flash_attention: q, k, v must all lie on the card")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    from medsam2_tpu_torch.ops._build import load_library

    lib = load_library()
    qf = _aligned(q.reshape(B * H, Nq, D))
    kf = _aligned(k.reshape(B * H, Nk, D))
    vf = _aligned(v.reshape(B * H, Nk, Dv))
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (B, Nk):
            raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)} "
                             f"!= {(B, Nk)}")
        mask = _aligned(kv_mask.to(device=q.device, dtype=torch.float32))
    out = torch.empty(B * H, Nq, Dv, device=q.device, dtype=q.dtype)
    rc = lib.medsam2_flash_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        B * H, H, Nq, Nk, D, Dv, ctypes.c_float(scale), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(rc, "flash_attention")
    flash_attention.launches += 1
    return out.reshape(B, H, Nq, Dv)


flash_attention.launches = 0


def kv_cached_attention_plain(q, kcache, pos_rows, row_of_slot, ptr_k, v_slots,
                              ptr_v, kv_mask, layer: int, scale=None):
    """Storage-order cached cross-attention in plain PyTorch: materialises
    ``k = kcache[:, :, layer] + pos_rows[row_of_slot, layer]`` (sum in the
    cache dtype), appends the pointer keys/values, and runs the flash math
    (zeroed masked probabilities, fully masked rows -> 0)."""
    B, F, L, P, C = kcache.shape
    Dv = v_slots.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(C)
    rows = row_of_slot.long()
    k_sp = kcache[:, :, layer] + pos_rows[rows, layer][None].to(kcache.dtype)
    k = torch.cat([k_sp.reshape(B, F * P, C), ptr_k.to(kcache.dtype)], dim=1)
    v = torch.cat([v_slots.reshape(B, F * P, Dv), ptr_v.to(v_slots.dtype)], dim=1)
    out = flash_attention_plain(q[:, None], k[:, None].to(q.dtype),
                                v[:, None].to(q.dtype), kv_mask, scale)
    return out[:, 0]


def kv_cached_attention(q, kcache, pos_rows, row_of_slot, ptr_k, v_slots,
                        ptr_v, kv_mask, layer: int, scale=None):
    """Cross-attention against the bank's roped-key cache in storage order
    (single kv head), ``medsam2_tpu.ops.attention.kv_cached_attention``.

    q [B, Nq, C]; kcache [B, F, L, P, C]; pos_rows [Rr, L, P, C]; row_of_slot
    [F] int; ptr_k [B, Nptr, C]; v_slots [B, F, P, Dv]; ptr_v [B, Nptr, Dv];
    kv_mask [B, F*P + Nptr] bool. Returns [B, Nq, Dv].

    CUDA tensors launch ``csrc/kv_cached_attention.cu`` for every P and Nptr
    (ragged ones included); CPU tensors run
    :func:`kv_cached_attention_plain`."""
    if not _check_device(q, "kv_cached_attention"):
        return kv_cached_attention_plain(q, kcache, pos_rows, row_of_slot,
                                         ptr_k, v_slots, ptr_v, kv_mask,
                                         layer, scale)
    B, F, L, P, C = kcache.shape
    Nq = q.shape[1]
    Nptr = ptr_k.shape[1]
    Dv = v_slots.shape[-1]
    Rr = pos_rows.shape[0]
    if q.shape != (B, Nq, C) or pos_rows.shape[1:] != (L, P, C):
        raise ValueError("kv_cached_attention: q/kcache/pos_rows shapes disagree")
    if v_slots.shape != (B, F, P, Dv) or ptr_k.shape != (B, Nptr, C) \
            or ptr_v.shape != (B, Nptr, Dv) or row_of_slot.shape != (F,):
        raise ValueError("kv_cached_attention: v_slots/ptr/row shapes disagree")
    if kv_mask.shape != (B, F * P + Nptr):
        raise ValueError(f"kv_cached_attention: kv_mask {tuple(kv_mask.shape)} "
                         f"!= {(B, F * P + Nptr)}")
    if not 0 <= layer < L:
        raise ValueError(f"kv_cached_attention: layer {layer} not in [0, {L})")
    if (C, Dv) != KV_CACHED_WIDTHS:
        raise ValueError(f"kv_cached_attention: kernel built for (C, Dv) = "
                         f"{KV_CACHED_WIDTHS}, got ({C}, {Dv})")
    code = _dtype_code(q, "kv_cached_attention")
    if kcache.dtype != q.dtype:
        raise TypeError("kv_cached_attention: kcache must be in q's dtype")
    for name, t in (("kcache", kcache), ("pos_rows", pos_rows),
                    ("row_of_slot", row_of_slot), ("ptr_k", ptr_k),
                    ("v_slots", v_slots), ("ptr_v", ptr_v), ("kv_mask", kv_mask)):
        if not t.is_cuda:
            raise RuntimeError(f"kv_cached_attention: {name} is not on the card")
    if scale is None:
        scale = 1.0 / math.sqrt(C)
    from medsam2_tpu_torch.ops._build import load_library

    lib = load_library()
    qc = _aligned(q)
    kc = _aligned(kcache)
    pr = _aligned(pos_rows.to(q.dtype))
    # out-of-range rows clamp inside the kernel (no host sync on the hot path)
    rows = row_of_slot.to(torch.int32).contiguous()
    pk = _aligned(ptr_k.to(q.dtype))
    vs = _aligned(v_slots.to(q.dtype))
    pv = _aligned(ptr_v.to(q.dtype))
    mask = _aligned(kv_mask.to(torch.float32))
    out = torch.empty(B, Nq, Dv, device=q.device, dtype=q.dtype)
    rc = lib.medsam2_kv_cached_attention_fwd(
        qc.data_ptr(), kc.data_ptr(), pr.data_ptr(), rows.data_ptr(),
        pk.data_ptr(), vs.data_ptr(), pv.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, Nq, F, L, P, C, Dv, Nptr, Rr, int(layer),
        ctypes.c_float(scale), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(rc, "kv_cached_attention")
    kv_cached_attention.launches += 1
    return out


kv_cached_attention.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    kv_cached_attention.launches = 0


def launch_counts() -> dict:
    return {"flash_attention": flash_attention.launches,
            "kv_cached_attention": kv_cached_attention.launches}


def _use_flash(q: torch.Tensor, kv_len: int, head_dim: int) -> bool:
    """``medsam2_tpu.ops.attention._use_flash`` with "on TPU" read as "tensor
    on CUDA": long sequences take the kernel, small decoder/window attentions
    the plain math (XLA, not Pallas, ran those in the JAX package)."""
    return (q.device.type == "cuda" and q.shape[2] >= 1024 and kv_len >= 1024
            and head_dim >= 64)


def attention(q, k, v, kv_mask=None, scale=None):
    """Dispatch to the flash kernel or the plain path."""
    if _use_flash(q, k.shape[2], q.shape[3]):
        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
    return sdpa_plain(q, k, v, kv_mask=kv_mask, scale=scale)
