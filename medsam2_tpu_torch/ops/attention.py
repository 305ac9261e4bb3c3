"""Scaled dot-product attention: plain PyTorch path + CUDA kernels.

Counterpart of ``medsam2_tpu/ops/attention.py``. Every attention of the model
goes through :func:`attention`; the memory cross-attention over the bank's
roped-key cache goes through :func:`kv_cached_attention`.

- :func:`sdpa_plain` is ``sdpa_xla``: fp32 softmax, products accumulated in
  fp32, probabilities cast to the value dtype before the PV product.
- :func:`flash_attention` replaces the Pallas ``_flash_kernel`` and, under
  autograd, its ``custom_vjp`` with the backward pair ``_bwd_dkv_kernel`` /
  ``_bwd_dq_kernel``. On a CUDA tensor the forward launches
  ``csrc/flash_attention.cu`` (with the per-row LSE output when a gradient
  will be taken) and the backward ``csrc/flash_attention_bwd.cu``; on a CPU
  tensor the same autograd function runs the plain twins
  :func:`flash_attention_lse_plain` and :func:`flash_attention_bwd_plain`,
  which spell out the kernels' math (masked probabilities are zeroed, a row
  with every key masked returns 0 and gets zero gradients).
- :func:`kv_cached_attention` replaces ``_kv_cached_kernel``; on CUDA it
  launches ``csrc/kv_cached_attention.cu``, on CPU it runs
  :func:`kv_cached_attention_plain`. Inference only: it raises when a
  gradient would be taken, as the JAX kernel path has no vjp.
- bf16 on the card, both forwards run the wgmma + TMA design of
  ``csrc/hopper_attention.cuh``. When one block per 128 query rows leaves
  SMs idle, the wrapper splits the kv range over several blocks, each of
  which writes a normalised fp32 partial output and its LSE, and
  :func:`attention_merge` (``csrc/flash_attention.cu``) combines them;
  :func:`attention_merge_plain` is its twin. The bf16 dQ pass runs the same
  design (``csrc/flash_bwd_dq_sm90.cu``), splits its kv range by the same
  rule, and :func:`flash_attention_bwd_dq_sum` adds its fp32 partials in
  split order (twin :func:`flash_attention_bwd_dq_sum_plain`). The bf16
  dK/dV pass (``csrc/flash_bwd_dkv_sm90.cu``) splits its q range by that
  rule over its 64-key blocks, and :func:`flash_attention_bwd_dkv_sum` adds
  its partial dK and dV in split order (twin
  :func:`flash_attention_bwd_dkv_sum_plain`).

There is no fallback: a CUDA tensor either reaches its kernel or the wrapper
raises. Shapes follow the JAX package: q [B, H, Nq, D], k [B, H, Nk, D],
v [B, H, Nk, Dv], kv_mask [B, Nk] bool (True = attend).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_NEG_INF = -1e30

# Head dims the flash forward kernel is instantiated for, D and Dv
# independently (csrc/attention_tile.cuh, csrc/flash_fwd_sm90_d*.cu); 72 is
# hiera_l's global attention.
KERNEL_HEAD_DIMS = (64, 72, 96, 128, 256)
# Query rows of one block of the bf16 forwards, and kv rows of one tile
# (csrc/hopper_attention.cuh kBQ, kBK).
_SM90_ROWS = 128
_SM90_TILE = 64
# (D, Dv) the backward kernels are instantiated for: memory self-attention,
# the low-rank memory cross-attention, and the Hiera global blocks that 2D
# training differentiates (96: hiera_t / s, 72: hiera_l; hiera_b+'s 56 stays
# under the flash gate), the only flash calls training differentiates
# (csrc/flash_attention_bwd.cu).
BWD_HEAD_DIMS = ((256, 256), (256, 64), (96, 96), (72, 72))
# (C, Dv) the kv-cached kernel is instantiated for: d_model and mem_dim of
# every SAM2 variant (csrc/kv_cached_attention.cu).
KV_CACHED_WIDTHS = (256, 64)
# The backward kernels write fp32 gradients into buffers padded to this many
# rows (the largest tile of either dtype).
_BWD_ROWS = 64


def _check_device(t: torch.Tensor, name: str) -> bool:
    """True for CUDA, False for CPU; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: unsupported device {t.device}")


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def sdpa_plain(q, k, v, kv_mask=None, scale=None):
    """Plain attention matching ``sdpa_xla`` (and torch's math SDPA).

    ``v`` may have another head dim than q/k (the low-rank value path)."""
    scale = _default_scale(q, scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _mask_float(kv_mask, k):
    """[B, 1, 1, Nk] float 0/1 mask (all ones without a mask)."""
    if kv_mask is None:
        return torch.ones(k.shape[0], 1, 1, k.shape[2], device=k.device)
    return kv_mask.float()[:, None, None, :]


def flash_attention_lse_plain(q, k, v, kv_mask=None, scale=None):
    """The flash forward kernel's math in plain PyTorch: -1e30 on masked
    logits, probabilities multiplied by the mask, fp32 row sums,
    probabilities cast to the value dtype for the PV product, and
    ``l == 0 -> 1`` so a fully masked row returns zeros
    (``medsam2_tpu/ops/attention.py:71-101``). Returns (out in q's dtype,
    lse [B, H, Nq] fp32 = m + log(l))."""
    scale = _default_scale(q, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    maskf = _mask_float(kv_mask, k)
    s = torch.where(maskf > 0, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * maskf
    l = p.sum(dim=-1, keepdim=True)
    lz = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / lz
    return out.to(q.dtype), (m + torch.log(lz))[..., 0]


def flash_attention_plain(q, k, v, kv_mask=None, scale=None):
    """:func:`flash_attention_lse_plain` without the LSE."""
    return flash_attention_lse_plain(q, k, v, kv_mask, scale)[0]


def bwd_scores_plain(q, k, v, kv_mask, lse, do, dvec, scale):
    """P and dS of the backward kernels in plain PyTorch: S = Q K^T * scale,
    P = exp(min(S - lse, 0)) * mask (fp32), dP = dO V^T and
    dS = P (dP - dvec) rounded to the input dtype. dvec [..., Nq] fp32.
    Returns (p, ds), both fp32."""
    dt = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(torch.clamp(s - lse.float()[..., None], max=0.0)) * _mask_float(kv_mask, k)
    dp = torch.matmul(do.to(dt).float(), v.float().transpose(-1, -2))
    return p, (p * (dp - dvec.float()[..., None])).to(dt).float()


def flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, scale=None):
    """The backward kernels' math in plain PyTorch (``_bwd_dkv_kernel`` and
    ``_bwd_dq_kernel``, ``medsam2_tpu/ops/attention.py:227-301``):
    P = exp(min(S * scale - lse, 0)) * mask, dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dO O)), dK = scale dS^T Q, dQ = scale dS K, with P and
    dS cast to the input dtype before their products and fp32 accumulation.
    Returns (dq, dk, dv) in the input dtypes."""
    scale = _default_scale(q, scale)
    dt = q.dtype
    dvec = (do.float() * o.float()).sum(dim=-1)
    p, ds = bwd_scores_plain(q, k, v, kv_mask, lse, do, dvec, scale)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.to(dt).float())
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(t: torch.Tensor, align: int = 16) -> torch.Tensor:
    """Contiguous with an ``align``-byte aligned base (the kernels load
    16-byte vectors, and TMA reads from 16-byte aligned bases)."""
    t = t.contiguous()
    if t.data_ptr() % align:
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


def _forward_only(name: str, *tensors) -> None:
    """Raise when a gradient would be taken through a kernel that has no
    backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward only (no backward kernel); run it under "
                           "torch.no_grad() or with frozen inputs")


def _flash_shapes(q, k, v, name: str):
    """Check q/k/v on the card in one kernel dtype; returns (B, H, Nq, Nk, D,
    Dv, dtype code)."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    Dv = v.shape[3]
    if k.shape != (B, H, Nk, D) or v.shape[:3] != (B, H, Nk):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} disagree")
    code = _dtype_code(q, name)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype")
    if not (k.is_cuda and v.is_cuda):
        raise RuntimeError(f"{name}: q, k, v must all lie on the card")
    return B, H, Nq, Nk, D, Dv, code


def _mask_arg(kv_mask, B: int, Nk: int, device, name: str):
    if kv_mask is None:
        return None
    if kv_mask.shape != (B, Nk):
        raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} != {(B, Nk)}")
    return _aligned(kv_mask.to(device=device, dtype=torch.float32))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    """A tensor's device address for ctypes, None (NULL) for no tensor."""
    return t.data_ptr() if t is not None else None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_count(blocks: int, n_tiles: int, sms: int) -> int:
    """kv splits of a bf16 forward: 1 when ``blocks`` (one per 128 query rows
    and head) fill the ``sms`` SMs; else as many as keep one wave, at most one
    kv tile a split."""
    if blocks >= sms or n_tiles <= 1:
        return 1
    return min(n_tiles, sms // blocks)


def _splits_for(t: torch.Tensor, blocks: int, n_tiles: int, forced, name: str) -> int:
    """The split count of a launch: the wrapper's pick, or ``forced``
    (checked). fp32 launches never split."""
    if t.dtype != torch.bfloat16:
        if forced not in (None, 1):
            raise ValueError(f"{name}: only the bf16 kernel splits the kv range")
        return 1
    if forced is None:
        return split_count(blocks, n_tiles, _sm_count(t.device.index or 0))
    if not 1 <= forced <= max(1, n_tiles):
        raise ValueError(f"{name}: {forced} splits for {n_tiles} kv tiles")
    return forced


def _partials(splits: int, rows: int, Dv: int, device):
    """fp32 scratch of a split launch (None, None for one split)."""
    if splits == 1:
        return None, None
    return (torch.empty(splits, rows, Dv, device=device, dtype=torch.float32),
            torch.empty(splits, rows, device=device, dtype=torch.float32))


def attention_merge_plain(o_parts, lse_parts):
    """attention_merge's math in plain PyTorch. o_parts [S, ..., Dv] fp32,
    each split's output normalised by its own row sum; lse_parts [S, ...]
    each split's m + log(l), -1e30 for a split whose keys were all masked.
    Returns (out fp32, lse): lse = logsumexp over the splits and
    out = sum_i exp(lse_i - lse) o_i; a row with every split empty gives 0
    and -1e30, as the flash forward does."""
    lse_parts = lse_parts.float()
    m = lse_parts.amax(dim=0)
    dead = m <= _NEG_INF
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    total = m_safe + torch.log(torch.exp(lse_parts - m_safe).sum(dim=0))
    lse = torch.where(dead, torch.full_like(m, _NEG_INF), total)
    w = torch.where(dead, torch.zeros_like(lse_parts), torch.exp(lse_parts - total))
    return (w[..., None] * o_parts.float()).sum(dim=0), lse


def attention_merge(o_parts, lse_parts, dtype=torch.bfloat16, with_lse: bool = True):
    """Combine split-kv partial outputs (see :func:`attention_merge_plain`).
    On the card it launches ``csrc/flash_attention.cu``'s merge kernel,
    which writes bf16; on the CPU it runs the twin. Returns (out in
    ``dtype``, lse fp32 or None)."""
    if not _check_device(o_parts, "attention_merge"):
        out, lse = attention_merge_plain(o_parts, lse_parts)
        return out.to(dtype), (lse if with_lse else None)
    if dtype != torch.bfloat16 or o_parts.dtype != torch.float32:
        raise TypeError("attention_merge: the kernel merges fp32 partials into bf16")
    S, Dv = o_parts.shape[0], o_parts.shape[-1]
    lead = o_parts.shape[1:-1]
    if lse_parts.shape != o_parts.shape[:-1] or not lse_parts.is_cuda:
        raise ValueError(f"attention_merge: lse {tuple(lse_parts.shape)} vs o "
                         f"{tuple(o_parts.shape)}")
    rows = math.prod(lead)
    op = _aligned(o_parts.reshape(S, rows, Dv))
    lp = _aligned(lse_parts.float().reshape(S, rows))
    out = torch.empty(rows, Dv, device=o_parts.device, dtype=dtype)
    lse = torch.empty(rows, device=o_parts.device, dtype=torch.float32) if with_lse else None
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_attention_merge(
        op.data_ptr(), lp.data_ptr(), out.data_ptr(), _ptr(lse), S, rows, Dv, _stream(o_parts))
    _raise_on_error(rc, "attention_merge")
    attention_merge.launches += 1
    return out.reshape(*lead, Dv), (lse.reshape(lead) if lse is not None else None)


def _flash_forward(q, k, v, kv_mask, scale, with_lse: bool, _splits=None):
    """One launch of the forward kernel (and, when the bf16 kernel splits the
    kv range, one of the merge); returns (out, lse or None). ``_splits``
    forces the split count (tests)."""
    B, H, Nq, Nk, D, Dv, code = _flash_shapes(q, k, v, "flash_attention")
    if D not in KERNEL_HEAD_DIMS or Dv not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got D={D} Dv={Dv}")
    n_tiles = -(-Nk // _SM90_TILE)
    blocks = B * H * -(-Nq // _SM90_ROWS)
    splits = _splits_for(q, blocks, n_tiles, _splits, "flash_attention")
    from medsam2_tpu_torch.ops._build import load_library

    lib = load_library()
    qf = _aligned(q.reshape(B * H, Nq, D))
    kf = _aligned(k.reshape(B * H, Nk, D))
    vf = _aligned(v.reshape(B * H, Nk, Dv))
    mask = _mask_arg(kv_mask, B, Nk, q.device, "flash_attention")
    o_part, lse_part = _partials(splits, B * H * Nq, Dv, q.device)
    out = lse = None
    if splits == 1:
        out = torch.empty(B * H, Nq, Dv, device=q.device, dtype=q.dtype)
        if with_lse:
            lse = torch.empty(B * H, Nq, device=q.device, dtype=torch.float32)
    rc = lib.medsam2_flash_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), _ptr(mask), _ptr(out), _ptr(lse),
        _ptr(o_part), _ptr(lse_part), B * H, H, Nq, Nk, D, Dv, ctypes.c_float(scale), splits,
        code, _stream(q))
    _raise_on_error(rc, "flash_attention")
    flash_attention.launches += 1
    if splits > 1:
        out, lse = attention_merge(o_part, lse_part, q.dtype, with_lse)
    return (out.reshape(B, H, Nq, Dv),
            lse.reshape(B, H, Nq) if lse is not None else None)


def _padded_rows(n: int) -> int:
    return -(-n // _BWD_ROWS) * _BWD_ROWS


# Keys a block and query rows a ring stage of the bf16 dK/dV pass
# (csrc/flash_bwd_dkv_sm90.cu kKvRows, kQTile).
DKV_BLOCK_KEYS = 64
DKV_Q_TILE = 64


def dq_block_rows(Dv: int) -> int:
    """Query rows of one block of the bf16 dQ pass
    (``csrc/flash_bwd_dq_sm90.cu``): two consumer warpgroups of 64 rows (Dv
    64, 96, 72), one at Dv = 256, where Q and dO of 128 rows would leave no
    room for a two-stage kv ring."""
    return 64 if Dv == 256 else 128


def flash_attention_bwd_dq_sum_plain(parts, scale: float):
    """The dQ split sum's math: ``scale`` times the fp32 partials [S, ..., D]
    added in split order, ((p0 + p1) + p2) + ..."""
    acc = parts[0].float()
    for part in parts[1:]:
        acc = acc + part.float()
    return acc * scale


def flash_attention_bwd_dq_sum(parts, scale: float):
    """Add the bf16 dQ pass's split-kv partials (see
    :func:`flash_attention_bwd_dq_sum_plain`), in fp32. On the card it
    launches ``csrc/flash_bwd_dq_sm90.cu``'s sum kernel (fixed order, no
    atomics); on the CPU it runs the twin. parts [S, ..., D] fp32 ->
    [..., D] fp32."""
    if not _check_device(parts, "flash_attention_bwd_dq_sum"):
        return flash_attention_bwd_dq_sum_plain(parts, scale)
    S, D = parts.shape[0], parts.shape[-1]
    if parts.dtype != torch.float32 or D % 4:
        raise TypeError("flash_attention_bwd_dq_sum: the kernel adds fp32 partials, D a "
                        "multiple of 4")
    lead = parts.shape[1:-1]
    rows = math.prod(lead)
    src = _aligned(parts.reshape(S, rows, D))
    out = torch.empty(rows, D, device=parts.device, dtype=torch.float32)
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_flash_attention_bwd_dq_sum(
        src.data_ptr(), out.data_ptr(), S, rows, D, ctypes.c_float(scale), _stream(parts))
    _raise_on_error(rc, "flash_attention_bwd_dq_sum")
    flash_attention_bwd_dq_sum.launches += 1
    return out.reshape(*lead, D)


def flash_attention_bwd_dkv_sum_plain(parts_k, parts_v, scale: float):
    """The dK/dV split sum's math: (scale times the dK partials, the dV
    partials), each added in split order."""
    return (flash_attention_bwd_dq_sum_plain(parts_k, scale),
            flash_attention_bwd_dq_sum_plain(parts_v, 1.0))


def flash_attention_bwd_dkv_sum(parts_k, parts_v, scale: float):
    """Add the bf16 dK/dV pass's split-q partials (see
    :func:`flash_attention_bwd_dkv_sum_plain`), in fp32. On the card it
    launches the same sum kernel as :func:`flash_attention_bwd_dq_sum`, once
    for both; on the CPU it runs the twin. parts_k [S, ..., D], parts_v
    [S, ..., Dv] fp32 -> ([..., D], [..., Dv]) fp32."""
    if not _check_device(parts_k, "flash_attention_bwd_dkv_sum"):
        return flash_attention_bwd_dkv_sum_plain(parts_k, parts_v, scale)
    S, D, Dv = parts_k.shape[0], parts_k.shape[-1], parts_v.shape[-1]
    lead = parts_k.shape[1:-1]
    if (parts_k.dtype != torch.float32 or parts_v.dtype != torch.float32 or D % 4 or Dv % 4
            or parts_v.shape[:-1] != parts_k.shape[:-1]):
        raise TypeError("flash_attention_bwd_dkv_sum: the kernel adds fp32 partials of one "
                        "row count, widths multiples of 4")
    rows = math.prod(lead)
    pk, pv = _aligned(parts_k.reshape(S, rows, D)), _aligned(parts_v.reshape(S, rows, Dv))
    dk = torch.empty(rows, D, device=parts_k.device, dtype=torch.float32)
    dv = torch.empty(rows, Dv, device=parts_k.device, dtype=torch.float32)
    from medsam2_tpu_torch.ops._build import load_library

    rc = load_library().medsam2_flash_attention_bwd_dkv_sum(
        pk.data_ptr(), dk.data_ptr(), pv.data_ptr(), dv.data_ptr(), S, rows, D, Dv,
        ctypes.c_float(scale), _stream(parts_k))
    _raise_on_error(rc, "flash_attention_bwd_dkv_sum")
    flash_attention_bwd_dkv_sum.launches += 1
    return dk.reshape(*lead, D), dv.reshape(*lead, Dv)


def _flash_bwd_launch(which: str, q, k, v, kv_mask, do, lse, dvec, scale, _splits=None):
    """One launch of ``csrc/flash_attention_bwd.cu``'s ``which`` pass: "dkv"
    (one block per kv tile) returns (dk, dv), "dq" (one block per q tile)
    returns (dq,), each in its input's dtype. The kernels write fp32 into
    buffers padded to whole tiles. The bf16 dq pass splits its kv range, the
    bf16 dkv pass its q range, when their blocks leave SMs idle (``_splits``
    forces the count, for tests), and then add the partials with
    :func:`flash_attention_bwd_dq_sum` / :func:`flash_attention_bwd_dkv_sum`."""
    name = f"flash_attention_bwd_{which}"
    B, H, Nq, Nk, D, Dv, code = _flash_shapes(q, k, v, name)
    if (D, Dv) not in BWD_HEAD_DIMS:
        raise ValueError(f"{name}: kernel built for (D, Dv) in {BWD_HEAD_DIMS}, "
                         f"got ({D}, {Dv})")
    if do.shape != (B, H, Nq, Dv) or lse.shape != (B, H, Nq) or dvec.shape != (B, H, Nq):
        raise ValueError(f"{name}: do {tuple(do.shape)} / lse {tuple(lse.shape)} / "
                         f"dvec {tuple(dvec.shape)} disagree with q {tuple(q.shape)}")
    n, like = (Nk, (k, v)) if which == "dkv" else (Nq, (q,))
    rows = _padded_rows(n)
    if which == "dq":
        splits = _splits_for(q, B * H * -(-Nq // dq_block_rows(Dv)), -(-Nk // _SM90_TILE),
                             _splits, name)
        parts = ([torch.empty(splits, B * H * Nq, D, device=q.device, dtype=torch.float32)]
                 if splits > 1 else [])
    else:
        splits = _splits_for(q, B * H * -(-Nk // DKV_BLOCK_KEYS), -(-Nq // DKV_Q_TILE),
                             _splits, name)
        parts = ([torch.empty(splits, B * H * rows, t.shape[-1], device=q.device,
                              dtype=torch.float32) for t in like] if splits > 1 else [])
    # a split pass writes only its partials
    outs = [] if parts else [
        torch.empty(B * H, rows, t.shape[-1], device=q.device, dtype=torch.float32)
        for t in like]
    mask = _mask_arg(kv_mask, B, Nk, q.device, name)
    ins = (_aligned(q.reshape(B * H, Nq, D)), _aligned(k.reshape(B * H, Nk, D)),
           _aligned(v.reshape(B * H, Nk, Dv)))
    do_, lse_, dvec_ = (_aligned(do.to(q.dtype).reshape(B * H, Nq, Dv)),
                        _aligned(lse.to(torch.float32).reshape(B * H, Nq)),
                        _aligned(dvec.to(torch.float32).reshape(B * H, Nq)))
    from medsam2_tpu_torch.ops._build import load_library

    scale = _default_scale(q, scale)
    lib = load_library()
    args = [*(t.data_ptr() for t in ins), _ptr(mask), do_.data_ptr(), lse_.data_ptr(),
            dvec_.data_ptr()]
    if which == "dkv":
        outs_or_none = outs or [None, None]
        parts_or_none = parts or [None, None]
        rc = lib.medsam2_flash_attention_bwd_dkv(
            *args, *(_ptr(o) for o in outs_or_none), *(_ptr(p) for p in parts_or_none), B * H,
            H, Nq, Nk, rows, D, Dv, ctypes.c_float(scale), splits, code, _stream(q))
    else:
        rc = lib.medsam2_flash_attention_bwd_dq(
            *args, _ptr(outs[0] if outs else None), _ptr(parts[0] if parts else None), B * H, H,
            Nq, Nk, rows, D, Dv, ctypes.c_float(scale), splits, code, _stream(q))
    _raise_on_error(rc, name)
    counted = flash_attention_bwd_dkv if which == "dkv" else flash_attention_bwd_dq
    counted.launches += 1
    counted.launches_by_width[(D, Dv)] = counted.launches_by_width.get((D, Dv), 0) + 1
    if parts and which == "dq":
        dq = flash_attention_bwd_dq_sum(parts[0], scale)
        return (dq.reshape(B, H, Nq, D).to(q.dtype),)
    if parts:
        outs = flash_attention_bwd_dkv_sum(parts[0].reshape(splits, B * H, rows, D),
                                           parts[1].reshape(splits, B * H, rows, Dv), scale)
    return tuple(o[:, :n].reshape(B, H, n, o.shape[-1]).to(t.dtype) for o, t in zip(outs, like))


def flash_attention_bwd_dkv(q, k, v, kv_mask, do, lse, dvec, scale=None, _splits=None):
    """dK, dV of flash attention on the card (replaces the Pallas
    ``_bwd_dkv_kernel``). ``dvec`` = rowsum(dO * O) [B, H, Nq] fp32; ``lse``
    the forward's [B, H, Nq]. Returns (dk, dv) in the input dtype.
    ``_splits`` forces the bf16 pass's q split count (tests)."""
    return _flash_bwd_launch("dkv", q, k, v, kv_mask, do, lse, dvec, scale, _splits)


def flash_attention_bwd_dq(q, k, v, kv_mask, do, lse, dvec, scale=None, _splits=None):
    """dQ of flash attention on the card (replaces the Pallas
    ``_bwd_dq_kernel``). Arguments as :func:`flash_attention_bwd_dkv`;
    ``_splits`` forces the bf16 pass's kv split count (tests)."""
    return _flash_bwd_launch("dq", q, k, v, kv_mask, do, lse, dvec, scale, _splits)[0]


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward pair, the ``custom_vjp`` of the JAX
    package's ``flash_attention``: the forward keeps the per-row LSE, the
    backward recomputes P from it."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        if _check_device(q, "flash_attention"):
            out, lse = _flash_forward(q, k, v, kv_mask, scale, with_lse=True)
        else:
            out, lse = flash_attention_lse_plain(q, k, v, kv_mask, scale)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        if not _check_device(q, "flash_attention"):
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, do, ctx.scale)
            return dq, dk, dv, None, None
        # dvec = rowsum(dO * O) stays a PyTorch op in fp32, as the JAX
        # package computes it in XLA outside its kernels
        dvec = (do.float() * out.float()).sum(dim=-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, kv_mask, do, lse, dvec, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, kv_mask, do, lse, dvec, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_mask=None, scale=None):
    """Flash attention. q [B,H,Nq,D], k [B,H,Nk,D], v [B,H,Nk,Dv], kv_mask
    [B,Nk] bool. Returns [B,H,Nq,Dv] in q's dtype.

    When grad is enabled and an input requires it, the call is the autograd
    function (forward with LSE, backward through the two backward kernels);
    otherwise it is the inference launch with no LSE, as JAX's
    ``with_lse=False``. CUDA tensors launch ``csrc/flash_attention.cu``;
    CPU tensors run the plain twins."""
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, scale)
    if not _check_device(q, "flash_attention"):
        return flash_attention_plain(q, k, v, kv_mask, scale)
    return _flash_forward(q, k, v, kv_mask, scale, with_lse=False)[0]


def kv_cached_attention_plain(q, kcache, pos_rows, row_of_slot, ptr_k, v_slots,
                              ptr_v, kv_mask, layer: int, scale=None):
    """Storage-order cached cross-attention in plain PyTorch: materialises
    ``k = kcache[:, :, layer] + pos_rows[row_of_slot, layer]`` (sum in the
    cache dtype), appends the pointer keys/values, and runs the flash math
    (zeroed masked probabilities, fully masked rows -> 0)."""
    B, F, L, P, C = kcache.shape
    Dv = v_slots.shape[-1]
    rows = row_of_slot.long()
    k_sp = kcache[:, :, layer] + pos_rows[rows, layer][None].to(kcache.dtype)
    k = torch.cat([k_sp.reshape(B, F * P, C), ptr_k.to(kcache.dtype)], dim=1)
    v = torch.cat([v_slots.reshape(B, F * P, Dv), ptr_v.to(v_slots.dtype)], dim=1)
    out = flash_attention_plain(q[:, None], k[:, None].to(q.dtype),
                                v[:, None].to(q.dtype), kv_mask, scale)
    return out[:, 0]


def kv_cached_attention(q, kcache, pos_rows, row_of_slot, ptr_k, v_slots,
                        ptr_v, kv_mask, layer: int, scale=None, _splits=None):
    """Cross-attention against the bank's roped-key cache in storage order
    (single kv head), ``medsam2_tpu.ops.attention.kv_cached_attention``.

    q [B, Nq, C]; kcache [B, F, L, P, C]; pos_rows [Rr, L, P, C]; row_of_slot
    [F] int; ptr_k [B, Nptr, C]; v_slots [B, F, P, Dv]; ptr_v [B, Nptr, Dv];
    kv_mask [B, F*P + Nptr] bool. Returns [B, Nq, Dv].

    Inference only, as the JAX kernel path: raises when grad is enabled and
    an input requires it. CUDA tensors launch ``csrc/kv_cached_attention.cu``
    for every P and Nptr (ragged ones included), in bf16 with the kv tiles
    split over blocks when one block per 128 query rows leaves SMs idle
    (``_splits`` forces the count, for tests); CPU tensors run
    :func:`kv_cached_attention_plain`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, kcache, pos_rows, ptr_k, v_slots, ptr_v)):
        raise RuntimeError("kv_cached_attention is inference only (no backward); "
                           "training reads memory in read order")
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
    scale = 1.0 / math.sqrt(C) if scale is None else scale
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
    n_tiles = F * -(-P // _SM90_TILE) + -(-Nptr // _SM90_TILE)
    splits = _splits_for(q, B * -(-Nq // _SM90_ROWS), n_tiles, _splits, "kv_cached_attention")
    o_part, lse_part = _partials(splits, B * Nq, Dv, q.device)
    out = torch.empty(B, Nq, Dv, device=q.device, dtype=q.dtype) if splits == 1 else None
    rc = lib.medsam2_kv_cached_attention_fwd(
        qc.data_ptr(), kc.data_ptr(), pr.data_ptr(), rows.data_ptr(),
        pk.data_ptr(), vs.data_ptr(), pv.data_ptr(), mask.data_ptr(),
        _ptr(out), _ptr(o_part), _ptr(lse_part), B, Nq, F, L, P, C, Dv, Nptr, Rr, int(layer), ctypes.c_float(scale), splits, code,
        _stream(q))
    _raise_on_error(rc, "kv_cached_attention")
    kv_cached_attention.launches += 1
    if splits > 1:
        out = attention_merge(o_part, lse_part, q.dtype, with_lse=False)[0].reshape(B, Nq, Dv)
    return out


# Launch counts: each wrapper adds one where it launches its kernel.
_COUNTED = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
            flash_attention_bwd_dq_sum, flash_attention_bwd_dkv_sum, kv_cached_attention,
            attention_merge)
for _fn in _COUNTED:
    _fn.launches = 0
# the backward pair's launches by (D, Dv) as well
flash_attention_bwd_dkv.launches_by_width = {}
flash_attention_bwd_dq.launches_by_width = {}


def _counted() -> dict:
    """{name: the function carrying the count}, every kernel of the port
    (the encoder kernels' modules import this one, so they load here)."""
    from medsam2_tpu_torch.ops import fused_block, fused_mlp, window_attention

    return {**{fn.__name__: fn for fn in _COUNTED},
            "window_attention": window_attention.window_attention,
            "fused_mlp": fused_mlp.ln_mlp_residual,
            "fused_block": fused_block.fused_window_block}


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_width"):
            fn.launches_by_width = {}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


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
