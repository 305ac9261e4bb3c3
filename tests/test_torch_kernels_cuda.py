"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips when no CUDA device is present. On a GPU
host run them without the JAX-configuring conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Inputs are drawn at unit scale, so logits are O(1) and the softmax is far
from uniform: a kernel that dropped or mis-indexed keys would miss by much
more than the tolerance. Tolerances: fp32 inputs (TF32 off) agree with the
twin to 1e-4 absolute (sums taken in another order); bf16 inputs are held
against the twin run on the same values upcast to fp32, to 1e-2 of the
largest |output|. The kernel rounds probabilities and the output to bf16, so
its error scales with the output: measured on an H100 over these cases,
max_abs_err / max|output| stays under 3.2e-3, about one bf16 ulp.

The bf16 forwards split the kv range over blocks when the grid would leave
SMs idle (and merge the partial outputs with ``attention_merge``); the split
cases force each split count the wrapper can pick through its private
``_splits`` argument.
"""

import numpy as np
import pytest
import torch

from medsam2_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

TOL_F32 = 1e-4
TOL_BF16_REL = 1e-2


def _tol(want, dtype):
    if dtype == torch.bfloat16:
        return TOL_BF16_REL * want.abs().max().item()
    return TOL_F32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dev, dtype, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)


FLASH_CASES = [
    # (B, H, Nq, Nk, D, Dv, mask)
    (1, 2, 128, 300, 64, 64, "random"),
    (2, 1, 100, 77, 96, 96, "row0_dead"),     # ragged lengths, batch 0 fully masked
    (1, 1, 130, 200, 256, 64, "random"),      # Dv != D (low-rank values)
    (1, 3, 64, 64, 128, 256, None),
    (1, 4, 4096, 4096, 96, 96, None),         # Hiera global attention @1024
    (1, 1, 4096, 4096, 256, 256, None),       # memory self-attention @1024
    (1, 2, 200, 333, 72, 72, "random"),       # hiera_l heads: Nq, Nk ragged against the tiles
    (2, 3, 100, 77, 72, 72, "row0_dead"),
    (1, 8, 4096, 4096, 72, 72, None),         # hiera_l global attention @1024
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_flash_kernel_matches_twin(dev, dtype, case):
    B, H, Nq, Nk, D, Dv, mask_kind = case
    rng = np.random.default_rng(0)
    q = _t(rng, (B, H, Nq, D), dev, dtype)
    k = _t(rng, (B, H, Nk, D), dev, dtype)
    v = _t(rng, (B, H, Nk, Dv), dev, dtype)
    mask = None
    if mask_kind is not None:
        m = rng.random((B, Nk)) > 0.3
        if mask_kind == "row0_dead":
            m[0] = False
        mask = torch.from_numpy(m).to(dev)
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    want = A.flash_attention_plain(q.float(), k.float(), v.float(), kv_mask=mask)
    err = (got.float() - want).abs().max().item()
    assert got.shape == (B, H, Nq, Dv) and got.dtype == dtype
    assert err <= _tol(want, dtype), err
    if mask_kind == "row0_dead":
        assert got[0].abs().max().item() == 0.0


BWD_CASES = [
    # (B, H, Nq, Nk, D, Dv, mask); (D, Dv) in the four built pairs
    (1, 1, 128, 300, 256, 64, "random"),      # ragged Nk, low-rank values
    (2, 1, 100, 77, 256, 256, "row0_dead"),   # ragged both, batch 0 fully masked
    (1, 1, 1024, 1024, 256, 256, None),       # memory self-attention @512
    (2, 1, 1024, 10316, 256, 64, "stale"),    # memory cross-attention @512, training
    (2, 4, 1024, 1024, 96, 96, None),         # hiera_t / s global blocks @512, 2D training
    (2, 1, 100, 77, 96, 96, "row0_dead"),     # 64 + 32 column chunks, ragged, batch 0 masked
    (1, 8, 1024, 1024, 72, 72, None),         # hiera_l global blocks @512
    (1, 2, 300, 520, 72, 72, "random"),       # 72 -> 80 columns, ragged both
]
# gradients are held relative to their largest |value|: fp32 as tight as the
# JAX package's grad test (5e-5), bf16 against the twin run on the same bf16
# values with the same roundings of P and dS, so only summation order and the
# final bf16 rounding of the gradient differ
TOL_GRAD_F32 = 5e-5
TOL_GRAD_BF16 = 1e-2


def _bwd_mask(rng, B, Nk, kind, dev):
    if kind is None:
        return None
    m = rng.random((B, Nk)) > 0.3
    if kind == "row0_dead":
        m[0] = False
    elif kind == "stale":
        m[:, 2048:4096] = False                # two stale memory frames
        m[1, -40:] = False                     # pointer padding
    return torch.from_numpy(m).to(dev)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_flash_lse_and_backward_kernels_match_twins(dev, dtype, case):
    B, H, Nq, Nk, D, Dv, kind = case
    rng = np.random.default_rng(3)
    q = _t(rng, (B, H, Nq, D), dev, dtype)
    k = _t(rng, (B, H, Nk, D), dev, dtype)
    v = _t(rng, (B, H, Nk, Dv), dev, dtype)
    do = _t(rng, (B, H, Nq, Dv), dev, dtype)
    mask = _bwd_mask(rng, B, Nk, kind, dev)
    # forward with LSE (the training launch; the bf16 training shapes split
    # the kv range and merge)
    out, lse = A._flash_forward(q, k, v, mask, 1.0 / D ** 0.5, with_lse=True)
    want_out, want_lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(), mask)
    assert (out.float() - want_out).abs().max().item() <= _tol(want_out, dtype)
    assert (lse - want_lse).abs().max().item() <= 1e-4 * want_lse.abs().clamp_max(1e3).max().item() + 1e-4
    # backward pair fed the kernel's own LSE, against the twin on the same
    # inputs, O and the twin's LSE
    dvec = (do.float() * want_out.to(dtype).float()).sum(-1)
    before = A.launch_counts()
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, mask, do, lse, dvec)
    dq = A.flash_attention_bwd_dq(q, k, v, mask, do, lse, dvec)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    wq, wk, wv = A.flash_attention_bwd_plain(q, k, v, mask, want_out.to(dtype), want_lse, do)
    tol = TOL_GRAD_F32 if dtype == torch.float32 else TOL_GRAD_BF16
    for name, got, want in (("dq", dq, wq), ("dk", dk, wk), ("dv", dv, wv)):
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= tol, (name, _rel_err(got, want))
    if kind == "row0_dead":
        assert dq[0].abs().max().item() == 0.0 and dk[0].abs().max().item() == 0.0


def test_flash_autograd_launches_backward_pair(dev):
    rng = np.random.default_rng(4)
    q, k = (_t(rng, (1, 1, 200, 256), dev, torch.float32).requires_grad_() for _ in range(2))
    v = _t(rng, (1, 1, 200, 64), dev, torch.float32).requires_grad_()
    w = _t(rng, (1, 1, 200, 64), dev, torch.float32)
    mask = torch.from_numpy(rng.random((1, 200)) > 0.2).to(dev)
    before = A.launch_counts()
    (A.flash_attention(q, k, v, kv_mask=mask) * w).sum().backward()
    after = A.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention": 1, "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dq_sum": 0, "flash_attention_bwd_dkv_sum": 0,
        "kv_cached_attention": 0, "attention_merge": 0,
        "window_attention": 0, "fused_mlp": 0, "fused_block": 0}
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (A.sdpa_plain(q, k, v, kv_mask=mask) * w).sum().backward()
    for g, t in zip(got, (q, k, v)):
        assert _rel_err(g, t.grad) <= TOL_GRAD_F32


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("case", [
    (2, 1, 1024, 1024, 256, 256, None),        # memory self-attention @512 (16 kv tiles)
    (2, 1, 1024, 10316, 256, 64, "stale"),     # memory cross-attention @512 (162 tiles)
    (2, 1, 100, 420, 256, 64, "row0_dead"),    # 7 tiles, ragged, batch 0 fully masked
    (1, 2, 1024, 1024, 96, 96, None),          # hiera global blocks (D 96)
    (2, 1, 100, 420, 72, 72, "row0_dead"),     # hiera_l's D 72, ragged, batch 0 masked
], ids=["self512", "cross512", "ragged_dead", "hiera96", "hiera72_ragged_dead"])
def test_dq_kernel_split_counts_match_twin(dev, case, splits):
    """The bf16 dQ pass at forced kv split counts: the partials and their
    sum (one sum launch whenever it splits) against the twin."""
    B, H, Nq, Nk, D, Dv, kind = case
    rng = np.random.default_rng(12)
    dt = torch.bfloat16
    q, k = _t(rng, (B, H, Nq, D), dev, dt), _t(rng, (B, H, Nk, D), dev, dt)
    v, do = _t(rng, (B, H, Nk, Dv), dev, dt), _t(rng, (B, H, Nq, Dv), dev, dt)
    mask = _bwd_mask(rng, B, Nk, kind, dev)
    o, lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(), mask)
    o = o.to(dt)
    dvec = (do.float() * o.float()).sum(-1)
    before = A.launch_counts()
    got = A.flash_attention_bwd_dq(q, k, v, mask, do, lse, dvec, _splits=splits)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dq_sum"] == before["flash_attention_bwd_dq_sum"] + (splits > 1)
    want = A.flash_attention_bwd_plain(q, k, v, mask, o, lse, do)[0]
    assert got.shape == want.shape and got.dtype == dt
    assert _rel_err(got, want) <= TOL_GRAD_BF16
    if kind == "row0_dead":
        assert got[0].abs().max().item() == 0.0


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("case", [
    (2, 1, 1024, 1024, 256, 256, None),        # memory self-attention @512 (16 q tiles)
    (2, 1, 1024, 10316, 256, 64, "stale"),     # memory cross-attention @512
    (2, 1, 420, 100, 256, 64, "row0_dead"),    # 7 q tiles, ragged, batch 0 fully masked
    (1, 2, 1024, 1024, 96, 96, None),          # hiera global blocks (D 96)
    (2, 1, 420, 100, 72, 72, "row0_dead"),     # hiera_l's D 72, ragged, batch 0 masked
], ids=["self512", "cross512", "ragged_dead", "hiera96", "hiera72_ragged_dead"])
def test_dkv_kernel_split_counts_match_twin(dev, case, splits):
    """The bf16 dK/dV pass at forced q split counts: the partials and their
    sum (one sum launch whenever it splits) against the twin."""
    B, H, Nq, Nk, D, Dv, kind = case
    rng = np.random.default_rng(15)
    dt = torch.bfloat16
    q, k = _t(rng, (B, H, Nq, D), dev, dt), _t(rng, (B, H, Nk, D), dev, dt)
    v, do = _t(rng, (B, H, Nk, Dv), dev, dt), _t(rng, (B, H, Nq, Dv), dev, dt)
    mask = _bwd_mask(rng, B, Nk, kind, dev)
    o, lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(), mask)
    o = o.to(dt)
    dvec = (do.float() * o.float()).sum(-1)
    before = A.launch_counts()
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, mask, do, lse, dvec, _splits=splits)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert (after["flash_attention_bwd_dkv_sum"]
            == before["flash_attention_bwd_dkv_sum"] + (splits > 1))
    _, wk, wv = A.flash_attention_bwd_plain(q, k, v, mask, o, lse, do)
    for got, want in ((dk, wk), (dv, wv)):
        assert got.shape == want.shape and got.dtype == dt
        assert _rel_err(got, want) <= TOL_GRAD_BF16
    if kind == "row0_dead":
        assert dk[0].abs().max().item() == 0.0 and dv[0].abs().max().item() == 0.0


def test_dkv_sum_kernel_matches_twin(dev):
    rng = np.random.default_rng(16)
    pk, pv = _t(rng, (5, 2, 128, 256), dev, torch.float32), _t(rng, (5, 2, 128, 64), dev,
                                                                torch.float32)
    before = A.launch_counts()["flash_attention_bwd_dkv_sum"]
    dk, dv = A.flash_attention_bwd_dkv_sum(pk, pv, 0.0625)
    torch.cuda.synchronize()
    assert A.launch_counts()["flash_attention_bwd_dkv_sum"] == before + 1
    wk, wv = A.flash_attention_bwd_dkv_sum_plain(pk, pv, 0.0625)
    for got, want in ((dk, wk), (dv, wv)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_dq_sum_kernel_matches_twin(dev):
    rng = np.random.default_rng(13)
    parts = _t(rng, (5, 2, 3, 77, 256), dev, torch.float32)
    before = A.launch_counts()["flash_attention_bwd_dq_sum"]
    got = A.flash_attention_bwd_dq_sum(parts, 0.0625)
    torch.cuda.synchronize()
    assert A.launch_counts()["flash_attention_bwd_dq_sum"] == before + 1
    want = A.flash_attention_bwd_dq_sum_plain(parts, 0.0625)
    assert got.shape == (2, 3, 77, 256) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_backward_kernels_reject_unbuilt_widths(dev):
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    before = A.launch_counts()
    # 64 and hiera_b+'s 56 are built for the forward only; (96, 64) pairs
    # two built head dims the backward does not take together
    for d, dv in ((64, 64), (56, 56), (96, 64)):
        for fn in (A.flash_attention_bwd_dkv, A.flash_attention_bwd_dq):
            with pytest.raises(ValueError, match="kernel built for"):
                fn(z(1, 1, 64, d), z(1, 1, 64, d), z(1, 1, 64, dv), None, z(1, 1, 64, dv),
                   z(1, 1, 64), z(1, 1, 64))
    assert A.launch_counts() == before


KV_CASES = [
    # (B, Nq, F, L, P, Nptr, Rr); C = 256, Dv = 64, the only widths built
    (2, 64, 4, 2, 64, 8, 5),
    (1, 100, 3, 1, 72, 100, 4),                # ragged P, Nptr > one tile
    (2, 130, 8, 4, 256, 64, 8),
    (1, 4096, 8, 4, 4096, 64, 8),              # memory cross-attention @1024
]
C, DV = A.KV_CACHED_WIDTHS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", KV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_kv_cached_kernel_matches_twin(dev, dtype, case):
    B, Nq, F, L, P, Nptr, Rr = case
    rng = np.random.default_rng(1)
    q = _t(rng, (B, Nq, C), dev, dtype)
    kcache = _t(rng, (B, F, L, P, C), dev, dtype)
    pos_rows = _t(rng, (Rr, L, P, C), dev, dtype)
    # a slot -> row map that is not the identity: each slot has its own row
    perm = rng.permutation(Rr)[:F]
    if (perm == np.arange(F)).all():
        perm = np.roll(perm, 1)
    rows = torch.from_numpy(perm.astype(np.int32)).to(dev)
    ptr_k = _t(rng, (B, Nptr, C), dev, dtype)
    v_slots = _t(rng, (B, F, P, DV), dev, dtype)
    ptr_v = _t(rng, (B, Nptr, DV), dev, dtype)
    m = np.ones((B, F * P + Nptr), bool)
    m[0, P:2 * P] = False                      # a stale slot: every tile skipped
    m[0, F * P + Nptr // 2:] = False           # pointer padding
    if B > 1:
        m[1, 3:5] = False
        m[1, F * P:] = False                   # every pointer masked
    mask = torch.from_numpy(m).to(dev)
    for layer in range(L):
        before = A.kv_cached_attention.launches
        got = A.kv_cached_attention(q, kcache, pos_rows, rows, ptr_k, v_slots,
                                    ptr_v, mask, layer)
        torch.cuda.synchronize()
        assert A.kv_cached_attention.launches == before + 1
        # the twin sums kcache + pos in the cache dtype, as the kernel does
        want = A.kv_cached_attention_plain(q.float(), kcache, pos_rows, rows, ptr_k,
                                           v_slots.float(), ptr_v.float(), mask, layer)
        err = (got.float() - want).abs().max().item()
        assert got.shape == (B, Nq, DV) and got.dtype == dtype
        assert err <= _tol(want, dtype), (layer, err)


SPLIT_PAIRS = [(96, 96), (256, 64), (72, 72), (128, 256)]


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dims", SPLIT_PAIRS, ids=lambda d: "x".join(map(str, d)))
def test_flash_split_counts_match_twin(dev, dims, splits):
    """B*H = 1, one q tile of 100 rows and Nk = 300 (five 64-key tiles, the
    last ragged): the wrapper picks 5 splits; every count from 1 to 5, with
    the keys of tile 1 all masked (one split empty at 5)."""
    D, Dv = dims
    rng = np.random.default_rng(9)
    q, k = _t(rng, (1, 1, 100, D), dev, torch.bfloat16), _t(rng, (1, 1, 300, D), dev, torch.bfloat16)
    v = _t(rng, (1, 1, 300, Dv), dev, torch.bfloat16)
    m = rng.random((1, 300)) > 0.3
    m[:, 64:128] = False
    mask = torch.from_numpy(m).to(dev)
    assert A.split_count(1, 5, torch.cuda.get_device_properties(dev).multi_processor_count) == 5
    before = A.launch_counts()
    out, lse = A._flash_forward(q, k, v, mask, D ** -0.5, with_lse=True, _splits=splits)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["attention_merge"] == before["attention_merge"] + (splits > 1)
    want, want_lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(), mask)
    assert out.shape == (1, 1, 100, Dv) and out.dtype == torch.bfloat16
    assert (out.float() - want).abs().max().item() <= _tol(want, torch.bfloat16)
    assert (lse - want_lse).abs().max().item() <= 1e-3


def test_attention_merge_kernel_matches_twin(dev):
    """Partial outputs of 6 splits, with whole splits empty (LSE -1e30) and a
    row every split of which is empty."""
    rng = np.random.default_rng(10)
    o = _t(rng, (6, 2, 3, 77, 64), dev, torch.float32)
    lse = _t(rng, (6, 2, 3, 77), dev, torch.float32, scale=3.0)
    lse[1] = -1e30
    lse[:, 0, 0, 5] = -1e30
    o[lse <= -1e30] = 0.0
    before = A.launch_counts()["attention_merge"]
    out, got_lse = A.attention_merge(o, lse)
    torch.cuda.synchronize()
    assert A.launch_counts()["attention_merge"] == before + 1
    want, want_lse = A.attention_merge_plain(o, lse)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 77, 64)
    assert (out.float() - want).abs().max().item() <= _tol(want, torch.bfloat16)
    assert (got_lse - want_lse).abs().max().item() <= 1e-5
    assert out[0, 0, 5].abs().max().item() == 0
    assert got_lse[0, 0, 5].item() == np.float32(-1e30)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_kv_cached_split_counts_match_twin(dev, splits):
    """B = 2, a non-identity slot -> row map, a stale slot and pointer
    padding; 3 slots of 100 keys (two tiles each, the second ragged) and one
    pointer tile: 7 kv tiles, each split count forced."""
    B, Nq, F, L, P, Nptr, Rr = 2, 130, 3, 2, 100, 10, 4
    rng = np.random.default_rng(11)
    dt = torch.bfloat16
    q = _t(rng, (B, Nq, C), dev, dt)
    kcache, pos_rows = _t(rng, (B, F, L, P, C), dev, dt), _t(rng, (Rr, L, P, C), dev, dt)
    rows = torch.tensor([2, 0, 3], dtype=torch.int32, device=dev)
    ptr_k, v_slots = _t(rng, (B, Nptr, C), dev, dt), _t(rng, (B, F, P, DV), dev, dt)
    ptr_v = _t(rng, (B, Nptr, DV), dev, dt)
    m = np.ones((B, F * P + Nptr), bool)
    m[:, P:2 * P] = False                      # a stale slot: its two tiles skipped
    m[1, F * P + 4:] = False                   # pointer padding
    mask = torch.from_numpy(m).to(dev)
    before = A.launch_counts()
    got = A.kv_cached_attention(q, kcache, pos_rows, rows, ptr_k, v_slots, ptr_v, mask, 1,
                                _splits=splits)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["kv_cached_attention"] == before["kv_cached_attention"] + 1
    assert after["attention_merge"] == before["attention_merge"] + (splits > 1)
    want = A.kv_cached_attention_plain(q.float(), kcache, pos_rows, rows, ptr_k,
                                       v_slots.float(), ptr_v.float(), mask, 1)
    assert got.shape == (B, Nq, DV) and got.dtype == dt
    assert (got.float() - want).abs().max().item() <= _tol(want, dt)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _session_bank(B: int, reverse: bool, dev):
    """The storage layout of a bank at hiera_t @512 (1 cond slot, a 7-slot
    ring, P = 1024) midway through a session, B rows (volumes x objects):
    forward, cond frame 0 and frames 1-10 tracked, reading frame 11; in
    reverse, cond frame 15 and frames 14-5 tracked, reading frame 4. The ring
    holds one stale frame. Returns (spec, row_of_slot, slot_valid)."""
    from medsam2_tpu_torch.configs import sam2_hiera_t
    from medsam2_tpu_torch.state import memory_bank as MB

    spec = MB.BankSpec.from_config(sam2_hiera_t(image_size=512), max_cond_frames=1)
    bank = MB.init_bank(spec, B, dev)
    R = spec.noncond_ring
    cond, tracked, cur = (15, range(14, 4, -1), 4) if reverse else (0, range(1, 11), 11)
    bank["cond_frame_idx"][:, 0] = cond
    for f in tracked:
        bank["noncond_frame_idx"][:, f % R] = f
    rows, valid = MB.kv_storage_layout(spec, bank, cur, track_in_reverse=reverse)
    return spec, rows, valid


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("B", [3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kv_cached_kernel_at_volume_batches_and_both_layouts(dev, dtype, B, reverse):
    """B2 at the folded-volume batches B = V * O of 3, 4 and 8 (5, 4 and 2
    kv splits in bf16 on 132 SMs), with the slot -> row map and validity a
    bank gives forward and in reverse: the ring slots map to rows in another
    order in each direction, and one stale slot is masked."""
    spec, rows, valid = _session_bank(B, reverse, dev)
    Mc, R = spec.max_cond_frames, spec.noncond_ring
    F, P, L, Nptr, Rr = Mc + R, spec.mem_spatial, 4, spec.num_ptr_tokens, spec.num_frames_attended
    Nq = P
    assert rows.tolist() != list(range(F)) and int(rows.max()) < Rr
    assert valid[:, Mc:].sum(dim=1).tolist() == [R - 1] * B
    rng = np.random.default_rng(12)
    q = _t(rng, (B, Nq, C), dev, dtype)
    kcache, pos_rows = _t(rng, (B, F, L, P, C), dev, dtype), _t(rng, (Rr, L, P, C), dev, dtype)
    ptr_k, v_slots = _t(rng, (B, Nptr, C), dev, dtype), _t(rng, (B, F, P, DV), dev, dtype)
    ptr_v = _t(rng, (B, Nptr, DV), dev, dtype)
    ptr_valid = torch.zeros(B, Nptr, dtype=torch.bool, device=dev)
    for b in range(B):
        ptr_valid[b, :4 * (1 + 3 * b % 16)] = True     # 1, 4, 7, ... pointers of 4 tokens
    mask = torch.cat([valid.repeat_interleave(P, dim=1), ptr_valid], dim=1)
    blocks = B * -(-Nq // 128)
    split = dtype == torch.bfloat16 and 2 * blocks <= _sms(dev)
    before = A.launch_counts()
    got = A.kv_cached_attention(q, kcache, pos_rows, rows, ptr_k, v_slots, ptr_v, mask, 3)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["kv_cached_attention"] == before["kv_cached_attention"] + 1
    assert after["attention_merge"] == before["attention_merge"] + int(split)
    want = A.kv_cached_attention_plain(q.float(), kcache, pos_rows, rows, ptr_k,
                                       v_slots.float(), ptr_v.float(), mask, 3)
    assert got.shape == (B, Nq, DV) and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= _tol(want, dtype)


@pytest.mark.parametrize("O", [1, 2])
@pytest.mark.parametrize("dtype,splits", [(torch.float32, None), (torch.bfloat16, None),
                                          (torch.bfloat16, 1), (torch.bfloat16, 5)],
                         ids=["f32", "bf16", "bf16-1split", "bf16-5splits"])
def test_flash_at_read_order_inference_shape(dev, dtype, splits, O):
    """B1 as the read-order memory cross-attention runs it at inference @1024
    (raw or k-cached): q [O, 1, 4096, 256] against 1 cond slot, 6 ring
    targets of 4096 keys and 64 pointer tokens, Dv 64, a kv mask (one stale
    target, pointer padding), no LSE; bf16 at the wrapper's split count and
    forced ones."""
    Nq, P, Fa, Nptr = 4096, 4096, 7, 64
    Nk = Fa * P + Nptr
    rng = np.random.default_rng(13)
    q = _t(rng, (O, 1, Nq, 256), dev, dtype)
    k = _t(rng, (O, 1, Nk, 256), dev, dtype)
    v = _t(rng, (O, 1, Nk, 64), dev, dtype)
    m = np.ones((O, Nk), bool)
    m[:, 3 * P:4 * P] = False                  # a stale ring target
    m[:, Fa * P + 8:] = False                  # two pointers of 4 tokens
    if O > 1:
        m[1, Fa * P:] = False                  # no pointer at all
    mask = torch.from_numpy(m).to(dev)
    blocks = O * -(-Nq // 128)
    split = dtype == torch.bfloat16 and (splits > 1 if splits else 2 * blocks <= _sms(dev))
    before = A.launch_counts()
    with torch.no_grad():
        if splits is None:
            got = A.flash_attention(q, k, v, kv_mask=mask)
        else:
            got, lse = A._flash_forward(q, k, v, mask, 256 ** -0.5, with_lse=False,
                                        _splits=splits)
            assert lse is None
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["attention_merge"] == before["attention_merge"] + int(split)
    want = A.flash_attention_plain(q.float(), k.float(), v.float(), kv_mask=mask)
    assert got.shape == (O, 1, Nq, 64) and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= _tol(want, dtype)


# ---------------------------------------------------------------------------
# The cases of corrections, clear_non_cond_mem_around_input and training over
# the roped-key cache
# ---------------------------------------------------------------------------


def _cleared_session_bank(spec, reverse, clear, dev):
    """A bank's rings as a session leaves them (``chip_smoke.session_bank``):
    cond frame 0 and frames 1-10 tracked forward, read at 11, or cond frame
    15 and frames 14-4 in reverse, read at 3; then the frames within
    ``clear`` = (center, radius) invalidated. Returns (bank, frame read)."""
    from medsam2_tpu_torch.state import memory_bank as MB

    bank = MB.init_bank(spec, 1, dev)
    cond, tracked, cur = (15, range(14, 3, -1), 3) if reverse else (0, range(1, 11), 11)
    bank["cond_frame_idx"][:, 0] = cond
    for f in tracked:
        bank["noncond_frame_idx"][:, f % spec.noncond_ring] = f
        bank["ptr_frame_idx"][:, f % spec.ptr_ring] = f
    MB.clear_noncond_window(bank, *clear)
    return bank, cur


def _session_spec_1024():
    from medsam2_tpu_torch.configs import sam2_hiera_t
    from medsam2_tpu_torch.state import memory_bank as MB

    return MB.BankSpec.from_config(sam2_hiera_t(), max_cond_frames=1)


def _partials_spy(monkeypatch):
    """Keep the fp32 partial buffers (o, lse) each split launch allocates,
    to read what the kernel wrote into them."""
    seen = []
    partials = A._partials

    def spy(*args):
        bufs = partials(*args)
        if bufs[0] is not None:
            seen.append(bufs)
        return bufs

    monkeypatch.setattr(A, "_partials", spy)
    return seen


def _empty_splits_are_inert(seen, dead):
    """Each split without a valid key wrote a zero output and an LSE of
    -1e30 (weight 0 in the merge), and exactly the ``dead`` splits did."""
    (o_parts, lse_parts), = seen
    empty = [i for i in range(lse_parts.shape[0]) if (lse_parts[i] <= -1e29).all()]
    assert empty == dead, (empty, dead)
    for i in dead:
        assert (o_parts[i] == 0).all()


@pytest.mark.parametrize("dtype,splits,dead", [(torch.float32, None, []),
                                               (torch.bfloat16, None, [1, 2]),
                                               (torch.bfloat16, 5, [1, 2, 3])],
                         ids=["f32", "bf16", "bf16-5splits"])
def test_flash_read_order_with_kv_splits_left_empty_by_a_clear(dev, monkeypatch, dtype, splits,
                                                                dead):
    """B1 at the read-order inference shape @1024 (q [1,1,4096,256], 7 read
    slots of 4096 keys and 64 pointer tokens, Dv 64, no LSE) read at frame
    11 after frames 5-9 were cleared: read slots 1-5 hold no valid key, so
    bf16 kv splits 1 and 2 of 4 (1-3 of 5 when forced) see only masked
    tiles. Those splits write a zero partial and an LSE of -1e30, so the
    merge gives them weight 0: the output is finite and equals the twin."""
    from medsam2_tpu_torch.state import memory_bank as MB

    spec = _session_spec_1024()
    bank, cur = _cleared_session_bank(spec, False, (7, 2), dev)
    D, P = spec.mem_dim, spec.mem_spatial
    mask = MB.read_bank(spec, bank, cur, torch.zeros(7, D, device=dev),
                        torch.zeros(P, D, device=dev))[2]
    Nk = mask.shape[1]
    assert not mask[0, P:6 * P].any() and mask[0, 6 * P:7 * P].all()
    rng = np.random.default_rng(21)
    q = _t(rng, (1, 1, P, 256), dev, dtype)
    k, v = _t(rng, (1, 1, Nk, 256), dev, dtype), _t(rng, (1, 1, Nk, 64), dev, dtype)
    seen = _partials_spy(monkeypatch)
    before = A.launch_counts()
    with torch.no_grad():
        if splits is None:
            got = A.flash_attention(q, k, v, kv_mask=mask)
        else:
            got = A._flash_forward(q, k, v, mask, 256 ** -0.5, with_lse=False,
                                   _splits=splits)[0]
    torch.cuda.synchronize()
    after = A.launch_counts()
    split = dtype == torch.bfloat16 and (splits or A.split_count(32, -(-Nk // 64), _sms(dev))) > 1
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["attention_merge"] == before["attention_merge"] + int(split)
    assert len(seen) == int(split)
    if split:
        _empty_splits_are_inert(seen, dead)
    want = A.flash_attention_plain(q.float(), k.float(), v.float(), kv_mask=mask)
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() <= _tol(want, dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kv_cached_kernel_with_a_mid_ring_hole(dev, monkeypatch, dtype, reverse):
    """B2 at the session shape @1024 (1 cond slot + 7 ring slots of 4096
    keys, 64 pointer tokens, B = 1) after frames 8-10 were cleared: ring
    slots 1-3 (storage slots 2-4) are a hole inside the ring, in the slot ->
    row map and validity a bank gives forward and in reverse, and bf16 kv
    split 1 of 4 holds no valid key (a zero partial, LSE -1e30). Against
    the twin."""
    from medsam2_tpu_torch.state import memory_bank as MB

    spec = _session_spec_1024()
    bank, cur = _cleared_session_bank(spec, reverse, (9, 1), dev)
    rows, valid = MB.kv_storage_layout(spec, bank, cur, track_in_reverse=reverse)
    Mc, P, Nptr = spec.max_cond_frames, spec.mem_spatial, spec.num_ptr_tokens
    F, Rr = Mc + spec.noncond_ring, spec.num_frames_attended
    assert not valid[0, Mc + 1:Mc + 4].any() and valid[0, Mc + 5:].all()
    ptr_valid = MB.read_ptrs(spec, bank, cur, track_in_reverse=reverse)[1]
    mask = torch.cat([valid.repeat_interleave(P, dim=1), ptr_valid], dim=1)
    rng = np.random.default_rng(22)
    q = _t(rng, (1, P, C), dev, dtype)
    kcache, pos_rows = _t(rng, (1, F, 4, P, C), dev, dtype), _t(rng, (Rr, 4, P, C), dev, dtype)
    ptr_k, v_slots = _t(rng, (1, Nptr, C), dev, dtype), _t(rng, (1, F, P, DV), dev, dtype)
    ptr_v = _t(rng, (1, Nptr, DV), dev, dtype)
    seen = _partials_spy(monkeypatch)
    before = A.launch_counts()
    got = A.kv_cached_attention(q, kcache, pos_rows, rows, ptr_k, v_slots, ptr_v, mask, 1)
    torch.cuda.synchronize()
    after = A.launch_counts()
    assert after["kv_cached_attention"] == before["kv_cached_attention"] + 1
    assert after["attention_merge"] == before["attention_merge"] + int(dtype == torch.bfloat16)
    if dtype == torch.bfloat16:
        _empty_splits_are_inert(seen, [1])
    want = A.kv_cached_attention_plain(q.float(), kcache, pos_rows, rows, ptr_k,
                                       v_slots.float(), ptr_v.float(), mask, 1)
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() <= _tol(want, dtype)


class _TwinFlash(torch.autograd.Function):
    """The twins as an autograd function: forward and LSE from
    ``flash_attention_lse_plain`` in fp32, the backward from
    ``flash_attention_bwd_plain`` (the kernels' roundings of P and dS)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = A.flash_attention_lse_plain(q.float(), k.float(), v.float(), mask)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        return (*A.flash_attention_bwd_plain(q, k, v, mask, o, lse, do.to(q.dtype)), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_through_a_cache_built_key(dev, dtype):
    """B1 with LSE, B3 and B4 as training over the roped-key cache runs them
    (the train cross-attention @512: two objects, 4 cond slots + 6 read
    targets of 1024 keys and 76 pointer tokens, D 256 / Dv 64): K is built
    as ``rope_attn_apply`` builds it, the cache gathered in read order
    (``read_kcache``), this layer's positional half added, the pointer keys
    appended. That K is contiguous, so the wrappers copy nothing. The
    gradients reaching the cache, the positional half, the pointer keys, q
    and v equal those of the twins through the same graph."""
    from medsam2_tpu_torch.configs import sam2_hiera_t
    from medsam2_tpu_torch.state import memory_bank as MB

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = MB.BankSpec.from_config(sam2_hiera_t(image_size=512), max_cond_frames=4)
    B, L, C_, P, Fa = 2, 4, 256, spec.mem_spatial, spec.num_frames_attended
    bank = MB.init_bank(spec, B, dev, kcache_shape=(L, C_), kcache_dtype=dtype)
    for f in (0, 2, 4, 6):
        bank["cond_frame_idx"][:, f // 2] = f
    for f in (1, 3, 5):
        bank["noncond_frame_idx"][:, f % spec.noncond_ring] = f
        bank["ptr_frame_idx"][:, f % spec.ptr_ring] = f
    rng = np.random.default_rng(23)
    cache = _t(rng, tuple(bank["kcache"].shape), dev, dtype).requires_grad_()
    pos = _t(rng, (Fa, L, P, C_), dev, dtype).requires_grad_()
    k_ptr = _t(rng, (B, spec.num_ptr_tokens, C_), dev, dtype).requires_grad_()
    q = _t(rng, (B, 1, P, C_), dev, dtype).requires_grad_()
    mask = MB.read_bank(spec, bank, 7, torch.zeros(spec.num_maskmem, 64, device=dev),
                        torch.zeros(P, 64, device=dev), num_frames=8)[2]
    Nk = mask.shape[1]
    assert Nk == 10316 and not mask.all()
    v = _t(rng, (B, 1, Nk, 64), dev, dtype).requires_grad_()
    w = _t(rng, (B, 1, P, 64), dev, torch.float32)

    def grads(attend):
        kc = MB.read_kcache(spec, {**bank, "kcache": cache}, 7)[:, :, 1] + pos[None, :, 1]
        kp = torch.cat([kc.reshape(B, Fa * P, C_), k_ptr], dim=1)
        k = kp.reshape(B, Nk, 1, C_).transpose(1, 2)
        assert k.is_contiguous() and A._aligned(k.reshape(B, Nk, C_)).data_ptr() == k.data_ptr()
        loss = (attend(q, k, v, mask).float() * w).sum()
        return torch.autograd.grad(loss, (q, cache, pos, k_ptr, v))

    before = A.launch_counts()
    got = grads(lambda q, k, v, m: A.flash_attention(q, k, v, kv_mask=m))
    torch.cuda.synchronize()
    after = A.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1, name
    want = grads(_TwinFlash.apply)
    tol = TOL_GRAD_F32 if dtype == torch.float32 else TOL_GRAD_BF16
    for name, g, r in zip(("q", "cache", "pos", "k_ptr", "v"), got, want):
        assert g.shape == r.shape and g.dtype == dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= tol, (name, _rel_err(g, r))


@pytest.mark.parametrize("widths", [(128, 64), (256, 96), (64, 64)],
                         ids=lambda w: "x".join(map(str, w)))
def test_kv_cached_kernel_rejects_unbuilt_widths(dev, widths):
    c, dv = widths
    B, Nq, F, L, P, Nptr = 1, 16, 2, 1, 16, 4
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    mask = torch.ones(B, F * P + Nptr, dtype=torch.bool, device=dev)
    rows = torch.arange(F, dtype=torch.int32, device=dev)
    before = A.kv_cached_attention.launches
    with pytest.raises(ValueError, match="kernel built for"):
        A.kv_cached_attention(z(B, Nq, c), z(B, F, L, P, c), z(F, L, P, c), rows,
                              z(B, Nptr, c), z(B, F, P, dv), z(B, Nptr, dv), mask, 0)
    assert A.kv_cached_attention.launches == before


# ---------------------------------------------------------------------------
# Hiera encoder kernels: window attention (B5/B6), fused MLP (B7), fused
# block (B8). bf16 is held against the twin run on the same bf16 values, with
# the same rounding points, to 1e-2 of the largest |output|; fp32 to 1e-4.
# ---------------------------------------------------------------------------

from medsam2_tpu_torch.ops import fused_block as FB  # noqa: E402
from medsam2_tpu_torch.ops import fused_mlp as FM  # noqa: E402
from medsam2_tpu_torch.ops import window_attention as WA  # noqa: E402

WINDOW_CASES = [
    # (B, Hp, Wp, heads, ws): hiera_t @1024 blocks 4/6/8 (64 -> 70) and 11
    # (32 -> 35), and a small two-image case with non-square window grids
    (1, 70, 70, 4, 14),
    (1, 35, 35, 8, 7),
    (2, 14, 21, 1, 7),
    # nuclei_256 (hiera_s @256): stage 3 (16 -> 28, ws 14, 4 heads) and
    # stage 4 (8 -> 14, ws 7, 8 heads)
    (1, 28, 28, 4, 14),
    (1, 14, 14, 8, 7),
]


@pytest.mark.parametrize("ws", list(range(1, 15)))
def test_window_attention_every_window_size_bf16(dev, ws):
    """Every window size the bf16 kernel is built for at head dim 96 (1 to
    14, one instantiation each): two images of 2 x 3 windows, 2 heads."""
    rng = np.random.default_rng(14)
    qkv = _t(rng, (2, 2 * ws, 3 * ws, 3 * 96 * 2), dev, torch.bfloat16)
    before = A.launch_counts()["window_attention"]
    got = WA.window_attention(qkv, 2, ws)
    torch.cuda.synchronize()
    assert A.launch_counts()["window_attention"] == before + 1
    want = WA.window_attention_plain(qkv.float(), 2, ws)
    assert (got.float() - want).abs().max().item() <= _tol(want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,ws", [(d, ws) for d in (56, 72) for ws in WA.WINDOW_BUILT[d]],
                         ids=lambda v: str(v))
def test_window_attention_hiera_bl_head_dims(dev, dtype, d, ws):
    """hiera_b+ (d 56) and hiera_l (d 72) at every window size built: two
    images of 2 x 3 windows, 3 heads; channels past d come from the next
    head, so a kernel that summed them would miss."""
    rng = np.random.default_rng(17)
    heads = 3
    qkv = _t(rng, (2, 2 * ws, 3 * ws, 3 * d * heads), dev, dtype)
    got = WA.window_attention(qkv, heads, ws)
    torch.cuda.synchronize()
    want = WA.window_attention_plain(qkv.float(), heads, ws)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= _tol(want, dtype)


def _linear_w(rng, out_dim, in_dim, dev):
    b = in_dim ** -0.5
    return (torch.from_numpy(rng.uniform(-b, b, (out_dim, in_dim)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(-b, b, out_dim).astype(np.float32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_window_attention_kernel_matches_twin(dev, dtype, case):
    B, Hp, Wp, heads, ws = case
    rng = np.random.default_rng(6)
    qkv = _t(rng, (B, Hp, Wp, 3 * 96 * heads), dev, dtype)
    before = A.launch_counts()["window_attention"]
    got = WA.window_attention(qkv, heads, ws)
    got_v2 = WA.window_attention_v2(qkv, heads, ws)
    torch.cuda.synchronize()
    assert A.launch_counts()["window_attention"] == before + 2
    want = WA.window_attention_plain(qkv.float(), heads, ws)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= _tol(want, dtype)
    assert torch.equal(got, got_v2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,C", [(65536, 96), (16384, 192), (4096, 384), (1024, 768),
                                 (1000, 96), (77, 768),
                                 # hiera_b+ and hiera_l widths @1024
                                 (16384, 112), (4096, 224), (1024, 448), (1024, 896),
                                 (16384, 144), (4096, 288), (4096, 576), (1024, 1152),
                                 (300, 1152),
                                 # nuclei_256: stage 2's pooling block, stage 3's blocks
                                 (1024, 192), (256, 384)], ids=lambda v: str(v))
def test_fused_mlp_kernel_matches_twin(dev, dtype, N, C):
    rng = np.random.default_rng(7)
    x = _t(rng, (N, C), dev, dtype)
    g = 1 + 0.1 * _t(rng, (C,), dev, torch.float32)
    b = 0.1 * _t(rng, (C,), dev, torch.float32)
    (w1, b1), (w2, b2) = _linear_w(rng, 4 * C, C, dev), _linear_w(rng, C, 4 * C, dev)
    before = A.launch_counts()["fused_mlp"]
    got = FM.ln_mlp_residual(x, g, b, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert A.launch_counts()["fused_mlp"] == before + 1
    want = FM.ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2)
    assert got.shape == (N, C) and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= _tol(want.float(), dtype)


def _block_params(rng, C, dev):
    g1, g2 = (1 + 0.1 * _t(rng, (C,), dev, torch.float32) for _ in range(2))
    b1, b2 = (0.1 * _t(rng, (C,), dev, torch.float32) for _ in range(2))
    wq, bq = _linear_w(rng, 3 * C, C, dev)
    wp, bp = _linear_w(rng, C, C, dev)
    w1, bm1 = _linear_w(rng, 4 * C, C, dev)
    w2, bm2 = _linear_w(rng, C, 4 * C, dev)
    return FB.BlockParams(g1, b1, wq, bq, wp, bp, g2, b2, w1, bm1, w2, bm2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Bn,ws,C,heads", [
    (1024, 8, 96, 1), (1024, 4, 192, 2), (5, 4, 192, 2), (3, 8, 96, 1),
    # hiera_b+ (d 56) and hiera_l (d 72) blocks @1024: the launch sequence
    (1024, 8, 112, 2), (1024, 4, 224, 4), (1024, 8, 144, 2), (1024, 4, 288, 4),
    (16, 16, 576, 8), (16, 8, 1152, 16), (3, 16, 576, 8),
    # nuclei_256 (hiera_s @256): stage 1 (4096 rows) and stage 2 (1024 rows)
    (64, 8, 96, 1), (64, 4, 192, 2)], ids=lambda v: str(v))
def test_fused_block_kernel_matches_twin(dev, dtype, Bn, ws, C, heads):
    """hiera_t @1024 blocks 0 and 2, ragged 64-row groups (5 ws-4 windows =
    80 rows; 3 ws-8 windows), every hiera_b+ / hiera_l width, and the two
    fused blocks of nuclei_256."""
    rng = np.random.default_rng(8)
    wins = _t(rng, (Bn, ws, ws, C), dev, dtype)
    p = _block_params(rng, C, dev)
    before = A.launch_counts()["fused_block"]
    got = FB.fused_window_block(wins, p, heads)
    torch.cuda.synchronize()
    assert A.launch_counts()["fused_block"] == before + 1
    want = FB.fused_window_block_plain(wins.reshape(-1, C), p, heads, ws * ws).reshape(wins.shape)
    assert got.shape == wins.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= _tol(want.float(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_kernels_backward_is_the_twins_autograd(dev, dtype):
    """B7 and B8 under autograd on the card: the forward launches the
    kernel, the backward re-runs the twin (no launch), and the gradients
    equal autograd through the twin on the same inputs; fp32 to 1e-4 of
    max|grad|, bf16 to 1e-2 (the forward outputs differ by the kernel's
    rounding, the backward is the same code)."""
    rng = np.random.default_rng(21)
    C, heads, ws = 96, 1, 8
    x = _t(rng, (16, ws, ws, C), dev, dtype)
    p = _block_params(rng, C, dev)
    g = _t(rng, (16, ws, ws, C), dev, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, fn, twin in (
            ("fused_block", lambda a, w: FB.fused_window_block(a, FB.BlockParams(*w), heads),
             lambda a, w: FB.fused_window_block_plain(a.reshape(-1, C), FB.BlockParams(*w),
                                                      heads, ws * ws).reshape(a.shape)),
            ("fused_mlp", lambda a, w: FM.ln_mlp_residual(a, *w[6:]),
             lambda a, w: FM.ln_mlp_residual_plain(a.reshape(-1, C), *w[6:]).reshape(a.shape))):
        grads, launched = [], []
        for f in (fn, twin):
            a = x.clone().requires_grad_()
            w = [t.clone().requires_grad_() for t in p]
            before = A.launch_counts()[name]
            (f(a, w).float() * g.float()).sum().backward()
            torch.cuda.synchronize()
            launched.append(A.launch_counts()[name] - before)
            grads.append([a.grad] + [t.grad for t in w if t.grad is not None])
        assert launched == [1, 0]                  # forward only: the backward is the twin's
        for got, want in zip(*grads):
            assert _rel_err(got, want) <= tol, (name, _rel_err(got, want))


# nuclei training at nuclei_256 (hiera_s @256) and batch 4: B8 on stage 1
# (16384 rows, C 96, ws 8) and stage 2 (4096 rows, C 192, ws 4); B7 on the
# rows the JAX dispatch sends (stage 2's pooling block, stages 3 and 4)
NUCLEI_TRAIN_BLOCKS = [(256, 8, 96, 1), (256, 4, 192, 2)]
NUCLEI_TRAIN_MLPS = [(4096, 192), (1024, 384), (256, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [("fused_block", c) for c in NUCLEI_TRAIN_BLOCKS]
                         + [("fused_mlp", c) for c in NUCLEI_TRAIN_MLPS], ids=lambda c: str(c))
def test_fused_kernels_under_autograd_at_nuclei_train_shapes(dev, dtype, case):
    """B7 / B8 under autograd at the nuclei training path's batch-4 shapes:
    the forward is the kernel's (one launch) and agrees with the twin as in
    the forward tests; the input and weight gradients equal autograd
    through the twin on the same inputs (fp32 to 1e-4 of max|grad|, bf16
    to 1e-2: the backward is the same code, fed the kernel's saved
    inputs)."""
    name, shape = case
    rng = np.random.default_rng(23)
    if name == "fused_block":
        Bn, ws, C, heads = shape
        x = _t(rng, (Bn, ws, ws, C), dev, dtype)
        p = _block_params(rng, C, dev)
        fn = lambda a, w: FB.fused_window_block(a, FB.BlockParams(*w), heads)  # noqa: E731
        twin = lambda a, w: FB.fused_window_block_plain(  # noqa: E731
            a.reshape(-1, C), FB.BlockParams(*w), heads, ws * ws).reshape(a.shape)
    else:
        N, C = shape
        x = _t(rng, (N, C), dev, dtype)
        g0 = 1 + 0.1 * _t(rng, (C,), dev, torch.float32)
        b0 = 0.1 * _t(rng, (C,), dev, torch.float32)
        p = (g0, b0, *_linear_w(rng, 4 * C, C, dev), *_linear_w(rng, C, 4 * C, dev))
        fn = lambda a, w: FM.ln_mlp_residual(a, *w)  # noqa: E731
        twin = lambda a, w: FM.ln_mlp_residual_plain(a, *w)  # noqa: E731
    g = _t(rng, x.shape, dev, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    outs, grads, launched = [], [], []
    for f in (fn, twin):
        a = x.clone().requires_grad_()
        w = [t.clone().requires_grad_() for t in p]
        before = A.launch_counts()[name]
        y = f(a, w)
        (y.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        launched.append(A.launch_counts()[name] - before)
        outs.append(y.detach())
        grads.append([a.grad] + [t.grad for t in w])
    assert launched == [1, 0]
    assert outs[0].shape == x.shape and outs[0].dtype == dtype
    assert (outs[0].float() - outs[1].float()).abs().max().item() <= _tol(outs[1].float(), dtype)
    assert all(t is not None for t in grads[0])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= tol, (name, shape, _rel_err(got, want))


def test_encoder_kernels_reject_unbuilt_widths(dev):
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    before = A.launch_counts()
    with pytest.raises(ValueError, match="kernel built for"):
        WA.window_attention(z(1, 8, 8, 3 * 64), 1, 4)          # head dim 64
    with pytest.raises(ValueError, match="kernel built for"):
        WA.window_attention(z(1, 12, 12, 3 * 56), 1, 6)        # d 56 at ws 6
    with pytest.raises(ValueError, match="kernel built for"):
        FM.ln_mlp_residual(z(4, 100), z(100), z(100), z(400, 100), z(400), z(100, 400), z(100))
    p = FB.BlockParams(*(z(*t.shape) for t in _block_params(np.random.default_rng(0), 320,
                                                               "cpu")))
    with pytest.raises(ValueError, match="kernel built for"):
        FB.fused_window_block(z(4, 8, 8, 320), p, 4)            # head dim 80
    assert A.launch_counts() == before


@pytest.mark.parametrize("preset", ["sam2_hiera_t", "sam2_hiera_s", "sam2_hiera_b_plus",
                                    "sam2_hiera_l", "nuclei_256"])
def test_encoder_wrappers_take_every_block_the_dispatch_sends(dev, preset):
    """For every block of the preset at its image size (1024; nuclei_256's
    256) that the switches send to a kernel (the fused block, the window
    attention, the fused MLP by the JAX rule), the wrapper launches at that
    block's exact shape in bf16 and agrees with its twin."""
    from medsam2_tpu_torch import configs

    cfg = getattr(configs, preset)()
    rng = np.random.default_rng(18)
    dt = torch.bfloat16
    hw = cfg.image_size // cfg.trunk.patch_stride[0]
    seen = set()
    for spec in cfg.trunk.block_schedule():
        if spec["q_stride"] is not None:
            hw //= spec["q_stride"][0]
        C, heads, ws = spec["dim_out"], spec["num_heads"], spec["window_size"]
        key = (C, heads, ws, hw, spec["q_stride"] is None)
        if key in seen:
            continue
        seen.add(key)
        divides = ws > 0 and hw % ws == 0
        wins_shape = ((hw // ws) ** 2, ws, ws, C) if divides else None
        if divides and FB.fused_window_block_supported(spec, wins_shape):
            wins = _t(rng, wins_shape, dev, dt)
            p = FB.BlockParams(*(t.to(dt) for t in _block_params(rng, C, dev)))
            got = FB.fused_window_block(wins, p, heads)
            want = FB.fused_window_block_plain(wins.reshape(-1, C), p, heads, ws * ws)
            assert (got.reshape(-1, C).float() - want.float()).abs().max().item() <= _tol(
                want.float(), dt), key
            continue
        if ws > 0 and not divides and spec["q_stride"] is None:
            hp = -(-hw // ws) * ws
            qkv = _t(rng, (1, hp, hp, 3 * C), dev, dt)
            got = WA.window_attention(qkv, heads, ws)
            want = WA.window_attention_plain(qkv.float(), heads, ws)
            assert (got.float() - want).abs().max().item() <= _tol(want, dt), key
        if FM._pick_block(hw * hw):
            x = _t(rng, (hw * hw, C), dev, dt)
            (w1, b1), (w2, b2) = _linear_w(rng, 4 * C, C, dev), _linear_w(rng, C, 4 * C, dev)
            g, b = 1 + 0.1 * _t(rng, (C,), dev, dt), 0.1 * _t(rng, (C,), dev, dt)
            args = (x, g, b, w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt))
            got = FM.ln_mlp_residual(*args)
            want = FM.ln_mlp_residual_plain(*args)
            assert (got.float() - want.float()).abs().max().item() <= _tol(want.float(), dt), key
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The bf16 encoder linear (csrc/encoder_linear_sm90.cuh): every B7 / B8
# linear at the four presets' widths @1024, each epilogue at ragged shapes,
# the tile rule, and a chain of fused blocks captured in one CUDA graph.
# The plain product runs in fp32 (TF32 off) on the same bf16 values and is
# rounded as the kernel's epilogue; 1e-2 of the largest |output|.
# ---------------------------------------------------------------------------

from medsam2_tpu_torch.ops import encoder_linear as EL  # noqa: E402

# (rows, C) of every encoder stage of hiera_t / s, b+ and l @1024
PRESET_STAGES = [(65536, 96), (16384, 192), (4096, 384), (1024, 768), (65536, 112),
                 (16384, 224), (4096, 448), (1024, 896), (65536, 144), (16384, 288),
                 (4096, 576), (1024, 1152)]
LINEAR_SHAPES = [(M, N, K, epi, f"{name}-{M}x{C}")
                 for M, C in PRESET_STAGES
                 for name, N, K, epi in (("qkv", 3 * C, C, EL.EPI_BIAS),
                                         ("proj", C, C, EL.EPI_RESIDUAL),
                                         ("fc1", 4 * C, C, EL.EPI_BIAS_GELU),
                                         ("fc2", C, 4 * C, EL.EPI_RESIDUAL))]


def _linear_case(rng, dev, dtype, M, N, K, epi):
    a = _t(rng, (M, K), dev, dtype)
    w, b = _linear_w(rng, N, K, dev)
    w, b = w.to(dtype), b.to(dtype)
    resid = _t(rng, (M, N), dev, dtype) if epi == EL.EPI_RESIDUAL else None
    return a, w, b, resid


def _check_linear(dev, dtype, M, N, K, epi, seed=21):
    rng = np.random.default_rng(seed)
    a, w, b, resid = _linear_case(rng, dev, dtype, M, N, K, epi)
    before = EL.linear.launches
    got = EL.linear(a, w, b, resid, epi)
    torch.cuda.synchronize()
    assert EL.linear.launches == before + 1
    want = EL.linear_plain(a, w, b, resid, epi)
    assert got.shape == (M, N) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want.float(), dtype), (M, N, K, epi, err)


@pytest.mark.parametrize("shape", LINEAR_SHAPES, ids=lambda s: s[4])
def test_linear_kernel_at_every_preset_shape(dev, shape):
    M, N, K, epi, _ = shape
    _check_linear(dev, torch.bfloat16, M, N, K, epi)


@pytest.mark.parametrize("epi", [EL.EPI_BIAS, EL.EPI_BIAS_GELU, EL.EPI_RESIDUAL],
                         ids=["bias", "gelu", "residual"])
@pytest.mark.parametrize("M,N,K", [(1000, 576, 576), (77, 200, 200), (4096, 200, 200),
                                   (300, 1152, 4608), (129, 8, 24), (4096, 1728, 576)],
                         ids=lambda v: str(v))
def test_linear_kernel_every_epilogue_at_ragged_shapes(dev, epi, M, N, K):
    """Rows that do not fill a 128-row tile, N that no allowed tile width
    divides (the TMA store clips the last column tile), K past the last
    whole 64-wide chunk; bf16 on the persistent kernel, fp32 on FMA."""
    _check_linear(dev, torch.bfloat16, M, N, K, epi)
    _check_linear(dev, torch.float32, min(M, 1000), N, min(K, 576), epi)


def test_linear_kernel_rejects_untaken_shapes(dev):
    from medsam2_tpu_torch.ops._build import load_library

    z = lambda *shape: torch.zeros(shape, device=dev, dtype=torch.bfloat16)  # noqa: E731
    with pytest.raises(ValueError, match="kernel built for"):
        EL.linear(z(4, 16), z(12, 16), z(12))                 # N not a multiple of 8
    with pytest.raises(ValueError, match="kernel built for"):
        EL.linear(z(4, 12), z(16, 12), z(16))                 # K not a multiple of 8
    lib = load_library()
    a, w, b, out = z(64, 72), z(64, 72), z(64), z(64, 64)
    stream = torch.cuda.current_stream().cuda_stream
    call = lambda a_ptr, K: lib.medsam2_encoder_linear(  # noqa: E731
        a_ptr, w.data_ptr(), b.data_ptr(), None, out.data_ptr(), 64, 64, K, 0, 1, stream)
    assert call(a.data_ptr(), 72) == 0
    assert call(a.data_ptr() + 2, 72) != 0                   # a misaligned by one element
    assert call(a.data_ptr(), 68) != 0                       # K not a multiple of 8
    torch.cuda.synchronize()


def test_linear_tile_rule_matches_its_python_restatement(dev):
    from medsam2_tpu_torch.ops._build import load_library

    lib = load_library()
    for sms in (132, 114):
        for M in (1, 77, 1000, 1024, 4096, 16384, 65536):
            for N in list(range(8, 520, 8)) + [576, 864, 1152, 1728, 2304, 3456, 4608]:
                for K in (96, 4608):
                    assert lib.medsam2_linear_tile_n(M, N, K, sms) == EL.tile_n(M, N, K, sms), (
                        M, N, K, sms)


@pytest.mark.parametrize("Bn,ws,C,heads", [(16, 16, 576, 8), (64, 8, 96, 1), (16, 8, 1152, 16)],
                         ids=lambda v: str(v))
def test_fused_block_chain_in_one_graph(dev, Bn, ws, C, heads):
    """Eight bf16 blocks with their own weights, captured in one CUDA graph
    and replayed twice on new inputs: each block's output against the twin
    on that block's own input, so a launch that read its input before the
    previous one had written it would miss."""
    rng = np.random.default_rng(31)
    dt = torch.bfloat16
    params = [FB.BlockParams(*(t.to(dt) for t in _block_params(rng, C, dev))) for _ in range(8)]
    x0 = _t(rng, (Bn, ws, ws, C), dev, dt)

    def chain():
        outs, y = [], x0
        for p in params:
            y = FB.fused_window_block(y, p, heads)
            outs.append(y)
        return outs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = chain()
    for trial in range(2):
        x0.copy_(_t(rng, (Bn, ws, ws, C), dev, dt))
        graph.replay()
        torch.cuda.synchronize()
        prev = x0
        for i, (p, got) in enumerate(zip(params, outs)):
            want = FB.fused_window_block_plain(prev.reshape(-1, C), p, heads, ws * ws)
            err = (got.reshape(-1, C).float() - want.float()).abs().max().item()
            assert err <= _tol(want.float(), dt), (trial, i, err)
            prev = got
    del graph


# ---------------------------------------------------------------------------
# the last slice on the card: the host C++ on the card's host, goldens card
# against CPU, and the dry run's two ranks over gloo on CUDA tensors
# ---------------------------------------------------------------------------

TOL_GOLDEN = 1e-3


def test_native_builds_and_matches_numpy_on_the_card_host(dev):
    from medsam2_tpu_torch import native
    from medsam2_tpu_torch.ops import nms as NMS
    from medsam2_tpu_torch.postproc import amg_utils as AU

    assert native.build().exists()
    rng = np.random.default_rng(1)
    boxes = rng.uniform(0, 200, (300, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 40, (300, 2))
    scores = rng.random(300).astype(np.float32)
    np.testing.assert_array_equal(NMS.nms(boxes, scores, 0.5), NMS.nms_np(boxes, scores, 0.5))
    pts = rng.uniform(0, 300, (400, 2)).astype(np.float32)
    np.testing.assert_array_equal(NMS.point_nms(pts, scores[:1].repeat(400), 9.0),
                                  NMS.point_nms_np(pts, scores[:1].repeat(400), 9.0))
    masks = rng.random((3, 40, 50)) > 0.6
    assert AU.mask_to_rle(masks) == AU.mask_to_rle_np(masks)


def _golden_cfg():
    from medsam2_tpu_torch.configs import sam2_hiera_t

    return sam2_hiera_t(image_size=256, compute_dtype="float32")


@pytest.mark.parametrize("switches", ["0", "1"], ids=["switches_off", "switches_on"])
def test_goldens_on_the_card_match_the_cpu(dev, monkeypatch, switches):
    """``dump_goldens`` (sam2_hiera_t @256 fp32, TF32 off) on the card,
    with the encoder switches off and on, against the CPU's plain path."""
    from medsam2_tpu_torch.checkpoint.goldens import compare_goldens, dump_goldens
    from medsam2_tpu_torch.core.sam2_model import SAM2Model

    cfg = _golden_cfg()
    want = dump_goldens(SAM2Model(cfg, seed=0, device="cpu"), seed=1)
    for name in ("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_WINDOW", "MEDSAM2_FUSED_MLP"):
        monkeypatch.setenv(name, switches)
    A.reset_launch_counts()
    got = dump_goldens(SAM2Model(cfg, seed=0, device=dev), seed=1)
    counts = A.launch_counts()
    diffs = compare_goldens(got, want, atol=TOL_GOLDEN)
    assert len(diffs) == 9
    if switches == "1":
        assert counts["fused_block"] + counts["fused_mlp"] + counts["window_attention"] > 0
    else:
        assert counts["fused_block"] == counts["fused_mlp"] == counts["window_attention"] == 0


def test_dryrun_two_ranks_over_gloo_on_the_card(dev):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU), data x model 2 x 1, against the single process: the dry run's own
    checks (loss, every update, the streamed logits)."""
    from medsam2_tpu_torch.parallel import dryrun

    # @512: 1024 tokens a frame, so the memory attention reaches the flash gate
    out = dryrun.dryrun_distributed(2, model_axis=1, device="cuda",
                                    cfg=dryrun.default_config(),
                                    shape=dryrun.DryrunShape(volumes=2, frames=4, objects=1))
    assert out["mesh"] == {"data": 2, "model": 1}
    for o in out["ranks"].values():
        assert o["step_counts"]["flash_attention_bwd_dq"] > 0
        assert o["stream_counts"]["kv_cached_attention"] > 0
