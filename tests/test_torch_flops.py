"""The port's FLOP counts (``medsam2_tpu_torch/utils/flops.py``) against the
JAX package's: every analytic count, for every preset of ``configs.py`` at
two image sizes and two bank sizes, equal as floats (the same arithmetic in
the same order). ``peak_flops`` reads ``BENCH_PEAK_TFLOPS`` and knows no CPU
peak; ``compiled_flops`` of a plain ``nn.Linear`` is 2 M N K; ``mfu``."""

import pytest
import torch

from medsam2_tpu import configs as JC
from medsam2_tpu.state import memory_bank as JB
from medsam2_tpu.utils import flops as JF
from medsam2_tpu_torch import configs as TC
from medsam2_tpu_torch.state import memory_bank as TB
from medsam2_tpu_torch.utils import flops as TF

CASES = [(name, size, cond) for name in sorted(TC.PRESETS) for size, cond in
         ((1024, 8), (512, 2))]


def test_presets_are_the_same():
    assert sorted(TC.PRESETS) == sorted(JC.PRESETS)


@pytest.mark.parametrize("name,size,cond", CASES)
def test_analytic_counts_equal_jax(name, size, cond):
    jcfg = JC.get_config(name, image_size=size)
    tcfg = TC.get_config(name, image_size=size)
    for fn in ("_hiera_flops", "_neck_flops", "_sam_heads_flops", "_memory_encoder_flops"):
        assert getattr(TF, fn)(tcfg) == getattr(JF, fn)(jcfg), fn
    assert TF._memory_attention_flops(tcfg, 4096) == JF._memory_attention_flops(jcfg, 4096)
    jspec = JB.BankSpec.from_config(jcfg, max_cond_frames=cond)
    tspec = TB.BankSpec.from_config(tcfg, max_cond_frames=cond)
    for objects in (1, 3):
        got = TF.propagation_flops(tcfg, tspec, num_objects=objects)
        want = JF.propagation_flops(jcfg, jspec, num_objects=objects)
        assert got == want
        assert got["total"] > 0


def test_peak_flops_override_and_mfu(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert TF.peak_flops("cpu") is None
    assert TF.mfu(1e12, 1.0, "cpu") is None
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    assert TF.peak_flops() == 500e12
    assert TF.mfu(250e12, 1.0) == pytest.approx(0.5)
    assert TF.mfu(None, 1.0) is None
    assert TF.mfu(1e12, 0.0) is None


def test_peak_table_by_card_name(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert TF.peak_flops("cuda") == peak, name


def test_compiled_flops_of_a_linear():
    M, K, N = 12, 16, 24
    layer = torch.nn.Linear(K, N)
    assert TF.compiled_flops(layer, torch.zeros(M, K)) == 2.0 * M * N * K
