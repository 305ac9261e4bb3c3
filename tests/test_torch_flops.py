"""The port's FLOP counts (``medsam2_tpu_torch/utils/flops.py``) against the
JAX package's: every analytic count, for every preset of ``configs.py`` at
two image sizes and two bank sizes, equal as floats (the same arithmetic in
the same order)."""

import pytest

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
