"""The frozen analytic counts equal the port's ``utils/flops.py`` today, and
the cell's per-call counts add up."""

import json

import pytest

from conftest import REPO
from portbench.counts import flops as frozen
from portbench.counts import propagation
from portbench.counts.peaks import bound_seconds, peaks
from portbench.reference.arch import arch


@pytest.mark.parametrize("preset,size", [("sam2_hiera_s", 1024), ("nuclei_256", 256),
                                         ("sam2_hiera_t", 1024), ("sam2_hiera_l", 1024)])
def test_frozen_counts_equal_the_ports(preset, size):
    from medsam2_tpu_torch.configs import get_config
    from medsam2_tpu_torch.state import memory_bank as mb
    from medsam2_tpu_torch.utils import flops as port

    cfg = get_config(preset, image_size=size)
    spec = mb.BankSpec.from_config(cfg)
    assert frozen.propagation_flops(cfg, spec, 2) == port.propagation_flops(cfg, spec, 2)
    for name in ("_hiera_flops", "_neck_flops", "_sam_heads_flops", "_memory_encoder_flops"):
        assert getattr(frozen, name)(cfg) == getattr(port, name)(cfg)
    assert frozen._memory_attention_flops(cfg, 777) == port._memory_attention_flops(cfg, 777)


def test_config_namespace_counts_as_the_port_config():
    from medsam2_tpu_torch.configs import get_config

    doc = json.loads((REPO / "portbench/configs/sam2_hiera_s_1024.json").read_text())
    a, cfg = arch(doc["model"]), get_config("sam2_hiera_s")
    for name in ("_hiera_flops", "_neck_flops", "_sam_heads_flops", "_memory_encoder_flops"):
        assert getattr(frozen, name)(a) == getattr(frozen, name)(cfg)
    assert a.trunk.block_schedule() == cfg.trunk.block_schedule()


def test_call_counts():
    doc = json.loads((REPO / "portbench/configs/sam2_hiera_s_1024.json").read_text())
    a = arch(doc["model"])
    assert propagation.memory_tokens(a, 1, 32) == (1, 1)
    assert propagation.memory_tokens(a, 3, 32) == (3, 3)
    assert propagation.memory_tokens(a, 31, 32) == (7, 16)
    c = propagation.call_flops(a, 4, 32)
    parts = c["image_encoder"] + c["memory_attention"]
    assert 0 < parts < c["total"]
    # the hiera_s @1024 encoder is ~0.2-0.4 TFLOP an image (a third of the
    # 786 GFLOP that the full-bank count gives a tracked slice)
    assert 1.5e11 < propagation.encoder_flops(a) < 4e11
    assert c["total"] / (4 * 32) < 786e9


def test_peaks_and_bound():
    assert peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert peaks("NVIDIA H100 PCIe")[0] == 756e12
    assert peaks("cpu") is None
    assert bound_seconds(989e12, 1.0, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert bound_seconds(1.0, 3.35e12, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
