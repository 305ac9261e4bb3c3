"""Weights cross from the JAX package into the PyTorch port: the port's
numpy re-implementation of ``export_state_dict`` equals the JAX package's,
key for key and value for value, and loads into the port's model with
``strict=True``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from medsam2_tpu import configs as JC
from medsam2_tpu.checkpoint.convert import export_state_dict
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu_torch import configs as TC
from medsam2_tpu_torch.checkpoint.convert import (load_reference_state_dict,
                                                  state_dict_from_jax)
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from tests.test_predictors import TINY

torch.set_num_threads(2)


def _port_config(cfg):
    """The port's config with the same field values as a JAX-package config."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw = {k: _port_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(TC, type(cfg).__name__)(**kw)


@pytest.mark.parametrize("cfg", [JC.sam2_hiera_t(), JC.sam2_hiera_t(image_size=512,
                                                                     compute_dtype="float32"),
                                 TINY], ids=["hiera_t", "hiera_t_512_f32", "tiny"])
def test_port_config_equals_jax_config(cfg):
    """The port keeps its own copy of the config dataclasses; same defaults,
    same preset, same derived schedule."""
    for name in ("HieraConfig", "FpnNeckConfig", "MemoryAttentionConfig",
                 "MemoryEncoderConfig", "SAM2Config"):
        assert dataclasses.asdict(getattr(TC, name)()) == dataclasses.asdict(getattr(JC, name)())
    port = _port_config(cfg)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    if cfg.trunk == JC.sam2_hiera_t().trunk:
        kw = {k: getattr(cfg, k) for k in ("image_size", "compute_dtype")}
        assert TC.sam2_hiera_t(**kw) == port
    assert port.trunk.block_schedule() == cfg.trunk.block_schedule()
    for name in ("depth", "stage_ends", "q_pool_blocks", "channel_list"):
        assert getattr(port.trunk, name) == getattr(cfg.trunk, name), name
    for name in ("hidden_dim", "mem_dim", "num_feature_levels", "sam_image_embedding_size",
                 "low_res_mask_size"):
        assert getattr(port, name) == getattr(cfg, name), name


# hiera_t first: TINY then reuses most of its per-shape init compiles
@pytest.mark.parametrize("cfg", [JC.sam2_hiera_t(), TINY], ids=["hiera_t", "tiny"])
def test_state_dict_from_jax_matches_export_and_loads_strict(cfg):
    params = sam2_init(jax.random.PRNGKey(0), cfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    got = state_dict_from_jax(params_np, cfg)
    want = export_state_dict(params, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    model = SAM2Model(_port_config(cfg), seed=1, device="cpu")
    own = model.state_dict()
    assert sorted(own) == sorted(got)
    for k in got:
        assert tuple(own[k].shape) == got[k].shape, k
    load_reference_state_dict(model, got)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)


def test_load_rejects_missing_and_unexpected_keys():
    model = SAM2Model(TINY, seed=0, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    extra = dict(sd, **{"not_a_key": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError):
        load_reference_state_dict(model, extra)
    sd.pop("no_obj_ptr")
    with pytest.raises(RuntimeError):
        load_reference_state_dict(model, sd)


def test_seeded_init_is_reproducible_and_in_jax_ranges():
    a = SAM2Model(TINY, seed=3, device="cpu").state_dict()
    b = SAM2Model(TINY, seed=3, device="cpu").state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # fan-in uniform linears, trunc-normal(0.02) tables, as the JAX init
    w = a["memory_attention.layers.0.linear1.weight"]
    assert w.abs().max() <= 1.0 / np.sqrt(w.shape[1])
    assert a["no_mem_embed"].abs().max() <= 0.04
    assert torch.all(a["image_encoder.trunk.blocks.0.norm1.weight"] == 1)
