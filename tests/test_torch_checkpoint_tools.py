"""The port's checkpoint export and golden tensors
(``medsam2_tpu_torch/checkpoint/{export,goldens}.py``) against the JAX
package, on TINY. The weights are the port's seeded init, carried into a
JAX tree by the JAX package's own reader of reference state dicts
(``convert_state_dict``), so no JAX init runs.

- Export: the port's ``.pt`` reads through JAX's ``load_params`` into a
  tree that the port's ``state_dict_from_jax`` maps back onto the exported
  state dict, bit for bit.
- Goldens: the port's ``dump_goldens`` against JAX's on the same weights and
  seed: the same keys, the same inputs, every ``out_`` array to 1e-4 abs
  (the JAX modules jitted here, one compile each, where eager dispatch
  compiles op by op).
- The checkpoint-parity dry run of ``tests/test_goldens.py`` on the port:
  export -> ``.pt`` -> the port's ``load_params`` -> goldens equal to the
  direct ones at 1e-5; the CLIs; ``compare_goldens`` catches a perturbed
  weight.
"""

import jax
import numpy as np
import pytest
import torch

from medsam2_tpu.checkpoint import goldens as JG
from medsam2_tpu.checkpoint.convert import convert_state_dict
from medsam2_tpu.checkpoint.store import load_params as jax_load_params
from medsam2_tpu.core import sam2_model as JS
from medsam2_tpu_torch.checkpoint import export as TE
from medsam2_tpu_torch.checkpoint import goldens as TG
from medsam2_tpu_torch.checkpoint.convert import state_dict_from_jax
from medsam2_tpu_torch.checkpoint.store import load_params
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from tests.test_predictors import TINY

torch.set_num_threads(2)
TOL_JAX = 1e-4
TOL_ROUND_TRIP = 1e-5


@pytest.fixture(scope="module")
def weights():
    model = SAM2Model(TINY, seed=1, device="cpu")
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, TINY)
    return params, model


def test_export_reads_back_through_jax(weights, tmp_path):
    _, model = weights
    path = str(tmp_path / "model.pt")
    TE.export_to_torch(model, path)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jax_load_params(path, TINY)), TINY)
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_goldens_match_jax(weights, monkeypatch):
    params, model = weights
    monkeypatch.setattr(JS, "forward_image", jax.jit(JS.forward_image, static_argnums=1))
    monkeypatch.setattr(JS, "forward_sam_heads",
                        jax.jit(JS.forward_sam_heads, static_argnums=1,
                                static_argnames=("multimask_output",)))
    monkeypatch.setattr(JS, "encode_new_memory",
                        jax.jit(JS.encode_new_memory, static_argnums=(1, 4)))
    want = JG.dump_goldens(params, TINY, seed=3)
    got = TG.dump_goldens(model, seed=3)
    assert got.keys() == want.keys()
    for k in want:
        if not k.startswith("out_"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    diffs = TG.compare_goldens(got, want, atol=TOL_JAX)
    assert len(diffs) == len([k for k in want if k.startswith("out_")]) == 9


def test_checkpoint_parity_dry_run(weights, tmp_path):
    """Export, reload through the port's ``load_params`` (a checkpoint file
    with ``{"model": ...}``), and the goldens match the direct ones; a
    moved weight is caught."""
    _, model = weights
    pt = tmp_path / "synthetic_sam2.pt"
    TE.export_to_torch(model, str(pt))
    reloaded = SAM2Model(TINY, seed=5, device="cpu")
    load_params(str(pt), reloaded)
    direct = TG.dump_goldens(model)
    diffs = TG.compare_goldens(direct, TG.dump_goldens(reloaded), atol=TOL_ROUND_TRIP)
    assert diffs and max(diffs.values()) <= TOL_ROUND_TRIP
    with torch.no_grad():
        reloaded.no_mem_embed += 0.5
    with pytest.raises(AssertionError, match="golden mismatch"):
        TG.compare_goldens(direct, TG.dump_goldens(reloaded), atol=1e-3)
    np.savez_compressed(tmp_path / "g.npz", **direct)
    TG.compare_goldens(direct, dict(np.load(tmp_path / "g.npz")), atol=0)


def test_export_and_goldens_clis(tmp_path, monkeypatch):
    import medsam2_tpu_torch.configs as configs

    monkeypatch.setitem(configs.PRESETS, "tiny", lambda **kw: TINY)
    src = tmp_path / "src.pt"
    TE.export_to_torch(SAM2Model(TINY, seed=2, device="cpu"), str(src))
    TE.main([str(src), str(tmp_path / "out.pt"), "--preset", "tiny", "--device", "cpu"])
    a = torch.load(src, weights_only=True)["model"]
    b = torch.load(tmp_path / "out.pt", weights_only=True)["model"]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    TG.main([str(tmp_path / "g.npz"), "--ckpt", str(src), "--preset", "tiny", "--seed", "2",
             "--device", "cpu"])
    TG.main([str(tmp_path / "g2.npz"), "--preset", "tiny", "--seed", "2", "--device", "cpu"])
    g, g2 = dict(np.load(tmp_path / "g.npz")), dict(np.load(tmp_path / "g2.npz"))
    # without --ckpt the weights are SAM2Model(cfg, seed): seed 2, as src was made
    assert max(TG.compare_goldens(g, g2, atol=0).values()) == 0.0
