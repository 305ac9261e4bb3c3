"""Data x model parallel training on ``torch.distributed``
(``medsam2_tpu_torch/parallel``) against the JAX package's mesh, on the CPU.

- ``process_local_batch`` against JAX's at several process counts.
- The sharding rule against JAX's ``param_sharding`` name by name on TINY
  at a model axis of 2 (and 3, where no width of TINY divides): each JAX spec is carried into the reference layout through
  ``state_dict_from_jax`` and must slice the same dimension. The one
  divergence is the mask decoder's two-way MLPs, where JAX indexes the
  block instead of the MLP layer (``parallel/mesh.py``).
- ``dryrun_distributed(2, model_axis=1)`` and ``(2, model_axis=2)``: two
  spawned ranks over gloo against this process alone, loss to 1e-4, every
  update to rtol 5e-3 / atol ``max(1e-5, 1e-2 * scale)``, streamed logits
  to 1e-3 (the dry run's own checks); the ranks load neither JAX nor the
  JAX package.
- ``-distributed data`` at one process through both CLIs trains, as in JAX
  (the flag changes nothing there).
"""

import numpy as np
import pytest
import torch

import jax
from medsam2_tpu.core.sam2_model import sam2_init
from medsam2_tpu.parallel import mesh as jmesh
from medsam2_tpu_torch.checkpoint.convert import state_dict_from_jax
from medsam2_tpu_torch.configs import FpnNeckConfig, HieraConfig, SAM2Config
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.parallel import dryrun
from medsam2_tpu_torch.parallel import mesh as tmesh
from tests.test_predictors import TINY

torch.set_num_threads(2)

# TINY of tests/test_predictors.py in the port's config classes (spawned
# ranks unpickle it without the JAX package)
PORT_TINY = SAM2Config(
    trunk=HieraConfig(embed_dim=8, stages=(1, 1, 1, 1), window_spec=(2, 2, 2, 2),
                      global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(3, 3)),
    neck=FpnNeckConfig(backbone_channel_list=(64, 32, 16, 8)),
    image_size=64, compute_dtype="float32")
# where JAX reads the two-way block's index as the MLP layer's
TWO_WAY_DIVERGENCE = {"sam_mask_decoder.transformer.layers.0.mlp.layers.1.weight": (0, 1),
                      "sam_mask_decoder.transformer.layers.1.mlp.layers.0.weight": (1, 0)}


def test_process_local_batch_matches_jax(monkeypatch):
    for n, batch in ((1, 7), (2, 8), (4, 32)):
        monkeypatch.setattr(tmesh, "process_count", lambda n=n: n)
        monkeypatch.setattr(jax, "process_count", lambda n=n: n)
        assert tmesh.process_local_batch(batch) == jmesh.process_local_batch(batch)
    with pytest.raises(AssertionError):
        jmesh.process_local_batch(30)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.process_local_batch(30)


def _jax_specs_in_port_layout(model_axis: int):
    """JAX's spec of every leaf, carried to the reference names: each leaf
    is filled with its index along the sharded axis (zeros if replicated),
    converted, and the axis along which the values vary read back."""
    params = jax.eval_shape(lambda: sam2_init(jax.random.PRNGKey(0), TINY))
    mesh = jmesh.make_mesh(model_axis, model_axis=model_axis)
    shardings = jmesh.param_sharding(params, mesh)

    def code(leaf, sharding):
        spec = tuple(sharding.spec)
        out = np.zeros(leaf.shape, np.float32)
        for axis, name in enumerate(spec):
            if name == "model":
                shape = [1] * len(leaf.shape)
                shape[axis] = leaf.shape[axis]
                out = out + np.arange(1, leaf.shape[axis] + 1, dtype=np.float32).reshape(shape)
        return out

    coded = jax.tree_util.tree_map(code, params, shardings)
    specs = {}
    for name, a in state_dict_from_jax(coded, TINY).items():
        varying = [ax for ax in range(a.ndim) if a.shape[ax] > 1
                   and not np.all(a == np.take(a, [0], axis=ax))]
        assert len(varying) <= 1, name
        specs[name] = varying[0] if varying else None
    return specs


@pytest.mark.parametrize("model_axis", [2, 3])
def test_sharding_rule_matches_jax(model_axis):
    want = _jax_specs_in_port_layout(model_axis)
    model = SAM2Model(PORT_TINY, seed=0, device="cpu")
    got = tmesh.param_specs(model, model_axis)
    # a JAX parameter the port holds as a buffer (the prompt encoder's
    # Fourier matrix) is replicated in both
    buffers = set(want) - set(got)
    assert buffers <= set(dict(model.named_buffers()))
    assert all(want[n] is None for n in buffers)
    want = {n: want[n] for n in got}
    diff = {n: (want[n], got[n]) for n in got if got[n] != want[n]}
    expected = TWO_WAY_DIVERGENCE if model_axis == 2 else {}
    assert diff == expected
    sliced = {n for n, d in got.items() if d is not None}
    if model_axis == 3:      # no width of TINY divides by 3
        assert not sliced
        return
    assert got["memory_attention.layers.0.linear1.weight"] == 0
    assert got["memory_attention.layers.0.linear1.bias"] == 0
    assert got["memory_attention.layers.0.linear2.weight"] == 1
    assert got["memory_attention.layers.0.linear2.bias"] is None
    # the MLPs' first biases stay whole, as in JAX (sliced in the forward)
    assert got["sam_mask_decoder.transformer.layers.0.mlp.layers.0.bias"] is None
    assert len(sliced) == 38


@pytest.mark.parametrize("model_axis", [1, 2])
def test_dryrun_two_ranks_match_one(model_axis):
    out = dryrun.dryrun_distributed(
        2, model_axis=model_axis, device="cpu", cfg=PORT_TINY,
        shape=dryrun.DryrunShape(volumes=2, frames=4, objects=2))
    assert out["mesh"] == {"data": 2 // model_axis, "model": model_axis}
    sliced = out["sharded"]["sliced"]
    if model_axis == 2:
        # every rule-sliced parameter of TINY is sliced: 38 tensors, as JAX shards 38 leaves
        assert len(sliced) == 38
        assert "memory_encoder.fuser.layers.0.pwconv1.weight" in sliced
    else:
        assert sliced == []
    assert out["errors"]["max_update"] > 0
    assert out["sharded"]["masks"].shape == (2, 4, 1, 1, 16, 16)


def test_shard_model_slices_and_gathers():
    """At one process a model axis of 1 leaves the model alone; the encoder
    switches refuse a model-sharded trunk."""
    model = SAM2Model(PORT_TINY, seed=0, device="cpu")
    mesh = tmesh.make_mesh(model_axis=1)
    assert (mesh.shape, mesh.rank, mesh.data_group) == ({"data": 1, "model": 1}, 0, None)
    before = {n: p.clone() for n, p in model.state_dict().items()}
    tmesh.shard_model(model, mesh)
    assert all(torch.equal(before[n], p) for n, p in model.state_dict().items())
    assert tmesh.full_named(model, before).keys() == before.keys()
    np.testing.assert_array_equal(mesh.data_shard(np.arange(6)), np.arange(6))
    two = tmesh.Mesh(1, 2, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDSAM2_FUSED_MLP", "1")
        with pytest.raises(ValueError, match="switches off"):
            tmesh.shard_model(model, two)


def test_distributed_data_at_one_process_trains(tmp_path, monkeypatch):
    import medsam2_tpu_torch.cli.train_2d as t2
    import medsam2_tpu_torch.cli.train_3d as t3

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(t3, "get_config", lambda name, **kw: TINY)
    model = t3.main(["-distributed", "data", "-dataset", "synthetic", "-image_size", "64",
                     "-video_length", "4", "-prompt_freq", "2", "-prompt", "bbox",
                     "-max_objects", "2", "-epochs", "1", "-steps_per_epoch", "1",
                     "-val_freq", "0", "-b", "1", "-device", "cpu",
                     "-logdir", str(tmp_path / "3d")])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(t2, "get_config", lambda name, **kw: TINY)
    model = t2.main(["-distributed", "2x1", "-dataset", "synthetic", "-image_size", "64",
                     "-out_size", "64", "-b", "2", "-epochs", "1", "-steps_per_epoch", "1",
                     "-val_max_samples", "1", "-device", "cpu", "-logdir", str(tmp_path / "2d")])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    log = next((tmp_path / "2d").glob("*/Log/*.log")).read_text()
    assert "-distributed 2x1 is ignored by the 2D CLI" in log


def test_torchrun_model_axis_cli(tmp_path):
    """``torchrun`` launches the 3D CLI on two CPU ranks at ``-distributed
    1x2`` (sam2_hiera_t @64, the smallest preset run): both ranks log the
    same losses at every step (a model group computes one step), and rank 0
    alone writes a checkpoint holding the whole weights and Adam state."""
    import os
    import re
    import socket
    import subprocess
    import sys

    from medsam2_tpu_torch.configs import get_config

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(port), "-m", "medsam2_tpu_torch.cli.train_3d",
           "-distributed", "1x2", "-dataset", "synthetic", "-sam_config", "sam2_hiera_t",
           "-image_size", "64", "-video_length", "2", "-prompt", "bbox", "-b", "2",
           "-epochs", "1", "-steps_per_epoch", "2", "-val_freq", "0", "-print_freq", "1",
           "-device", "cpu", "-logdir", str(tmp_path)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-4000:]
    runs = {("rank1" in d.name): d for d in tmp_path.iterdir()}
    assert set(runs) == {False, True}
    losses = [re.findall(r"step \d: loss: ([\d.]+)", next(runs[r].glob("Log/*.log")).read_text())
              for r in (False, True)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert not list(runs[True].glob("Model/*.pt"))
    ckpt = torch.load(next(runs[False].glob("Model/step_0.pt")), weights_only=True)
    want = SAM2Model(get_config("sam2_hiera_t", image_size=64), device="cpu").state_dict()
    assert {k: v.shape for k, v in ckpt["model"].items()} == {k: v.shape
                                                              for k, v in want.items()}
    state = ckpt["optimizers"]["mem"]["state"]
    assert any(t.shape == (2048, 256) for st in state.values() for t in st.values()
               if torch.is_tensor(t))
