"""The port's multi-process dry run (counterpart of ``__graft_entry__.py``
``dryrun_multichip``).

``dryrun_distributed(n, model_axis, device)`` spawns ``n`` ranks over gloo
(which serves CPU and CUDA tensors alike, and lets two ranks share one
card, which NCCL refuses). Each rank builds the same seeded model, slices
it over a ``parallel.mesh`` of (n / model_axis) x model_axis, streams
``volumes`` volumes through ``propagate_volumes_batched`` over the mesh,
then takes one 3D train step on a batch of ``volumes`` volumes split over
the data axis. This process then runs the same stream and step on one
rank, and the two must agree:

- the loss to ``1e-4 * max(1, |loss|)`` (the JAX dry run's bound);
- every parameter's update to rtol 5e-3 and atol ``max(1e-5, 1e-2 *
  max|update|)`` (``tests/test_train_3d.py``'s sharded-step check), frozen
  parameters unchanged;
- the streamed low-res logits to ``MASK_ATOL`` (fp32).

The single-process reference is an eager step, so no golden file is kept
(the JAX package keeps ``dryrun_golden.npz`` because its XLA:CPU compiles
were slow). The default run is sam2_hiera_t @512 fp32 (TF32 off), 4
volumes x 8 frames, 2 objects. Prints one line,
``dryrun_distributed(n) ok: loss=..., mesh={'data': ..., 'model': ...}``.

    python -m medsam2_tpu_torch.parallel.dryrun --n 2 --model_axis 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import queue as queue_mod
import socket
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from medsam2_tpu_torch.api.video_predictor import propagate_volumes_batched
from medsam2_tpu_torch.configs import SAM2Config, sam2_hiera_t
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.data.btcv import pack_to_recipe_batch
from medsam2_tpu_torch.data.synthetic import synthetic_volume
from medsam2_tpu_torch.ops import attention as A
from medsam2_tpu_torch.parallel import mesh as pmesh
from medsam2_tpu_torch.state import memory_bank as mb
from medsam2_tpu_torch.train import recipe_3d

THREADS_PER_RANK = 2     # CPU threads of a spawned rank
RANK_TIMEOUT_S = 900.0
LOSS_RTOL = 1e-4
DELTA_RTOL = 5e-3
DELTA_ATOL_FLOOR = 1e-5
DELTA_ATOL_SCALE = 1e-2
MASK_ATOL = 1e-3


@dataclasses.dataclass(frozen=True)
class DryrunShape:
    volumes: int = 4
    frames: int = 8
    objects: int = 2
    prompt_freq: int = 2


def default_config() -> SAM2Config:
    return sam2_hiera_t(image_size=512, compute_dtype="float32")


def inputs(cfg: SAM2Config, shape: DryrunShape, seed: int):
    """The train batch (``volumes`` synthetic volumes, box prompts on every
    ``prompt_freq``-th frame) and the stream's normalised volumes with one
    click each on frame 0, from ``seed``."""
    rng = np.random.default_rng(seed)
    S, T = cfg.image_size, shape.frames
    samples = [synthetic_volume(rng, T=T, size=S, num_objects=shape.objects, prompt="bbox")
               for _ in range(shape.volumes)]
    batch = pack_to_recipe_batch(samples, T, shape.objects, shape.prompt_freq, S)
    videos = rng.standard_normal((shape.volumes, T, S, S, 3)).astype(np.float32)
    coords = rng.uniform(S * 0.3, S * 0.7, (shape.volumes, 1, 1, 2)).astype(np.float32)
    labels = np.ones((shape.volumes, 1, 1), np.int32)
    return batch, (videos, coords, labels)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: SAM2Config, shape: DryrunShape, device, seed: int = 0,
        mesh: Optional[pmesh.Mesh] = None) -> Dict:
    """One rank's work (or the single-process reference without ``mesh``):
    the stream, a train step from the seeded weights (its parameter updates
    gathered whole), then a second, timed step. Launch counts per stage."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch, stream_args = inputs(cfg, shape, seed)
    model = SAM2Model(cfg, seed=seed, device=device)
    rcfg = recipe_3d.Recipe3DConfig(video_length=shape.frames, prompt_freq=shape.prompt_freq,
                                    num_objects=shape.objects, max_cond_frames=2)
    optimizers = recipe_3d.make_optimizers(model, rcfg)
    if mesh is not None:
        pmesh.shard_model(model, mesh, optimizers)
    spec = mb.BankSpec.from_config(cfg, max_cond_frames=1)

    A.reset_launch_counts()
    masks = propagate_volumes_batched(model, spec, *stream_args, num_objects=1, mesh=mesh)
    _sync(device)
    stream_counts = A.launch_counts()

    def params():
        return pmesh.full_named(model, {n: p.detach().clone()
                                        for n, p in model.named_parameters()})

    before = params()
    step = recipe_3d.make_train_step(model, rcfg, optimizers, mesh=mesh)
    A.reset_launch_counts()
    metrics = step(batch)
    _sync(device)
    step_counts = A.launch_counts()
    after = params()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    deltas = {n: (after[n] - before[n]).double().cpu().numpy() for n in sorted(trainable)}
    frozen_moved = sorted(n for n in after if n not in trainable
                          and not torch.equal(after[n], before[n]))
    t0 = time.perf_counter()
    step(batch)
    _sync(device)
    seconds = time.perf_counter() - t0
    sliced = sorted(n for n, d in pmesh.param_specs(model, 1).items() if d is not None) \
        if mesh is not None and mesh.shape["model"] > 1 else []
    return {"loss": float(metrics["loss"]), "deltas": deltas, "frozen_moved": frozen_moved,
            "sliced": sliced,
            "masks": masks.float().cpu().numpy(), "stream_counts": stream_counts,
            "step_counts": step_counts, "step_seconds": seconds,
            "foreign": sorted(k for k in sys.modules
                              if k.split(".")[0] in ("jax", "medsam2_tpu"))}


def _rank_main(rank: int, n: int, model_axis: int, device: str, port: int, cfg: SAM2Config,
               shape: DryrunShape, seed: int, results) -> None:
    torch.set_num_threads(THREADS_PER_RANK)
    try:
        pmesh.initialize_distributed(f"localhost:{port}", n, rank, backend="gloo")
        mesh = pmesh.make_mesh(n, model_axis=model_axis)
        out = run(cfg, shape, device, seed, mesh)
        if rank != 0:      # rank 0 carries the whole comparison
            out = {k: out[k] for k in ("stream_counts", "step_counts", "step_seconds",
                                       "foreign", "frozen_moved", "sliced")}
        results.put((rank, out))
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """Hold a sharded run's results to the single-process reference's;
    raises on a miss. Returns the largest differences."""
    loss_err = abs(got["loss"] - want["loss"])
    assert np.isfinite(got["loss"]), f"non-finite sharded loss {got['loss']}"
    assert loss_err <= LOSS_RTOL * max(1.0, abs(want["loss"])), (
        f"sharded loss {got['loss']} != single-process loss {want['loss']}")
    assert got["deltas"].keys() == want["deltas"].keys()
    moved = update_err = 0.0
    for name, d_single in want["deltas"].items():
        scale = float(np.abs(d_single).max())
        update_err = max(update_err, float(np.abs(got["deltas"][name] - d_single).max()))
        np.testing.assert_allclose(
            got["deltas"][name], d_single, rtol=DELTA_RTOL,
            atol=max(DELTA_ATOL_FLOOR, DELTA_ATOL_SCALE * scale),
            err_msg=f"sharded update diverges at {name}")
        moved = max(moved, scale)
    assert moved > 0.0, "no parameter moved: the update check is vacuous"
    assert not got["frozen_moved"] and not want["frozen_moved"], (
        f"frozen parameters moved: {got['frozen_moved'] or want['frozen_moved']}")
    assert got["masks"].shape == want["masks"].shape, (got["masks"].shape, want["masks"].shape)
    assert np.isfinite(got["masks"]).all(), "non-finite streamed logits"
    mask_err = float(np.abs(got["masks"] - want["masks"]).max())
    assert mask_err <= MASK_ATOL, f"streamed logits differ by {mask_err} > {MASK_ATOL}"
    return {"loss": loss_err, "mask": mask_err, "update": update_err, "max_update": moved}


def dryrun_distributed(n: int = 2, model_axis: int = 1, device: str = "cuda",
                       cfg: Optional[SAM2Config] = None, shape: DryrunShape = DryrunShape(),
                       seed: int = 0) -> Dict:
    """Spawn ``n`` ranks on a (n / model_axis, model_axis) mesh, run the
    stream and the step on them and on this process alone, compare (module
    docstring), print the one-line verdict and return both sides' numbers:
    ``{"sharded": rank 0's, "ranks": {rank: counts and seconds},
    "single": the reference's, "errors": ..., "mesh": ...}``."""
    cfg = cfg or default_config()
    if n % model_axis or shape.volumes % (n // model_axis):
        raise ValueError(f"{shape.volumes} volumes on {n} ranks with model axis {model_axis}: "
                         "the ranks and volumes must split over the data axis")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, model_axis, device, port, cfg, shape,
                                                  seed, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(got) < n:
            try:
                rank, out = results.get(timeout=5.0)
                got[rank] = out
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"dry-run ranks failed (exit codes {dead}) or timed out")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dry-run ranks exited with {bad}")
    foreign = sorted({m for out in got.values() for m in out["foreign"]})
    assert not foreign, f"a spawned rank loaded {foreign}"
    for out in got.values():
        assert not out["frozen_moved"], f"frozen parameters moved: {out['frozen_moved']}"
    single = run(cfg, shape, device, seed)
    errors = compare(got[0], single)
    mesh_shape = {"data": n // model_axis, "model": model_axis}
    print(f"dryrun_distributed({n}) ok: loss={got[0]['loss']:.6f} == single-process "
          f"{single['loss']:.6f}, updates allclose, streamed logits within "
          f"{errors['mask']:.2e}, mesh={mesh_shape}")
    return {"sharded": got[0], "ranks": got, "single": single, "errors": errors,
            "mesh": mesh_shape}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--model_axis", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_distributed(args.n, args.model_axis, args.device)


if __name__ == "__main__":
    main()
