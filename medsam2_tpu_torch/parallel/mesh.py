"""Data x model parallelism on ``torch.distributed`` (counterpart of
``medsam2_tpu/parallel/mesh.py``).

One process per rank. The ranks form a (data, model) mesh as JAX's
``make_mesh`` lays its devices out: rank r sits at (r // model, r % model),
so the ranks of one model group are consecutive.

- The **data axis**: every rank loads the same global batch (the loaders
  draw from shared seeded generators, so this keeps the single-process
  samples) and takes its data group's share of the volumes
  (:meth:`Mesh.data_shard`). Gradients are averaged over the data group
  before the optimizer step (:meth:`Mesh.reduce_gradients`); the 3D recipe's
  loss is a mean over volumes, so the mean of equal shards' gradients is the
  global step's.
- The **model axis**: JAX's ``param_sharding`` rule on the port's names
  (:func:`param_specs`). ``linear1`` / ``pwconv1`` and layer 0 of an MLP
  named ``mlp`` are column-parallel, ``linear2`` / ``pwconv2`` and layer 1
  row-parallel (Megatron's pairing: one all-reduce per MLP in the forward
  and one in the backward); a weight whose dimension the model axis does
  not divide, and everything else, stays replicated. :func:`shard_model`
  swaps those ``layers.Linear`` modules for :class:`ColumnParallelLinear` /
  :class:`RowParallelLinear`, which hold their rank's slice as a plain
  parameter and run the collectives inside autograd functions over the
  model group. The port's linears are not ``nn.Linear`` and its kernels
  take plain tensors, so the slices are plain tensors rather than
  ``torch.distributed.tensor`` DTensors. One divergence from JAX: JAX
  reads an MLP layer's index after the first ``layers`` of the path, which
  for the mask decoder's two-way blocks is the block's index, so it shards
  both linears of block 0's MLP by output and both of block 1's by input;
  the port shards each by its own index.

``initialize_distributed`` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or takes a coordinator
address; NCCL serves CUDA tensors and gloo the CPU. Two ranks on one card
must use gloo, since NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from medsam2_tpu_torch.core import layers

# path fragments of the linears that take tensor-parallel slices: the
# up-projections by output feature, the matching down-projections by input
UP_KEYS = ("linear1", "pwconv1")
DOWN_KEYS = ("linear2", "pwconv2")
# the encoder kernels read whole weights: a model-sharded trunk cannot take them
ENCODER_SWITCHES = ("MEDSAM2_FUSED_BLOCK", "MEDSAM2_FUSED_WINDOW", "MEDSAM2_FUSED_MLP")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           backend: Optional[str] = None) -> int:
    """Join the process group once per process: NCCL when ``device`` is a
    card, gloo on the CPU (``backend`` overrides it). Without arguments it
    reads ``torchrun``'s ``WORLD_SIZE`` / ``RANK`` and the ``env://``
    rendezvous; ``coordinator_address`` ("host:port") rendezvouses over TCP.
    A no-op at one process. Returns the process count."""
    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return 1
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return num_processes


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_local_batch(global_batch: int) -> int:
    """Per-process batch size for per-process data loading."""
    if global_batch % process_count():
        raise ValueError(f"global batch {global_batch} not divisible by {process_count()} "
                         "processes")
    return global_batch // process_count()


class Mesh:
    """The (data, model) layout of the ranks, with this rank's coordinates
    and the process groups of its two axes (None where an axis has one
    rank: collectives over it are skipped)."""

    def __init__(self, data: int, model: int, rank: int, data_group=None, model_group=None):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = data_group
        self.model_group = model_group

    def data_shard(self, x):
        """This rank's share of a leading (volume) axis: rows
        ``[i * n / data, (i + 1) * n / data)`` for data index i."""
        n = x.shape[0]
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"a batch of {n} does not split over {d} data ranks")
        k = n // d
        return x[self.data_index * k:(self.data_index + 1) * k]

    def all_gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every data rank's ``x`` along dim 0, in data order."""
        if self.data_group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape["data"])]
        dist.all_gather(parts, x, group=self.data_group)
        return torch.cat(parts, 0)

    def reduce_gradients(self, grads: List[torch.Tensor]) -> None:
        """Average ``grads`` over the data group in place (one flattened
        all-reduce in fp32)."""
        if self.data_group is None or not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        flat /= self.shape["data"]
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """Mesh over (data, model) of the process group's ranks;
    ``model_axis`` divides their count. Every rank must call it (it makes
    the axes' process groups)."""
    n = process_count()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}): the process group has {n} ranks")
    if n % model_axis:
        raise ValueError(f"{n} ranks not divisible by model={model_axis}")
    data = n // model_axis
    rank = process_index()
    groups = {"data": None, "model": None}
    if n > 1:
        # every rank makes every group, in one order
        axes = (("model", [list(range(i * model_axis, (i + 1) * model_axis))
                           for i in range(data)]),
                ("data", [list(range(j, n, model_axis)) for j in range(model_axis)]))
        for axis, all_ranks in axes:
            for ranks in all_ranks:
                group = dist.new_group(ranks)
                if rank in ranks and len(ranks) > 1:
                    groups[axis] = group
    return Mesh(data, model_axis, rank, groups["data"], groups["model"])


# ---------------------------------------------------------------------------
# the sharding rule
# ---------------------------------------------------------------------------


def param_spec(name: str, shape, model_axis: int) -> Optional[int]:
    """The dimension of parameter ``name`` (reference layout: a linear's
    weight is [out, in]) sliced over the model axis, or None (replicated):
    JAX's ``param_sharding`` rule, its divisibility test included."""
    parts = name.split(".")
    leaf = parts[-1]
    dim = None
    if len(shape) == 2 and leaf == "weight":
        if any(k in parts for k in UP_KEYS):
            dim = 0
        elif any(k in parts for k in DOWN_KEYS):
            dim = 1
        elif "mlp" in name and len(parts) >= 3 and parts[-3] == "layers":
            dim = {"0": 0, "1": 1}.get(parts[-2])
    elif len(shape) == 1 and leaf == "bias" and any(k in parts for k in UP_KEYS):
        dim = 0
    if dim is not None and shape[dim] % model_axis:
        dim = None
    return dim


def param_specs(model: nn.Module, model_axis: int) -> Dict[str, Optional[int]]:
    """:func:`param_spec` of every parameter, by state-dict name. A sharded
    model reports the specs it was sharded with."""
    specs = getattr(model, "_model_specs", None)
    if specs is not None:
        return dict(specs)
    return {name: param_spec(name, tuple(p.shape), model_axis)
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# tensor-parallel linears
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in fp32 (gloo has no bf16 reduction everywhere)."""
    out = x.float().contiguous()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank holds a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum of the ranks' partial outputs forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceOfReplicated(torch.autograd.Function):
    """This rank's slice of a replicated tensor; the backward gathers every
    rank's slice gradient, so the replicated tensor gets its whole gradient
    on every rank."""

    @staticmethod
    def forward(ctx, full, group, index: int, parts: int):
        ctx.group, ctx.parts = group, parts
        return full.chunk(parts, 0)[index].clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        pieces = [torch.empty_like(g) for _ in range(ctx.parts)]
        dist.all_gather(pieces, g, group=ctx.group)
        return torch.cat(pieces, 0), None, None, None


class ColumnParallelLinear(layers.Linear):
    """A linear holding this rank's rows of the weight (output features):
    replicated input, output sliced by feature. The bias is this rank's
    slice, or a replicated bias sliced here where the rule keeps it whole."""

    def forward(self, x):
        x = _CopyToModel.apply(x, self.tp_group)
        bias = self.bias
        if bias is not None and self.tp_bias_replicated:
            bias = _SliceOfReplicated.apply(bias, self.tp_group, self.tp_index, self.tp_parts)
        return layers.linear(x, self.weight, bias)


class RowParallelLinear(layers.Linear):
    """A linear holding this rank's columns of the weight (input features):
    input sliced by feature (a column-parallel partner's output), output
    summed over the model group, then the replicated bias."""

    def forward(self, x):
        y = _ReduceFromModel.apply(layers.linear(x, self.weight), self.tp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return t.detach().chunk(mesh.shape["model"], dim)[mesh.model_index].clone()


def shard_model(model: nn.Module, mesh: Mesh,
                optimizers: Optional[Dict[str, torch.optim.Optimizer]] = None) -> nn.Module:
    """Slice the model-parallel linears of ``model`` over the mesh's model
    axis, in place (a no-op at model 1). ``optimizers`` built on the whole
    parameters (and their state, after a resume) follow the slices."""
    m = mesh.shape["model"]
    if m == 1:
        return model
    on = [s for s in ENCODER_SWITCHES if os.environ.get(s, "0") == "1"]
    if on:
        raise ValueError(f"{', '.join(on)}: the encoder kernels take whole weights; "
                         "a model axis > 1 needs the switches off")
    specs = param_specs(model, m)
    swapped = {}
    for name, mod in list(model.named_modules()):
        if type(mod) is not layers.Linear:
            continue
        dim = specs.get(f"{name}.weight")
        if dim is None:
            continue
        weight = nn.Parameter(_slice(mod.weight, dim, mesh), requires_grad=mod.weight.requires_grad)
        swapped[mod.weight] = (weight, dim)
        mod.weight = weight
        bias_dim = specs.get(f"{name}.bias")
        if mod.bias is not None and bias_dim is not None:
            bias = nn.Parameter(_slice(mod.bias, 0, mesh), requires_grad=mod.bias.requires_grad)
            swapped[mod.bias] = (bias, 0)
            mod.bias = bias
        mod.__class__ = ColumnParallelLinear if dim == 0 else RowParallelLinear
        mod.tp_group, mod.tp_index, mod.tp_parts = mesh.model_group, mesh.model_index, m
        mod.tp_bias_replicated = dim == 0 and bias_dim is None
    for name, mod in model.named_modules():
        # a column slice feeds the row-parallel linear beside it
        kids = list(mod.children())
        if (any(isinstance(c, ColumnParallelLinear) for c in kids)
                and not any(isinstance(c, RowParallelLinear) for c in kids)):
            raise ValueError(f"{name}: a column-parallel linear without a row-parallel partner")
    model._model_specs = specs
    model._mesh = mesh
    for opt in (optimizers or {}).values():
        for group in opt.param_groups:
            new = []
            for p in group["params"]:
                if p in swapped:
                    q, dim = swapped[p]
                    state = opt.state.pop(p, None)
                    if state:
                        opt.state[q] = {k: (_slice(v, dim, mesh) if torch.is_tensor(v)
                                            and v.shape == p.shape else v)
                                        for k, v in state.items()}
                    p = q
                new.append(p)
            group["params"] = new
    return model


def gather_param(mesh: Mesh, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The whole tensor from the model group's slices along ``dim`` (``t``
    itself when replicated)."""
    if dim is None or mesh.model_group is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim)


def full_named(model: nn.Module, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A name -> tensor dict (a state dict, EMA weights) with every sliced
    parameter gathered whole; every rank of the model group must call it."""
    mesh = getattr(model, "_mesh", None)
    specs = getattr(model, "_model_specs", {})
    if mesh is None:
        return dict(named)
    return {k: gather_param(mesh, v, specs.get(k)) for k, v in named.items()}


def full_optimizer_state(model: nn.Module, opt: torch.optim.Optimizer) -> Dict:
    """``opt.state_dict()`` with the state of every sliced parameter
    gathered whole (the layout of a single-process run)."""
    sd = opt.state_dict()
    mesh = getattr(model, "_mesh", None)
    if mesh is None:
        return sd
    specs = model._model_specs
    names = {id(p): n for n, p in model.named_parameters()}
    index = [names[id(p)] for g in opt.param_groups for p in g["params"]]
    state = {}
    for i, st in sd["state"].items():
        dim = specs.get(index[i])
        state[i] = {k: (gather_param(mesh, v, dim) if torch.is_tensor(v) and v.ndim else v)
                    for k, v in st.items()}
    return {**sd, "state": state}
