"""Training checkpoints: save and resume (counterpart of
``medsam2_tpu/checkpoint/store.py``).

A checkpoint is one ``torch.save`` file ``<directory>/step_<n>.pt`` (or
``<directory>/<name>.pt``, the nuclei CLI's ``best_dice`` / ``best_aji``)
holding ``{"model": state dict under the reference keys, "optimizers":
{group: Adam state}, "epoch": n}``, the DPA-P2PNet prompter's state dict
under ``"prompter"`` when one trains beside the model (plus optional extras
such as EMA weights). Its
``model`` entry has the layout of a released SAM2 ``.pt``, so
:func:`load_params` reads both through
:func:`medsam2_tpu_torch.checkpoint.convert.load_reference_state_dict`.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from medsam2_tpu_torch.checkpoint.convert import load_reference_state_dict

_STEP = re.compile(r"^step_(\d+)\.pt$")


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_checkpoint(directory: str, model: torch.nn.Module,
                    optimizers: Dict[str, torch.optim.Optimizer], epoch: int,
                    step: Optional[int] = None, extra: Optional[Dict] = None,
                    prompter: Optional[torch.nn.Module] = None,
                    name: Optional[str] = None) -> str:
    """Write ``<directory>/step_<step or epoch>.pt``, or ``<name>.pt`` when
    ``name`` is given, atomically; returns its path. ``prompter`` adds that
    module's state dict."""
    os.makedirs(directory, exist_ok=True)
    state = {"model": _cpu_state(model),
             "optimizers": {g: opt.state_dict() for g, opt in optimizers.items()},
             "epoch": int(epoch)}
    if prompter is not None:
        state["prompter"] = _cpu_state(prompter)
    state.update(extra or {})
    base = name or f"step_{epoch if step is None else step}"
    path = os.path.abspath(os.path.join(directory, f"{base}.pt"))
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_STEP.match, os.listdir(directory)) if m]
    return max(steps) if steps else None


def checkpoint_path(path: str, step: Optional[int] = None) -> str:
    """A checkpoint file, or the ``step_<n>.pt`` (latest when ``step`` is
    None) of a checkpoint directory."""
    if os.path.isfile(path):
        return path
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return os.path.join(path, f"step_{step}.pt")


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizers: Optional[Dict[str, torch.optim.Optimizer]] = None,
                       step: Optional[int] = None) -> Dict:
    """Load a checkpoint into ``model`` and ``optimizers`` (their parameter
    groups must be built first, as :func:`recipe_3d.make_optimizers` does);
    returns the whole checkpoint dict (``epoch`` included)."""
    state = torch.load(checkpoint_path(path, step), map_location="cpu", weights_only=True)
    load_reference_state_dict(model, state["model"])
    for g, opt in (optimizers or {}).items():
        opt.load_state_dict(state["optimizers"][g])
    return state


def load_params(path: str, model: torch.nn.Module) -> None:
    """Load weights only: a released SAM2 ``.pt`` (``ckpt["model"]``) or a
    checkpoint of this module (file or directory)."""
    ckpt = torch.load(checkpoint_path(path), map_location="cpu", weights_only=True)
    load_reference_state_dict(model, ckpt["model"] if "model" in ckpt else ckpt)
