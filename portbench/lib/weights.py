"""Seeded weights, drawn on the device in one call.

Every tensor of a state dict is a slice of one ``torch.randn`` drawn from a
generator on the device, scaled by a rule on its name and rank: fan-in
normal (std 1 / sqrt(prod(shape[1:]))) for every tensor of rank 2 or more,
1 + 0.02 n for the scale of a norm (a rank-1 ``weight``), 0.02 n for biases
and layer scales, N(0, 1) for buffers (the prompt encoder's Fourier
matrix). Names are taken in sorted order, so one seed gives one set of
weights whatever order the program declares its modules in. ``overrides``
set whole tensors to a constant after the draw.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one named stream of draws of ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for s in stream:
        words += [int(b) for b in str(s).encode()] if isinstance(s, str) else [int(s) & 0xFFFFFFFF]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def leaf_scale(name: str, shape: Tuple[int, ...], is_buffer: bool) -> Tuple[float, float]:
    """(mean, std) of one tensor under the rule above."""
    if is_buffer:
        return 0.0, 1.0
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        return 0.0, 1.0 / float(np.sqrt(max(fan_in, 1)))
    if name.endswith("weight"):
        return 1.0, 0.02
    return 0.0, 0.02


def make_weights(leaves: Iterable[Tuple[str, Tuple[int, ...], bool]], seed: int, device,
                 overrides: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """``leaves``: (name, shape, is_buffer). Returns {name: float32 tensor on
    ``device``}, each a view of one flat draw."""
    leaves = sorted((n, tuple(s), b) for n, s, b in leaves)
    total = sum(int(np.prod(s)) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, is_buffer in leaves:
        n = int(np.prod(shape))
        mean, std = leaf_scale(name, shape, is_buffer)
        t = flat[off: off + n].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
        off += n
    for name, value in (overrides or {}).items():
        if name not in out:
            raise KeyError(f"weight override {name!r} names no tensor of the model")
        out[name].fill_(float(value))
    return out
