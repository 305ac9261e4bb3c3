"""Position encodings (counterpart of ``medsam2_tpu/core/pos_enc.py``): sine
grid, 1D sine encoding of object-pointer distances, random-Fourier prompt
encoding, axial RoPE tables.

The sine and RoPE tables depend only on static shapes: they are computed once
in numpy and kept on the device per (shape, device, dtype), as the JAX package
folds them into its compiled graph as constants. Callers must not modify the
returned tensors.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
from torch import nn

from medsam2_tpu_torch.utils import tracing


def sine_pos_embed_grid(h: int, w: int, num_pos_feats: int) -> np.ndarray:
    """[H, W, C] ``PositionEmbeddingSine`` (temperature 1e4, normalised, scale
    2 pi): 1-indexed cumsum coordinates normalised by the last one + 1e-6,
    interleaved sin/cos, [pos_y ; pos_x]."""
    npf = num_pos_feats // 2
    scale = 2 * math.pi
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    y_embed = y_embed / (y_embed[-1:, :] + 1e-6) * scale
    x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * scale
    dim_t = np.arange(npf, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / npf)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack((np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])), axis=3).reshape(h, w, -1)
    pos_y = np.stack((np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])), axis=3).reshape(h, w, -1)
    return np.concatenate((pos_y, pos_x), axis=2)


@lru_cache(maxsize=32)
def _sine_on(h: int, w: int, num_pos_feats: int, device: torch.device, dtype: torch.dtype):
    return torch.from_numpy(sine_pos_embed_grid(h, w, num_pos_feats)).to(device, dtype)


def sine_pos_embed(h: int, w: int, num_pos_feats: int, device="cpu",
                   dtype=torch.float32) -> torch.Tensor:
    """[H, W, C] sine grid on ``device`` (shared, read-only)."""
    return _sine_on(h, w, num_pos_feats, torch.device(device), dtype)


def get_1d_sine_pe(pos_inds: torch.Tensor, dim: int, temperature: float = 10000.0):
    """1D sine encoding (``sam2_utils.py:60-70``): [..., dim] = [sin ; cos]
    halves of ``pos_inds`` (any shape) over ``dim // 2`` frequencies."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos_inds.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    pos = pos_inds.float()[..., None] / dim_t
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier encoding of [0, 1] coordinates
    (``position_encoding.py:115-158``); the Gaussian matrix is a buffer, as in
    the reference."""

    def __init__(self, num_pos_feats: int, gen: torch.Generator, scale: float = 1.0):
        super().__init__()
        g = torch.empty(2, num_pos_feats)
        g.normal_(0.0, 1.0, generator=gen)
        self.register_buffer("positional_encoding_gaussian_matrix", scale * g)

    def encode(self, coords):
        """[..., 2] in [0, 1] -> [..., 2 * num_pos_feats]."""
        coords = 2.0 * coords.float() - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid(self, h: int, w: int):
        """[H, W, C] at pixel centres."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self.encode(torch.stack([gx, gy], dim=-1))

    def points(self, coords, image_size: Tuple[int, int]):
        """Unnormalised pixel coords [..., 2] in (x, y) order."""
        scale = tracing.upload(np.array([1.0 / image_size[1], 1.0 / image_size[0]], np.float32),
                               coords.device)
        return self.encode(coords * scale)


@lru_cache(maxsize=32)
def _axial_rope_cos_sin(dim: int, end_x: int, end_y: int, theta: float):
    n_freq = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[:n_freq].astype(np.float32) / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x = t % end_x
    t_y = np.floor(t / end_x)
    angles = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)], axis=-1)
    return np.cos(angles), np.sin(angles)


def axial_rope_cos_sin(dim: int, end_x: int, end_y: int, theta: float = 10000.0,
                       device="cpu"):
    """cos/sin tables [end_x * end_y, dim // 2] for axial RoPE over a
    row-major grid, on ``device`` (shared, read-only)."""
    return _rope_on(dim, end_x, end_y, theta, torch.device(device))


@lru_cache(maxsize=32)
def _rope_on(dim: int, end_x: int, end_y: int, theta: float, device: torch.device):
    cos, sin = _axial_rope_cos_sin(dim, end_x, end_y, theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def apply_rope_half(x, cos, sin):
    """RoPE on half-split channels (pair i is (x[..., i], x[..., D/2 + i])):
    the JAX package folds the interleaved pairing into a channel permutation
    of the q/k weights, and so does the port, so cached keys compare
    directly. Computed in fp32, returned in x's dtype."""
    hd = x.shape[-1]
    xf = x.float()
    xr, xi = xf[..., : hd // 2], xf[..., hd // 2:]
    out = torch.cat([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.to(x.dtype)
