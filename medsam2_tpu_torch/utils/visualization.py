"""Visualization utilities (counterpart of
``medsam2_tpu/utils/visualization.py``; rebuild of
``func_2d/utils.py:287-503``): mask overlays, random-color instance
painting, point discs in numpy; matplotlib dumps for the train / val
``-vis`` flags (``func_3d/function.py:148-162,288-298``), with matplotlib
imported only inside them."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def instance_colormap(inst_map: np.ndarray, seed: int = 0) -> np.ndarray:
    """Random-color instance painting: int map [H, W] -> float RGB [H, W, 3]."""
    rng = np.random.default_rng(seed)
    n = int(inst_map.max())
    colors = np.concatenate([np.zeros((1, 3)), rng.random((max(n, 1), 3))])
    return colors[np.clip(inst_map, 0, n)]


def overlay_mask(image: np.ndarray, mask: np.ndarray,
                 color=(1.0, 0.2, 0.2), alpha: float = 0.45) -> np.ndarray:
    """Blend a binary mask over an RGB float image."""
    out = np.asarray(image, np.float32).copy()
    if out.max() > 2.0:
        out = out / 255.0
    m = np.asarray(mask, bool)
    for c in range(3):
        out[..., c] = np.where(m, (1 - alpha) * out[..., c] + alpha * color[c],
                               out[..., c])
    return np.clip(out, 0, 1)


def vis_image(image: np.ndarray, pred_mask: np.ndarray, gt_mask: np.ndarray,
              save_path: str, points: Optional[np.ndarray] = None) -> None:
    """Side-by-side image / prediction / GT figure (``func_2d/utils.py``
    vis_image semantics)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 3, figsize=(9, 3))
    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0)
    if img.max() > 2.0:
        img = img / 255.0
    ax[0].imshow(np.clip(img, 0, 1))
    ax[1].imshow(np.asarray(pred_mask).squeeze() > 0.5, cmap="gray")
    ax[2].imshow(np.asarray(gt_mask).squeeze() > 0.5, cmap="gray")
    if points is not None:
        pts = np.asarray(points).reshape(-1, 2)
        ax[0].scatter(pts[:, 0], pts[:, 1], c="lime", s=12, marker="*")
    for a in ax:
        a.axis("off")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def compare_color(pred_mask: np.ndarray, gt_mask: np.ndarray) -> np.ndarray:
    """Agreement coloring (``func_2d/utils.py:381-399`` ``compare_and_color``):
    black = both background, green = both foreground, red = false positive,
    blue = false negative. Returns uint8 RGB [H, W, 3]."""
    p = np.asarray(pred_mask).squeeze() > 0
    g = np.asarray(gt_mask).squeeze() > 0
    out = np.zeros((*p.shape, 3), np.uint8)
    out[p & ~g] = (255, 0, 0)
    out[~p & g] = (0, 0, 255)
    out[p & g] = (0, 255, 0)
    return out


def draw_points(img: np.ndarray, points: np.ndarray,
                color=(255, 255, 255), radius: int = 3) -> np.ndarray:
    """Paint filled discs at (x, y) points on a uint8 RGB image (the cv2.circle
    loop in ``func_2d/utils.py:417-440``, dependency-free)."""
    out = np.asarray(img).copy()
    h, w = out.shape[:2]
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = (dy * dy + dx * dx) <= radius * radius
    for pt in np.asarray(points, np.float64).reshape(-1, 2):
        x, y = int(round(pt[0])), int(round(pt[1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        ys, xs = y + dy[disc], x + dx[disc]
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        out[ys[ok], xs[ok]] = color
    return out


def vis_compare_point(pred_mask: np.ndarray, gt_mask: np.ndarray,
                      points: Optional[np.ndarray], save_path: str) -> None:
    """Pred/GT agreement map with the prompt points painted on top
    (``func_2d/utils.py:417-441`` ``vis_compare_point`` /
    ``visualize_points_on_images`` semantics)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = compare_color(pred_mask, gt_mask)
    if points is not None:
        img = draw_points(img, points)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.imsave(save_path, img)


def vis_inst_image(image: np.ndarray, inst_map: np.ndarray, save_path: str,
                   points: Optional[np.ndarray] = None) -> None:
    """Instance-map overlay dump (``vis_inst_image`` semantics)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0)
    if img.max() > 2.0:
        img = img / 255.0
    colored = instance_colormap(np.asarray(inst_map))
    blend = np.where(np.asarray(inst_map)[..., None] > 0,
                     0.5 * img + 0.5 * colored, img)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(np.clip(blend, 0, 1))
    if points is not None:
        pts = np.asarray(points).reshape(-1, 2)
        ax.scatter(pts[:, 0], pts[:, 1], c="yellow", s=8, marker="+")
    ax.axis("off")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
