"""Qualitative sample grids.

Port of ``hocon/visualize/samplevis.py``: matplotlib grids of the input
crop, GT against predicted 2D joints, and (warp training) the rendered
mask / warped image / target panels, saved under
``checkpoints/<exp>/images/``. Host-side only: it takes numpy arrays and
never touches the device.
"""

from __future__ import annotations

import os

import numpy as np

from hocon_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

# Standard 21-joint skeleton: (parent, child) bone list, wrist-rooted.
_BONES = [
    (0, 1), (1, 2), (2, 3), (3, 4),          # thumb
    (0, 5), (5, 6), (6, 7), (7, 8),          # index
    (0, 9), (9, 10), (10, 11), (11, 12),     # middle
    (0, 13), (13, 14), (14, 15), (15, 16),   # ring
    (0, 17), (17, 18), (18, 19), (19, 20),   # pinky
]


def _unnormalize(img: np.ndarray) -> np.ndarray:
    """Crops as RGB in [0, 1]: uint8 crops (``--uint8_images``) / 255,
    ImageNet-normalized ones un-normalized and clipped."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def _draw_skeleton(ax, joints2d, color):
    for a, b in _BONES:
        ax.plot(
            [joints2d[a, 0], joints2d[b, 0]],
            [joints2d[a, 1], joints2d[b, 1]],
            color=color, linewidth=1,
        )
    ax.scatter(joints2d[:, 0], joints2d[:, 1], s=4, c=color)


def sample_vis(
    batch: dict,
    preds: dict,
    save_path: str,
    max_rows: int = 4,
    warp: dict | None = None,
) -> str | None:
    """Save a grid: crop + GT (green) / predicted (red) 2D joints, and
    optionally the warp panels (mask, warped image, target). Returns the
    saved path, or None where matplotlib cannot be imported."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover
        return None

    images = np.asarray(batch["image"])
    n = min(max_rows, images.shape[0])
    ncols = 2 + (3 if warp is not None else 0)
    fig, axes = plt.subplots(n, ncols, figsize=(2.2 * ncols, 2.2 * n), squeeze=False)
    for i in range(n):
        ax = axes[i][0]
        ax.imshow(_unnormalize(images[i]))
        ax.set_title("input", fontsize=7)
        ax = axes[i][1]
        ax.imshow(_unnormalize(images[i]))
        if "joints2d" in batch:
            _draw_skeleton(ax, np.asarray(batch["joints2d"])[i], "lime")
        if "joints2d" in preds:
            _draw_skeleton(ax, np.asarray(preds["joints2d"])[i], "red")
        ax.set_title("gt(green)/pred(red)", fontsize=7)
        if warp is not None:
            axes[i][2].imshow(np.asarray(warp["mask"])[i], cmap="gray", vmin=0, vmax=1)
            axes[i][2].set_title("mask", fontsize=7)
            axes[i][3].imshow(np.clip(np.asarray(warp["warped"])[i], 0, 1))
            axes[i][3].set_title("warped ref", fontsize=7)
            axes[i][4].imshow(np.clip(np.asarray(warp["target"])[i], 0, 1))
            axes[i][4].set_title("target", fontsize=7)
    for row in axes:
        for ax in row:
            ax.axis("off")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_path, dpi=80)
    plt.close(fig)
    return save_path
