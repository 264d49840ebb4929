"""ROI cropping and affine transforms (host side).

Port of ``hocon/data/cropping.py``: crop a square ROI around the hand (from
its 2D joint extent), apply scale / rotation / translation jitter, warp the
image to the network input resolution, and apply the same affine to 2D
labels and camera intrinsics (``K' = A_3x3 @ K``, z untouched).

The reference warps with ``cv2.warpAffine`` (bilinear, constant 0 border).
``warp_image`` computes the same function in plain PyTorch on the host:
each output pixel (x, y) is mapped through the inverse affine in float64
to source coordinates, and the image is sampled there bilinearly, each of
the four taps reading 0 where it falls outside the source. cv2 rounds the
coordinates in f32, so the two differ by ~3e-6 at 64 px and ~2e-5 at
256 px on a random texture.
"""

from __future__ import annotations

import numpy as np
import torch


def square_bbox_from_points(points2d: np.ndarray, scale: float = 1.3) -> tuple:
    """Square ROI (center, side) covering 2D points with a margin factor."""
    mins = points2d.min(axis=0)
    maxs = points2d.max(axis=0)
    center = (mins + maxs) / 2.0
    side = float(np.max(maxs - mins)) * scale
    return center, max(side, 1.0)


def build_crop_affine(
    center: np.ndarray,
    side: float,
    out_res: int,
    rot_deg: float = 0.0,
    scale_jitter: float = 1.0,
    center_jitter: np.ndarray | None = None,
) -> np.ndarray:
    """Affine (3, 3) mapping source pixels -> (out_res, out_res) crop pixels.

    The crop covers a square of size ``side * scale_jitter`` centered at
    ``center + center_jitter``, rotated by ``rot_deg`` about the center.
    """
    c = np.asarray(center, np.float64).copy()
    if center_jitter is not None:
        c = c + np.asarray(center_jitter, np.float64)
    s = out_res / (side * scale_jitter)
    t = np.deg2rad(rot_deg)
    rot = np.array(
        [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]], np.float64
    )
    m = s * rot
    offset = np.array([out_res / 2.0, out_res / 2.0]) - m @ c  # c -> crop centre
    aff = np.eye(3)
    aff[:2, :2] = m
    aff[:2, 2] = offset
    return aff


def warp_image(image: np.ndarray, affine: np.ndarray, out_res: int) -> np.ndarray:
    """Warp a float (H, W, C) image by the (3, 3) pixel affine into a float32
    (out_res, out_res, C) crop."""
    # The reference hands cv2 the affine in float32; invert that one.
    fwd = np.eye(3)
    fwd[:2] = affine[:2].astype(np.float32)
    inv = torch.from_numpy(np.linalg.inv(fwd))
    # A border of zeros: every tap outside the source lands on it once the
    # tap coordinates are clamped into the padded image.
    src = torch.nn.functional.pad(torch.from_numpy(np.asarray(image, np.float32)),
                                  (0, 0, 1, 1, 1, 1))
    hp, wp, n_ch = src.shape
    flat = src.reshape(hp * wp, n_ch)
    grid = torch.arange(out_res, dtype=torch.float64)
    ys, xs = torch.meshgrid(grid, grid, indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long() + 1, y0.long() + 1  # in the padded image
    out = torch.zeros((out_res, out_res, n_ch), dtype=torch.float64)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            idx = (torch.clamp(y0 + dy, 0, hp - 1) * wp + torch.clamp(x0 + dx, 0, wp - 1))
            out += (wx * wy)[..., None] * flat[idx]
    return out.to(torch.float32).numpy()


def transform_points2d(points2d: np.ndarray, affine: np.ndarray) -> np.ndarray:
    return points2d @ affine[:2, :2].T + affine[:2, 2]


def transform_intrinsics(camintr: np.ndarray, affine: np.ndarray) -> np.ndarray:
    return affine @ camintr
