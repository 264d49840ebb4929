"""Augmentation parameter sampling, colour jitter and ImageNet normalization.

Port of ``hocon/data/augment.py`` (host-side numpy): affine scale /
rotation / centre jitter and brightness / contrast / saturation / hue
jitter, drawn from an explicit ``np.random.Generator`` in the reference's
order, so the same seed gives both packages the same parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    scale_jitter: float = 0.1  # crop scale in [1-s, 1+s]
    rot_jitter_deg: float = 15.0
    center_jitter_frac: float = 0.1  # of ROI side
    brightness: float = 0.3
    contrast: float = 0.3
    saturation: float = 0.3
    hue: float = 0.1  # hue rotation half-range, as a fraction of pi radians
    enabled: bool = True


def sample_affine_jitter(rng: np.random.Generator, cfg: AugmentConfig, side: float):
    """(scale, rotation in degrees, centre offset in pixels) of one crop."""
    if not cfg.enabled:
        return 1.0, 0.0, np.zeros(2)
    scale = 1.0 + rng.uniform(-cfg.scale_jitter, cfg.scale_jitter)
    rot = rng.uniform(-cfg.rot_jitter_deg, cfg.rot_jitter_deg)
    center = rng.uniform(-1.0, 1.0, 2) * cfg.center_jitter_frac * side
    return scale, rot, center


def color_jitter(
    rng: np.random.Generator, image: np.ndarray, cfg: AugmentConfig
) -> np.ndarray:
    """Brightness / contrast / saturation / hue jitter on a float image in
    [0, 1], clipped back to [0, 1]."""
    if not cfg.enabled:
        return image
    img = image
    if cfg.brightness > 0:
        img = img * (1.0 + rng.uniform(-cfg.brightness, cfg.brightness))
    if cfg.contrast > 0:
        mean = img.mean()
        img = (img - mean) * (1.0 + rng.uniform(-cfg.contrast, cfg.contrast)) + mean
    if cfg.saturation > 0:
        gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
        f = 1.0 + rng.uniform(-cfg.saturation, cfg.saturation)
        img = gray[..., None] + (img - gray[..., None]) * f
    if cfg.hue > 0:
        # Hue rotation in YIQ space, fused into one 3x3 pixel matmul:
        # img @ (YIQ2RGB @ rot @ RGB2YIQ)^T.
        t = rng.uniform(-cfg.hue, cfg.hue) * np.pi
        cos, sin = np.cos(t), np.sin(t)
        rot = np.array(
            [[1, 0, 0], [0, cos, -sin], [0, sin, cos]], np.float32
        )
        fused = (_YIQ2RGB @ rot @ _RGB2YIQ).astype(np.float32)
        img = img @ fused.T
    return np.clip(img, 0.0, 1.0)


_RGB2YIQ = np.array(
    [[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]],
    np.float32,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """[0,1] float RGB -> ImageNet-normalized."""
    return (image - IMAGENET_MEAN) / IMAGENET_STD
