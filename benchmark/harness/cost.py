"""The yardstick's arithmetic: the card's peaks, one step's FLOPs from the
configuration's shapes, and the least time of the kernels' work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at a 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s of HBM.

The step's FLOPs are the model's matrix work, forward and backward,
counted from the configuration's shapes whatever computes it. Each model
family counts its own (``reference/families/<family>.py:flops``): ``hocnet``
counts the ResNet trunk's convolutions and the MLP heads' dense layers. The
elementwise work (batch norm, ReLU, MANO, the losses, SSIM, the raster's
affine rows) is left out: it is small beside the matrix work and bound by
bytes.

The raster's least time counts the (face, pixel) pairs whose f32
contribution is not exactly zero in the cells (8-row block x lane block)
that the port's culling evaluates each 32-face chunk in, pixel by pixel
from the plain logits (a frozen copy of ``needed_pairs``), at ~86
operations a pair forward and ~236 backward (C = 2), or the bytes in and
out once, whichever is larger. The sampler's least time is its bytes, read
once and written once.
"""

from __future__ import annotations

import math

import torch

from reference import families

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

FACE_CHUNK, ROW_BLOCK, LANE_BLOCK = 32, 8, 256
FIXED_M_MAX_INV_GAMMA = 60.0


def step_flops(cfg: dict, kind: str) -> float:
    """One train step's matrix FLOPs, as the configuration's family counts
    them (``reference/families/<family>.py:flops``): the warp step runs the
    model on both views of each pair, the supervised step on the reference
    views."""
    d = cfg["data"]
    images = d["pairs_per_step"] * (2 if kind == "warp" else 1)
    return families.load(cfg).flops(cfg, images)


def sample_bytes(cfg: dict) -> float:
    """K3 + K4 at the step's shapes: K3 reads the image (C = 3) and the
    coordinates and writes the samples; K4 reads image, coordinates and the
    samples' cotangent and writes the coordinates' gradient."""
    d = cfg["data"]
    px = d["pairs_per_step"] * d["image_size"] ** 2
    return 4.0 * px * ((3 + 2 + 3) + (3 + 2 + 3 + 2))


def _padded(size: int) -> tuple[int, int]:
    return math.ceil(size / ROW_BLOCK) * ROW_BLOCK, math.ceil(size / 128) * 128


@torch.no_grad()
def needed_pairs(coeffs, bounds, krange, image_size, sigma: float, gamma: float):
    """(K1's, K2's) needed (face, pixel) pairs for one launch's inputs."""
    b, _, r3 = coeffs.shape
    hp, wp = _padded(image_size[0])
    xb = wp if wp <= LANE_BLOCK else 128
    dev, dt = coeffs.device, coeffs.dtype
    y0 = torch.arange(hp // ROW_BLOCK, device=dev, dtype=torch.float32) * ROW_BLOCK
    x0 = torch.arange(wp // xb, device=dev, dtype=torch.float32) * xb
    bnd = bounds.float()
    hit_y = (y0 + ROW_BLOCK > bnd[..., 0:1]) & (y0 < bnd[..., 1:2])
    hit_x = (x0 + xb > bnd[..., 2:3]) & (x0 < bnd[..., 3:4])
    k = torch.arange(bnd.shape[1], device=dev)[None, :, None]
    in_range = (k >= krange[:, None, :, 0]) & (k < krange[:, None, :, 1])
    hits = (hit_y & in_range)[..., :, None] & hit_x[..., None, :]
    hits_any = hits.any(dim=0).cpu()
    xs_all = torch.arange(wp, device=dev, dtype=dt) + 0.5
    ys_all = torch.arange(hp, device=dev, dtype=dt) + 0.5
    inv_s2, inv_g = 1.0 / (sigma * sigma), 1.0 / gamma
    k1 = k2 = 0
    for c in range(bnd.shape[1]):
        cells = hits_any[c].nonzero()
        if len(cells) == 0:
            continue
        (ylo, xlo), (yhi, xhi) = cells.min(0).values.tolist(), (cells.max(0).values + 1).tolist()
        take = hits[:, c, ylo:yhi, xlo:xhi].repeat_interleave(ROW_BLOCK, 1)
        take = take.repeat_interleave(xb, 2)[:, None]
        a = coeffs[:, c * FACE_CHUNK:(c + 1) * FACE_CHUNK].reshape(b, FACE_CHUNK, r3 // 3, 3)
        x = xs_all[xlo * xb:xhi * xb][None, None, None, :]
        y = ys_all[ylo * ROW_BLOCK:yhi * ROW_BLOCK][None, None, :, None]

        def row(i):
            return a[:, :, i, 0, None, None] * x + (a[:, :, i, 1, None, None] * y
                                                    + a[:, :, i, 2, None, None])

        s = [row(0), row(1), row(2)]
        d_in = torch.minimum(torch.minimum(s[0], s[1]), s[2])
        dist2 = None
        for e in range(3):
            u = row(3 + e)
            ov = torch.clamp(torch.maximum(-u, u - a[:, :, 6 + e, 2, None, None]), min=0.0)
            d2 = s[e] * s[e] + ov * ov
            dist2 = d2 if dist2 is None else torch.minimum(dist2, d2)
        logits = torch.where(d_in > 0, d_in * d_in, -dist2) * inv_s2
        zbar = torch.clamp(row(9), 0.0, 1.0)
        if inv_g <= FIXED_M_MAX_INV_GAMMA:
            e2 = torch.exp(-torch.abs(logits))
            rr = 1.0 / (1.0 + e2)
            pos = logits >= 0
            sig = torch.where(pos, rr, rr * e2)
            oms = torch.where(pos, rr * e2, rr)
            live = (oms != 1.0) | (sig * torch.exp(-zbar * inv_g) != 0.0)
        else:
            sp = torch.nn.functional.softplus(-logits)
            live = (logits + sp != 0.0) | (torch.exp(-sp - zbar * inv_g + inv_g) != 0.0)
        k1 += int((live & take).sum())
        k2 += int(((1.0 / (1.0 + torch.exp(-logits)) != 0.0) & take).sum())
    return k1, k2


def raster_least_s(launches: list) -> float:
    """Least seconds of K1 + K2 over the recorded K1 launches' inputs
    (``(coeffs, bounds, krange, image_size, sigma, gamma)`` each)."""
    total = 0.0
    for coeffs, bounds, krange, image_size, sigma, gamma in launches:
        b, _, r3 = coeffs.shape
        c = r3 // 3 - 10
        hp, wp = _padded(image_size[0])
        n1, n2 = needed_pairs(coeffs, bounds, krange, image_size, sigma, gamma)
        io = 4.0 * (coeffs.numel() + bounds.numel() + krange.numel())
        k1_bytes = io + 4.0 * b * hp * wp * (1 + (c + 1) + 1 + 2)
        k2_bytes = io + 4.0 * coeffs.numel() + 4.0 * b * hp * wp * (
            1 + (c + 1) + 1 + 2 + 1 + (c + 1) + 1)
        total += max(n1 * (4 * (7 + c) + 50) / PEAK_F32, k1_bytes / PEAK_BYTES)
        total += max(n2 * (4 * (7 + c) + 5 * (10 + c) + 140) / PEAK_F32, k2_bytes / PEAK_BYTES)
    return total
