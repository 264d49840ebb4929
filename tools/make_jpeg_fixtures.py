#!/usr/bin/env python3
"""Write the JPEG fixtures of ``tests/data/jpeg/`` with cv2.

    python3 tools/make_jpeg_fixtures.py [--out tests/data/jpeg]

Two baseline JPEGs of odd sizes, one with 4:2:0 chroma subsampling and one
without (4:4:4), each beside its decode by ``cv2.imread`` (IMREAD_COLOR,
then BGR -> RGB) as uint8 (H, W, 3) ``.npy``. The content is image-like: a
colour gradient, filled shapes with sharp edges and mild noise, from a
fixed seed. ``tests/test_torch_images.py`` holds the port's CPU decoder to
these decodes bit for bit; ``chip_smoke.py`` holds nvJPEG to them within a
stated bar.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# name: (height, width, chroma subsampling, quality)
FIXTURES = {"odd_420": (251, 333, "420", 90), "odd_444": (157, 211, "444", 95)}


def content(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 (h, w, 3) RGB: gradient, shapes, noise."""
    import cv2

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([40 + 160 * xx / w, 60 + 120 * yy / h, 200 - 150 * (xx + yy) / (w + h)], -1)
    img = np.ascontiguousarray(img.astype(np.uint8))
    for _ in range(6):
        colour = tuple(int(c) for c in rng.integers(0, 256, 3))
        centre = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        if rng.random() < 0.5:
            cv2.circle(img, centre, int(rng.integers(8, h // 3)), colour, -1)
        else:
            size = rng.integers(10, h // 2, 2)
            cv2.rectangle(img, centre, (centre[0] + int(size[0]), centre[1] + int(size[1])),
                          colour, -1)
    noisy = img.astype(np.float64) + rng.normal(0, 6, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def main() -> None:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "..", "tests", "data", "jpeg"))
    out = ap.parse_args().out
    os.makedirs(out, exist_ok=True)
    factors = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
               "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
    for seed, (name, (h, w, css, quality)) in enumerate(FIXTURES.items()):
        rgb = content(h, w, seed)
        ok, buf = cv2.imencode(".jpeg", rgb[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factors[css]])
        assert ok
        path = os.path.join(out, f"{name}.jpeg")
        with open(path, "wb") as fh:
            fh.write(buf.tobytes())
        decoded = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.save(os.path.join(out, f"{name}.npy"), decoded)
        print(f"{path}: {w} x {h}, {css}, quality {quality}, {len(buf)} bytes")


if __name__ == "__main__":
    main()
