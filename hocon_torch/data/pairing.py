"""Temporal frame-pair target sampling, shared by all pose datasets.

Port of ``hocon/data/pairing.py``: pairs are (annotated ref frame,
temporally offset target frame) within one video. ``pair_target`` makes the
same ``rng`` calls in the same order as the reference, so one seeded
``np.random.Generator`` gives both packages the same indices.
"""

from __future__ import annotations

import numpy as np


def pair_target(
    ref: int,
    count: int,
    spacing: int,
    rng: np.random.Generator,
    fixed: bool = False,
) -> int:
    """Sequence-local target index for a ref frame.

    Default: offset magnitude uniform in [1, spacing], random sign, clipped
    to the sequence. ``fixed``: magnitude exactly ``spacing``; at sequence
    edges the sign flips inward first (keeping |tgt-ref| == spacing where
    possible) before falling back to clipping.
    """
    mag = spacing if fixed else int(rng.integers(1, spacing + 1))
    sign = 1 if rng.random() < 0.5 else -1
    cand = ref + sign * mag
    if fixed and not (0 <= cand < count):
        cand = ref - sign * mag
    tgt = int(np.clip(cand, 0, count - 1))
    if tgt == ref:
        tgt = min(ref + 1, count - 1)
    return tgt
