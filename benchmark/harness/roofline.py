"""A span's share of the card's bf16 peak, for the per-layer readers of a
model's parts (``metrics/model.trunk_roofline.py``,
``metrics/model.attn_roofline.py``).

A family may count the matrix FLOPs, forward and backward, of the work
under a span: ``SPAN_FLOPS`` in ``reference/families/<family>.py`` maps the
span's name to ``count(cfg, images)``. The share is that count for one
step's images over the device time a step of the span, with the backward
charged to it (``harness/spans.py``), against 989 TFLOP/s. None where the
family counts no such span or the run traced none.
"""

from __future__ import annotations

from harness import cost, spans
from reference import families


def span_share(s: dict, name: str):
    count = getattr(families.load(s["cfg"]), "SPAN_FLOPS", {}).get(name)
    span = spans.of(s).get(name)
    if count is None or span is None or span["device_ms"] <= 0:
        return None
    images = s["cfg"]["data"]["pairs_per_step"] * (2 if s["kind"] == "warp" else 1)
    return 100.0 * count(s["cfg"], images) / (span["device_ms"] * 1e-3) / cost.PEAK_BF16
