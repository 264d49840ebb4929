"""Host ms a step of the render layer: the ``render.*`` spans of the traced
steps (plane prep, the raster call, the sample, the photometric loss), each
with the backward nodes charged to it (``harness/spans.py``)."""

from harness import spans

LAYER = "render"
UNIT = "ms/step"
MOVES = "step_ms"


def read(s: dict):
    got = [r["host_ms"] for name, r in spans.of(s).items() if name.startswith("render.")]
    return sum(got) if got else None
