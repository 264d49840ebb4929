"""Device ms a step of the render layer: the kernels launched inside the
``render.*`` spans of the traced steps or from the backward nodes charged
to them (K1-K4, plane prep, SSIM and their backward; ``harness/spans.py``)."""

from harness import spans

LAYER = "render"
UNIT = "ms/step"
MOVES = "step_ms"


def read(s: dict):
    got = sum(r["device_ms"] for name, r in spans.of(s).items() if name.startswith("render."))
    return got if got > 0 else None
