"""Kernel launches a step: device kernels (copies and memsets aside) in the
traced steps, the port's step only, over the steps traced."""

LAYER = "step"
UNIT = "launches/step"
MOVES = "step_ms"


def read(s: dict):
    return s["launches"] if s["launches"] > 0 else None
