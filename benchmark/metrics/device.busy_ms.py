"""Device-busy ms a step: the union of the intervals in which a kernel, a
copy or a memset ran on the card, over the traced steps."""

LAYER = "device"
UNIT = "ms/step"
MOVES = "step_ms"


def read(s: dict):
    return s["busy_ms"] if s["busy_ms"] > 0 else None
