"""Host ms a step of the update: the ``optim.update`` span of the traced
steps (the terms' reduction, the zero fill, the global norm, the clip,
Adam and the schedule; ``harness/spans.py``)."""

from harness import spans

LAYER = "optim"
UNIT = "ms/step"
MOVES = "step_ms"


def read(s: dict):
    r = spans.of(s).get("optim.update")
    return None if r is None else r["host_ms"]
