"""Host ms a step of the model: the ``model.trunk``, ``model.heads`` and
``model.mano`` spans of the traced steps, each with the backward nodes
charged to it (``harness/spans.py``)."""

from harness import spans

LAYER = "model"
UNIT = "ms/step"
MOVES = "step_ms"
NAMES = ("model.trunk", "model.heads", "model.mano")


def read(s: dict):
    sp = spans.of(s)
    got = [sp[n]["host_ms"] for n in NAMES if n in sp]
    return sum(got) if got else None
