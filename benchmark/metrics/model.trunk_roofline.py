"""The trunk's share of the card's bf16 peak: the family's count of its
matrix FLOPs forward and backward (HaMeR's ViT:
``reference/families/hamer.py:trunk_flops``) over the device time a step of
the ``model.trunk`` span (``harness/roofline.py``). None where the family
counts no such span or the run traced none."""

from harness import roofline

LAYER = "model"
UNIT = "%"
MOVES = "step_ms"


def read(s: dict):
    return roofline.span_share(s, "model.trunk")
