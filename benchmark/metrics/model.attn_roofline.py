"""Attention's share of the card's bf16 peak: the family's count of Q K^T
and P V forward and backward in every attention call of a step (HaMeR:
``reference/families/hamer.py:attn_flops``) over the device time a step of
the ``model.attn`` spans (``harness/roofline.py``). None where the family
counts no such span or the run traced none."""

from harness import roofline

LAYER = "model"
UNIT = "%"
MOVES = "step_ms"


def read(s: dict):
    return roofline.span_share(s, "model.attn")
