"""Host waits on the card a step: ``cudaStreamSynchronize`` and
``cudaEventSynchronize`` calls in the traced steps (a copy of host data to
the card, or a read of a device value, ends in one). The harness's own
synchronise between traced steps is a ``cudaDeviceSynchronize`` and is not
counted."""

LAYER = "step"
UNIT = "syncs/step"
MOVES = "step_ms"


def read(s: dict):
    return s["syncs"] if s["launches"] > 0 else None
