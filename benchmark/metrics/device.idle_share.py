"""The card's idle share of a step: 1 - device-busy ms a step (traced) over
the untraced wall time a step of the same run."""

LAYER = "device"
UNIT = "%"
MOVES = "step_ms"


def read(s: dict):
    if s["busy_ms"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_ms"] / s["step_ms"])
