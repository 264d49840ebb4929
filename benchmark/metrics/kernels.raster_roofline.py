"""K1 + K2's share of their roofline: the least time of the traced steps'
raster work (the needed (face, pixel) pairs of each K1 launch's inputs at
the operations a pair, or the bytes, whichever is larger;
``harness/cost.py``) over the measured K1 + K2 device time."""

from harness import cost

LAYER = "kernels"
UNIT = "%"
MOVES = "step_ms"


def read(s: dict):
    measured = (s["kernel_ms"]["K1"] + s["kernel_ms"]["K2"]) * 1e-3
    if not s["k1_inputs"] or measured <= 0:
        return None
    return 100.0 * cost.raster_least_s(s["k1_inputs"]) / measured
