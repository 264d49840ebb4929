"""K3 + K4's share of their roofline: their bytes read once and written
once at the step's shapes over the HBM rate (``harness/cost.py``), over
the measured K3 + K4 device time of the traced steps."""

from harness import cost

LAYER = "kernels"
UNIT = "%"
MOVES = "step_ms"


def read(s: dict):
    launches = s["kernel_launches"]["K3"]
    measured = (s["kernel_ms"]["K3"] + s["kernel_ms"]["K4"]) * 1e-3
    if launches == 0 or measured <= 0:
        return None
    return 100.0 * launches * cost.sample_bytes(s["cfg"]) / cost.PEAK_BYTES / measured
