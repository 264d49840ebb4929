"""The whole step's share of the card's bf16 peak: the benchmark's count of
one step's matrix FLOPs (``harness/cost.py``, from the configuration's
shapes) over the untraced wall time a step of the same run, against 989
TFLOP/s."""

from harness import cost

LAYER = "step"
UNIT = "%"
MOVES = "step_ms"


def read(s: dict):
    flops = cost.step_flops(s["cfg"], s["kind"])
    return 100.0 * flops / (s["step_ms"] * 1e-3) / cost.PEAK_BF16
