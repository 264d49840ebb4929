"""The comparison that decides ``correct``: the program's first steps
against the reference's on the same weights and batches.

Each number is a relative gap (0 is exact agreement):

- ``loss_gap.1``: the first step's loss (the forward alone);
- ``loss_gap.2_3``: the larger of the second and third steps' (after one
  and two Adam updates);
- ``sup_gap.1``: the worst of the first step's supervised loss terms (the
  model, MANO and projection layers);
- ``photo_gap.1``: the worst of the first step's photometric terms, L1 and
  DSSIM (the render layer; warp cells);
- ``grad_gap``: the worst leaf's first-gradient norm, as the optimizer got
  it (the program's from its first moment after one step), the gap over
  the larger of that leaf's reference norm and the median leaf's;
- ``change_gap``: the same of each leaf's change after the last checked
  step, over the leaves whose reference first gradient is at least a
  thousandth of the median leaf's (Adam moves the others by rounding);
- ``grad_gap.median``, ``change_gap.median``: the median leaf's gap of the
  two. In the warp cells the worst leaf is nearly always the shape head's
  output layer, whose gradient comes through MANO's shape blend shapes
  from the raster's rim slivers, where f32 rounding is amplified: its gap
  swings by orders of magnitude from seed to seed, the median leaf's does
  not.

A cell's workload file lists the numbers it compares, each with its limit.
"""

from __future__ import annotations

import statistics

SMALL_GRAD = 1e-3  # of the median leaf's first-gradient norm


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else float("inf"))


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else 0.0
            for k in ref if keep(k)}


def numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, the leaf or term behind each worst-case number)."""
    out, why = {}, {}
    out["loss_gap.1"] = _rel(prog["losses"][0], ref["losses"][0])
    out["loss_gap.2_3"] = max(_rel(p, r) for p, r in zip(prog["losses"][1:], ref["losses"][1:]))
    for name, keys in (("sup_gap.1", [k for k in ref["terms1"] if "loss_" in k]),
                       ("photo_gap.1", [k for k in ("photo_l1", "photo_dssim")
                                        if k in ref["terms1"]])):
        if keys:
            gaps = {k: _rel(prog["terms1"][k], ref["terms1"][k]) for k in keys}
            why[name] = max(gaps, key=gaps.get)
            out[name] = gaps[why[name]]
    floor = SMALL_GRAD * statistics.median(ref["grads1"].values())
    for name, gaps in (
            ("grad_gap", _leaf_gaps(prog["grads1"], ref["grads1"], lambda k: True)),
            ("change_gap", _leaf_gaps(prog["change"], ref["change"],
                                      lambda k: ref["grads1"][k] >= floor))):
        why[name] = max(gaps, key=gaps.get)
        out[name] = gaps[why[name]]
        out[f"{name}.median"] = statistics.median(gaps.values())
    return out, why


def judge(nums: dict, limits: dict) -> bool:
    """Every compared number within its limit (a NaN fails)."""
    return all(nums[k] <= lim for k, lim in limits.items())
