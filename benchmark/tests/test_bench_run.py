"""A tiny run of the harness's own code path on the CPU: the result line's
keys, the reference's agreement with the port at 64 px, and each planted
fault coming out as not correct."""

import json

import pytest

import run

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line(tiny):
    out = tiny("hocnet_r18_256_obj1280.warp")
    assert list(out) == CONTRACT + ["checks"]
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    json.dumps(out)


def test_traced_line(tiny):
    out = tiny("hocnet_r18_256_obj1280.sup", trace=True)
    assert list(out) == CONTRACT + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    # No device on the CPU: only the host-clock metric can read anything.
    assert set(out["metrics"]) <= {m["name"] for m in run.load_cell(
        "hocnet_r18_256_obj1280.sup")[1]}
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["hocnet_r18_256_obj1280.warp", "hocnet_r18_256_obj1280.sup"])
def test_planted_fault_is_not_correct(tiny, cell, fault):
    out = tiny(cell, fault=fault)
    assert out["correct"] is False, (fault, out["checks"])


def test_box_cell_agrees(tiny):
    out = tiny("hocnet_r18_128_box.warp")
    assert out["correct"] is True, out["checks"]
