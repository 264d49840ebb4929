"""Every configuration, cell and per-layer metric of BENCHMARK.json loads
by name and agrees with the file that defines it."""

import json
import os

import pytest

import run

SPEC = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    cfg, per_layer = run.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert cfg["name"] == entry["config"] == cfg["traffic"]["config"]
    assert cfg["traffic"]["name"] == cell and cfg["traffic"]["traffic"] == entry["traffic"]
    assert cfg["traffic"]["step"] in ("warp", "sup")
    assert per_layer, "every cell reports a per-layer metric"
    assert cfg["traffic"]["limits"], "every cell compares a number"


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = json.load(open(os.path.join(run.ROOT, conf["file"])))
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    mod = run.load_metric(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (metric["layer"], metric["unit"], metric["moves"])
    assert callable(mod.read)
    assert set(metric["workloads"]) <= set(CELLS)


def test_every_cell_reports_step_ms_and_setup():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert {"step_ms", "step_p95_ms", "setup_s"} <= names
