"""The ``hamer`` family (``reference/families/hamer.py``,
``harness/families/hamer.py``) and its cell ``hamer_vith16_256_hand.warp``:
the family loads, its reference loads nothing of the port or of JAX, its
counts at HaMeR's published widths, its two per-layer readers without
their spans, and a run through ``run.run`` at a small size on the CPU:
correct, and each planted fault not."""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import run
from conftest import shrink
from harness import cost
from harness import families as port_families
from reference import families
from reference.families import hamer

CELL = "hamer_vith16_256_hand.warp"
SEED = 2**31 + 777
# The small size the CPU holds: a ViT of depth 2, width 64 and 4 heads on
# 64^2 crops (12 tokens), a decoder of depth 2.
SMALL = dict(vit_dim=64, vit_depth=2, vit_heads=4, vit_head_dim=16, vit_mlp_dim=256, dec_dim=64,
             dec_depth=2, dec_heads=4, dec_dim_head=16, dec_mlp_dim=64, dec_context_dim=64)


def _cfg() -> dict:
    return run.load_cell(CELL)[0]


def test_family_loads():
    cfg = _cfg()
    assert families.name(cfg) == "hamer"
    assert families.load(cfg) is hamer
    assert callable(port_families.load(cfg).port_model)


def test_reference_loads_nothing_of_the_port():
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.dirname(os.path.abspath(run.__file__))!r})
        import reference.families.hamer
        print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, check=True, cwd=run.ROOT)
    loaded = set(out.stdout.split())
    assert "torch" in loaded
    assert not loaded & {"hocon_torch", *run.FORBIDDEN}
    src = open(hamer.__file__).read()
    assert "hocon_torch" not in src.replace("``hocon_torch``", "")


def test_published_widths_and_counts():
    """2.41e13 matrix FLOPs a warp step of 32 images, 670.4 M parameters,
    192 tokens of 80-wide heads: the configuration states HaMeR's sizes."""
    cfg = _cfg()
    m = cfg["model"]
    assert hamer.trunk_tokens(cfg) == m["trunk_tokens"] == 192
    assert m["vit_dim"] == m["vit_heads"] * m["vit_head_dim"]
    assert m["dec_context_dim"] == m["vit_dim"]
    assert (m["pose_out"], m["betas_out"], m["cam_out"]) == (96, 10, 3)
    assert math.isclose(hamer.flops(cfg, 32), 2.41e13, rel_tol=0.01)
    assert cost.step_flops(cfg, "warp") == hamer.flops(cfg, 32)
    assert math.isclose(hamer.attn_flops(cfg, 32) / hamer.trunk_flops(cfg, 32), 0.024,
                        rel_tol=0.05)
    with torch.device("meta"):
        model = hamer.Model(cfg)
    params = sum(p.numel() for p in model.parameters())
    assert params == m["parameters"]
    assert math.isclose(params, 670.4e6, rel_tol=0.001)


@pytest.mark.parametrize("name", ["model.trunk_roofline", "model.attn_roofline"])
def test_readers_are_silent_without_their_spans(name):
    reader = run.load_metric(name)
    hocnet_cfg = run.load_cell("hocnet_r18_256_obj1280.warp")[0]
    span = {"device_ms": 5.0, "host_ms": 1.0}
    assert reader.read({"cfg": _cfg(), "kind": "warp", "spans": {}}) is None
    assert reader.read({"cfg": _cfg(), "kind": "warp"}) is None
    assert reader.read({"cfg": hocnet_cfg, "kind": "warp",
                        "spans": {"model.trunk": span, "model.attn": span}}) is None
    got = reader.read({"cfg": _cfg(), "kind": "warp",
                       "spans": {"model.trunk": span, "model.attn": span}})
    assert got is not None and got > 0


@pytest.fixture
def small(monkeypatch):
    """``run.run`` on the CPU at ``shrink``'s size with ``SMALL``'s widths."""
    orig = run.load_cell

    def load(name):
        cfg, per_layer = orig(name)
        shrink(cfg)["model"].update(SMALL)
        return cfg, per_layer

    torch.set_num_threads(1)
    monkeypatch.setattr(run, "load_cell", load)
    return lambda fault=None: run.run(CELL, SEED, 0.5, False, "cpu", fault=fault)


def test_small_run_is_correct(small):
    out = small()
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(json.load(open(os.path.join(
        run.HERE, "workloads", f"{CELL}.json")))["limits"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_planted_fault_is_not_correct(small, fault):
    out = small(fault)
    assert out["correct"] is False, (fault, out["checks"])
