"""The reduction of the port's spans (``harness/spans.py``) and the four
readers that take it: backward nodes charged to their forward op's span,
self time, the readers on a shrunk CPU run, and nothing read where the
program has no spans."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import run
from harness import spans

READERS = ("model.host_ms", "render.host_ms", "render.device_ms", "optim.host_ms")
CHARGE = {"MulBackward0": "model.a", "SinBackward0": "model.a", "MmBackward0": "render.b",
          "ExpBackward0": "render.b", "SumBackward0": "render.b"}


def _toy(marked=True):
    """A CPU profile of a forward in two spans and its backward in a third."""
    def mark(name):
        return record_function(name) if marked else torch.profiler.record_function("other")

    x = torch.randn(64, 64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with mark("step.toy"):
            with mark("model.a"):
                y = (x * 2.0).sin()
            with mark("render.b"):
                z = (y @ y).exp().sum()
            with mark("step.backward"):
                z.backward()
    return prof.events()


def _dur(e):
    return e.time_range.end - e.time_range.start


def test_backward_nodes_go_to_their_forward_span():
    events = _toy()
    sp = spans.spans(events, 1)
    assert set(sp) == {"step.toy", "model.a", "render.b", "step.backward", spans.NONE}
    rng = {e.name: e for e in events if e.name in sp}
    nodes = [e for e in events if e.name.startswith(spans.NODE)]
    charged = {n: 0.0 for n in CHARGE.values()}
    for e in nodes:
        kind = e.name[len(spans.NODE):]
        if kind in CHARGE:
            charged[CHARGE[kind]] += _dur(e)
    assert {e.name[len(spans.NODE):] for e in nodes} >= set(CHARGE)
    for name in ("model.a", "render.b"):
        want = (_dur(rng[name]) + charged[name]) / 1e3
        assert sp[name]["host_ms"] == pytest.approx(want, rel=1e-9)
        assert sp[name]["self_ms"] == pytest.approx(want, rel=1e-9)
        assert sp[name]["parent"] == "step.toy" and sp[name]["count"] == 1
    # The step's self time: its range less its three children's.
    kids = sum(_dur(rng[n]) for n in ("model.a", "render.b", "step.backward"))
    assert sp["step.toy"]["host_ms"] == pytest.approx(_dur(rng["step.toy"]) / 1e3, rel=1e-9)
    assert sp["step.toy"]["self_ms"] == pytest.approx((_dur(rng["step.toy"]) - kids) / 1e3,
                                                      rel=1e-9)
    assert 0 < sp["step.toy"]["self_ms"] < sp["step.toy"]["host_ms"]
    # The backward's range keeps its own time; no device work on the CPU.
    assert sp["step.backward"]["host_ms"] == pytest.approx(_dur(rng["step.backward"]) / 1e3)
    assert all(r["device_ms"] == 0 and r["idle_ms"] == 0 for r in sp.values())
    assert spans.cover(sp)["step_self_share"] == pytest.approx(
        sp["step.toy"]["self_ms"] / sp["step.toy"]["host_ms"])


def test_innermost_across_threads():
    """Nested ranges on one thread; on two threads, the later start wins."""
    iv = [(0, 10, 1), (2, 4, 1), (5, 9, 1), (6, 7, 1), (3, 8, 2)]
    assert spans._innermost(iv, [1, 2.5, 3.5, 4.5, 6.5, 8.5, 9.5, 11]) == \
        [0, 1, 4, 4, 3, 2, 0, -1]
    assert spans._parents(iv) == [-1, 0, 0, 2, -1]


def test_shrunk_run_reads_the_span_metrics(tiny):
    """The 128^2 warp cell at the CPU's size, traced: the three host
    metrics read, and the device one is None (no kernels on the CPU)."""
    out = tiny("hocnet_r18_128_box.warp", trace=True)
    got = out["metrics"]
    for name in ("model.host_ms", "render.host_ms", "optim.host_ms"):
        assert got[name]["unit"] == "ms/step" and got[name]["value"] > 0, name
    assert "render.device_ms" not in got
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_spans(name):
    """No traced stretch at hand, or a program without spans: None."""
    read = run.load_metric(name).read
    assert read({"steps": 8}) is None
    assert read({"steps": 1, "spans": spans.spans(_toy(marked=False), 1)}) is None
