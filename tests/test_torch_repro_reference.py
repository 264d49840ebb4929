"""The tools that settle the port's last two faults against the reference:
``tools/repro_reference_f32.py`` (the JAX package's own f32 consistency gain
at the TPU record's regime, its ``--summary`` and verdict rule) and
``tools/tpu_frames_recipe.py`` (silhouettes and colours of two frame stacks
apart). Nothing here trains: the reference's ``main`` is a stub, the
subprocess a fake, the logs and frames are made in the file."""

from __future__ import annotations

import io
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import repro_reference_f32 as RF  # noqa: E402
from tools import tpu_frames_recipe as FR  # noqa: E402

torch.set_num_threads(1)

FIGS = ("baseline_mpjpe_unannotated_mm", "control_extra_steps_mpjpe_unannotated_mm",
        "warp_mpjpe_unannotated_mm", "consistency_gain_mm")


def _line(seed: int, warp: float, gain: float, nested: bool = False) -> str:
    """One repro JSON line of the box workload at the record's regime, with
    the control at warp + gain."""
    rec = {"seed": seed, "obj_faces": 0, "fraction": 0.125, "frames_per_video": 16,
           FIGS[0]: 20.0, FIGS[1]: warp + gain, FIGS[2]: warp, FIGS[3]: gain}
    if nested:  # tools/repro_tpu_rounding.py's line
        return json.dumps({"rounding": [], "seed": seed, "record": rec})
    return json.dumps(rec)


@pytest.fixture
def logs(tmp_path, monkeypatch):
    """Writes hand-made logs for the four runs and points the summary at
    them; returns a function of (R, P, T) (warp, gain) for seeds 0 and 1."""
    from tools import repro_tpu_rounding as TR

    def write(name, lines):
        path = tmp_path / name
        path.write_text("a progress line\n" + "\n".join(lines) + "\n")
        return str(path)

    def make(ref, port, tpu, port_nested=False):
        mk = lambda wg, nested=False: [_line(s, *wg, nested) for s in (0, 1)]  # noqa: E731
        monkeypatch.setattr(TR, "TPU_LOGS", [write("tpu.log", mk(tpu))])
        monkeypatch.setattr(RF, "ROUNDED_LOG", write("rounded.log", [
            json.dumps({"rounding": list(RF.ROUNDED_GROUPS), "seed": s,
                        "record": json.loads(_line(s, 18.0, 2.0))}) for s in (0, 1)]))
        port_log = write("port.log", mk(port, port_nested))
        monkeypatch.setattr(RF, "PORT_LOGS", [port_log, port_log])
        return RF.summary([write("ref.log", mk(ref))])

    return make


def _verdict(lines) -> str:
    return json.loads(lines[-1])["verdict"]


@pytest.mark.parametrize("ref, port, tpu, want", [
    # faithful: R within 1.0 of P in both, R at least 2.0 from T in the gain
    ((14.0, 5.5), (14.0, 5.5), (17.5, 2.0), "faithful"),
    ((14.0, 5.5), (15.0, 4.5), (17.5, 3.5), "faithful"),  # both boundaries met exactly
    ((14.0, 5.5), (15.25, 5.5), (17.5, 2.0), "undecided"),  # warp 1.25 from the port
    ((14.0, 5.5), (14.0, 4.25), (17.5, 2.0), "undecided"),  # gain 1.25 from the port
    ((14.0, 5.5), (14.0, 5.5), (17.5, 3.75), "undecided"),  # gain only 1.75 from the TPU
    # a port fault: R within 1.0 of T in the gain and 2.0 or more from P
    ((17.5, 2.0), (14.0, 5.5), (17.5, 2.0), "port fault"),
    ((17.5, 2.5), (15.5, 4.0), (17.5, 1.5), "port fault"),  # both boundaries met exactly
    ((17.5, 2.0), (14.0, 4.0), (17.5, 1.0), "port fault"),  # apart in the gain alone
    ((17.5, 2.5), (16.0, 4.0), (17.5, 1.25), "undecided"),  # 1.25 from the TPU
    ((17.5, 2.0), (16.0, 3.5), (17.5, 2.0), "undecided"),  # 1.5 from the port in both
])
def test_summary_verdict(logs, ref, port, tpu, want):
    lines = logs(ref, port, tpu)
    assert _verdict(lines) == want
    assert lines[-2].endswith(RF.VERDICT_TEXT[want])
    assert lines[0].startswith("f32 reference seeds finished: [0, 1]")
    table = "\n".join(lines)
    for name in ("TPU record", "f32 reference, CPU", "port, H100", "port G2+G3 rounded, H100"):
        assert table.count(name) == 3  # two seeds and the mean
    assert f"{ref[0]:6.2f} / {ref[1]:6.2f}" in table


@pytest.mark.parametrize("r, p, t, want", [
    ((14.0, 5.5), (15.0, 6.5), (16.0, 3.5), "faithful"),
    ((14.0, 5.5), (15.0, 6.5), (16.0, 3.5000001), "undecided"),
    ((14.0, 5.5), (15.0000001, 5.5), (16.0, 2.0), "undecided"),
    ((17.0, 2.0), (15.0, 2.5), (17.0, 1.0), "port fault"),
    ((17.0, 2.0), (15.0000001, 2.5), (17.0, 0.9999999), "undecided"),
    ((17.0, 2.0), (17.0, 4.0), (17.0, 3.0), "port fault"),
    ((17.0, 2.0), (17.0, 3.9999999), (17.0, 3.0), "undecided"),
])
def test_verdict_boundaries(r, p, t, want):
    assert RF.verdict(r, p, t) == want


def test_summary_reads_the_rounding_tools_unrounded_lines(logs):
    lines = logs((14.0, 5.5), (14.0, 5.5), (17.5, 2.0), port_nested=True)
    assert _verdict(lines) == "faithful"
    assert json.loads(lines[-1])["port_warp_mm"] == 14.0


def test_summary_with_no_finished_seed(tmp_path):
    empty = tmp_path / "ref.log"
    empty.write_text("[seed 0] [progress] warp call 20 loss=1.0 30.00 s/step\n")
    lines = RF.summary([str(empty)])
    assert lines[-1] == "  no seed of the f32 reference has finished"


def test_record_regime_and_arguments(monkeypatch):
    """The reference's constants are the TPU record's as the script stands;
    the worker overrides none and calls ``main`` with the record's flags."""
    mod = RF.load_reference()
    assert (mod.RES, mod.BATCH, mod.STEPS_BASE, mod.STEPS_WARP, mod.VIDEOS) == \
        (128, 16, 300, 300, 8)
    assert {k: getattr(mod, k) for k in RF.RECORD_CONSTANTS} == RF.RECORD_CONSTANTS
    assert RF.RECORD_ARGS == dict(obj_faces=0, fraction=0.125, frames=16)
    calls = []

    def stub_main(*args, **kwargs):
        calls.append((args, kwargs, {k: getattr(mod, k) for k in RF.RECORD_CONSTANTS}))

    monkeypatch.setattr(mod, "main", stub_main)
    monkeypatch.setattr(RF, "load_reference", lambda: mod)
    monkeypatch.setattr(RF.os, "sched_setaffinity", lambda pid, cores: None)
    RF.worker(3, [0])
    assert calls == [((3,), dict(obj_faces=0, fraction=0.125, frames=16), RF.RECORD_CONSTANTS)]
    # The progress wrapper times the engine's steps and passes them through.
    eng = {"step_base": lambda s, b: (s + 1, {"loss_total": 1.0}),
           "step_warp": lambda s, b: (s + 2, {"loss_total": 2.0})}
    monkeypatch.setattr(mod, "_engine", lambda *a, **k: eng)
    RF.with_progress(mod)
    wrapped = mod._engine(False)
    assert wrapped["step_warp"](1, None) == (3, {"loss_total": 2.0})
    assert mod._engine(False)["step_base"] is wrapped["step_base"]  # wrapped once


def test_constants_checked():
    class Mod:
        RES, BATCH, STEPS_BASE, STEPS_WARP, VIDEOS = 64, 16, 300, 300, 8

    with pytest.raises(RuntimeError, match="differ from the TPU record"):
        RF.check_constants(Mod)


def test_subprocess_cache_is_temporary(monkeypatch, capsys):
    """Each seed's subprocess gets a fresh temporary ``HOCON_CACHE_DIR``
    outside the repo and the user's cache, removed afterwards; its JSON line
    goes to stdout at once, its other lines to stderr with the seed."""
    seen = {}

    class FakeProc:
        def __init__(self, cmd, env, **kw):
            seen.update(cmd=cmd, env=env, existed=os.path.isdir(env["HOCON_CACHE_DIR"]))
            self.stdout = io.StringIO("[warp] step 0 loss=1.0\n" + _line(5, 14.0, 5.5) + "\n")

        def wait(self):
            return 0

    import threading

    monkeypatch.setattr(RF.subprocess, "Popen", FakeProc)
    assert RF.run_seed(5, [0, 1], threading.Lock()) == 0
    cache = seen["env"]["HOCON_CACHE_DIR"]
    assert seen["existed"] and not os.path.exists(cache)
    assert os.path.dirname(cache) == tempfile.gettempdir()
    assert not cache.startswith(REPO)
    assert cache != os.path.expanduser("~/.cache/hocon")
    assert seen["env"]["JAX_PLATFORMS"] == "cpu"
    assert seen["cmd"][-4:] == ["--worker", "5", "--cores", "0,1"]
    out = capsys.readouterr()
    assert json.loads(out.out)["seed"] == 5
    assert "[seed 5] [warp] step 0 loss=1.0" in out.err


def test_split_cores(monkeypatch):
    monkeypatch.setattr(RF.os, "sched_getaffinity", lambda pid: set(range(8)))
    assert RF.split_cores(2) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert RF.split_cores(4) == [[0, 1], [2, 3], [4, 5], [6, 7]]


def _frames() -> tuple[np.ndarray, np.ndarray]:
    """Two 1 x 4 x 5 stacks on the background level: 8 pixels covered in
    both, 1 only in ``a`` and 1 only in ``b``; of the 8, colour differences
    0, 0, 1, 1, 2, 5, 5, 9 levels in their largest channel."""
    bg = FR.BACKGROUND_LEVEL
    a = np.full((1, 4, 5, 3), bg, np.uint8)
    b = a.copy()
    colour = np.array([100, 150, 200], np.uint8)
    both = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3)]
    for (y, x), d in zip(both, (0, 0, 1, 1, 2, 5, 5, 9)):
        a[0, y, x] = colour
        b[0, y, x] = colour
        b[0, y, x, d % 3] += d  # one channel moved by d levels
    a[0, 2, 0] = colour  # only in a
    b[0, 3, 4] = (bg, bg, bg + 2)  # only in b: 2 levels off the background
    a[0, 3, 3] = (bg + 1, bg, bg)  # 1 level off: not covered
    return a, b


def test_frame_split_known_answers():
    a, b = _frames()
    s = FR.frame_split(a, b)
    assert s["silhouette"] == pytest.approx(2 / 20)
    assert s["silhouette_of_covered"] == pytest.approx(2 / 10)
    assert s["covered"] == pytest.approx(9 / 20)
    assert s["colour_gt1"] == pytest.approx(4 / 8)
    assert s["colour_gt4"] == pytest.approx(3 / 8)
    assert s["colour_median"] == pytest.approx(1.5)
    assert FR.frame_split(b, a) == {**s, "covered": pytest.approx(9 / 20)}
    same = FR.frame_split(a, a)
    assert (same["silhouette"], same["colour_gt1"], same["colour_median"]) == (0.0, 0.0, 0.0)


def test_reproduces_rule():
    a, b = _frames()
    assert not FR.reproduces(FR.frame_split(a, b))
    assert FR.reproduces(FR.frame_split(a, a))
    ok = dict(silhouette=FR.SIL_SHARE, colour_gt4=FR.COLOUR_SHARE_4,
              colour_median=FR.MEDIAN_LEVELS)
    assert FR.reproduces(ok)
    for key in ok:
        assert not FR.reproduces({**ok, key: ok[key] * 1.01})
