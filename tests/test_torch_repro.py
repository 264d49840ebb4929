"""``tools/repro_torch_consistency.py`` vs ``scripts/repro_synthetic_consistency.py``.

The reference script is loaded by path and run at a small size, its module
constants overridden as for the port tool (``SMALL``: 64 px, batch 4, 2
videos x 8 frames, 1 of 8 annotated, 2 steps per stage, hand + box, seed
0). The port tool runs the same protocol from the reference's initial
weights (its ``create_train_state(PRNGKey(seed))``, bridged by
``load_flax_variables``) on the reference's own datasets and loaders, so
both sides see the same batches. The reference's warp step runs the culled
Pallas path (``backend="pallas"``, interpret mode on the CPU), the
counterpart of the port's K1 / K2 path. Both models run in f32 here (the
tool's default is bf16 autocast, the reference's ``jnp.bfloat16``): in bf16
the baseline and control figures agreed to only 1.2e-5, in f32 to 2.6e-8,
which holds the stage protocol (the control continuing the baseline's Adam
state) far tighter.

Measured (f32): the baseline and control figures within 2.6e-8 relative,
held at 1e-6; the warp figures within 4.4e-4, held at 1e-3; the gain
(0.5444 mm against 0.5544) within 0.0100 mm absolute, 1.8 % of itself,
held at 0.02 mm, under 1e-3 of every figure. The warp stage is where the
two meet the rim-sliver plane rows, which f32 rounds differently in an
eager and a jitted build (ROADMAP queue 3): the reference run eagerly
(``jax.disable_jit()``, ``backend="xla"``) gives a gain of 0.5449 mm, 0.0005
from the port's and 0.0132 (2.4 %) from its own jitted run, so 1 % of the
gain is below the reference's own spread between builds.
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_repro.py`` prints
those runs side by side (about 4 minutes).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hocon.data.factory as ref_factory
import hocon.data.pipeline as ref_pipeline
import hocon.evaluation.zimeval as ref_zimeval
import hocon.models.hocnet as ref_hocnet
import hocon.train.state as ref_state
import hocon.train.steps as ref_steps
import hocon_torch.render.raster_cuda as TRC
import hocon_torch.render.sample_cuda as TSC
import tools.repro_torch_consistency as tool
from hocon_torch.models.hocnet import HOCNet as PortHOCNet
from hocon_torch.utils.flax_weights import load_flax_variables

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).parent.parent


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("repro_synthetic_consistency", "scripts/repro_synthetic_consistency.py")
summarize = _load("summarize_consistency", "scripts/summarize_consistency.py")

SMALL = dict(RES=64, BATCH=4, STEPS_BASE=2, STEPS_WARP=2, VIDEOS=2, FRAMES=8)
SEED = 0
STAGES = ("baseline", "warp", "control")
FIGURES = [(stage, part) for stage in STAGES for part in ("all", "unannotated")]
# Relative bars per stage and the gain's absolute one (mm); measured values
# in the module note.
RTOL = {"baseline": 1e-6, "control": 1e-6, "warp": 1e-3}
GAIN_ATOL_MM = 0.02
KERNELS = (TRC.raster_fwd, TRC.raster_bwd, TSC.sample_fwd, TSC.sample_bwd)


def _small(mp, module):
    for k, v in SMALL.items():
        mp.setattr(module, k, v)


@dataclasses.dataclass
class RefRun:
    figures: dict  # (stage, part) -> mm, unrounded
    record: dict  # the printed JSON line
    variables: dict  # the initial weights, PRNGKey(SEED)
    mano: object


def reference_run(mp, backend: str = "pallas", eager: bool = False) -> RefRun:
    """The reference's ``main`` at ``SMALL`` in f32, its warp step on
    ``backend``; every jit off with ``eager``."""
    _small(mp, ref)
    mp.setattr(ref, "_ENGINE", {})
    ref_net = ref_hocnet.HOCNet
    mp.setattr(ref_hocnet, "HOCNet", lambda **kw: ref_net(**dict(kw, dtype=jnp.float32)))
    make_warp = ref_steps.make_warp_train_step
    mp.setattr(ref_steps, "make_warp_train_step",
               lambda *a, **kw: make_warp(*a, **dict(kw, backend=backend)))
    figures, inits = [], []
    get_measures = ref_zimeval.EvalUtil.get_measures

    def record_measures(self, *a):
        out = get_measures(self, *a)
        figures.append(out[0])
        return out

    mp.setattr(ref_zimeval.EvalUtil, "get_measures", record_measures)
    create = ref_state.create_train_state

    def record_init(*a, **kw):
        state = create(*a, **kw)
        # Before the train step donates the state's buffers.
        inits.append(jax.device_get({"params": state.params,
                                     "batch_stats": state.batch_stats}))
        return state

    mp.setattr(ref_state, "create_train_state", record_init)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), (jax.disable_jit() if eager else contextlib.nullcontext()):
        ref.main(SEED, obj_faces=0, fraction=0.125, frames=SMALL["FRAMES"])
    (line,) = out.getvalue().splitlines()
    return RefRun(dict(zip(FIGURES, figures)), json.loads(line), inits[0],
                  ref._ENGINE[(False, 2.0)]["mano"])


def port_run(mp, want: RefRun):
    """The port tool's ``main`` at ``SMALL`` in f32, from the reference's
    weights on the reference's datasets and loaders; (Run, launches of
    K1-K4)."""
    _small(mp, tool)

    def ref_get_dataset(*a, mano=None, device=None, **kw):
        return ref_factory.get_dataset(*a, mano=want.mano, **kw)

    def bridged(**kw):
        net = PortHOCNet(**dict(kw, dtype=torch.float32))
        load_flax_variables(net, want.variables)
        return net

    mp.setattr(tool, "get_dataset", ref_get_dataset)
    mp.setattr(tool, "BatchLoader", ref_pipeline.BatchLoader)
    mp.setattr(tool, "HOCNet", bridged)
    for f in KERNELS:
        f.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        run = tool.main(SEED, obj_faces=0, fraction=0.125, frames=SMALL["FRAMES"],
                        device="cpu")
    return run, [f.launches for f in KERNELS]


@pytest.fixture(scope="module")
def runs():
    """Both protocols from the same weights and batches: (RefRun, the port's
    Run, the port's kernel launches)."""
    mp = pytest.MonkeyPatch()
    try:
        want = reference_run(mp)
        got, launches = port_run(mp, want)
    finally:
        mp.undo()
    return want, got, launches


def _gain(figures):
    return figures["control", "unannotated"] - figures["warp", "unannotated"]


@pytest.mark.parametrize("figure", [f"{s}_{p}" for s, p in FIGURES] + ["gain"])
def test_figures_match_reference(runs, figure):
    """Each of the six MPJPE figures, unrounded, within its stage's relative
    bar of the reference's; the gain (control minus warp on the unannotated
    frames) within ``GAIN_ATOL_MM``."""
    want, got, _ = runs
    if figure == "gain":
        g, w = _gain(got.mpjpe), _gain(want.figures)
        np.testing.assert_allclose(g, w, rtol=0, atol=GAIN_ATOL_MM)
        assert GAIN_ATOL_MM < 1e-3 * min(want.figures.values())
    else:
        stage, part = figure.split("_")
        g, w = got.mpjpe[stage, part], want.figures[stage, part]
        np.testing.assert_allclose(g, w, rtol=RTOL[stage])
    assert math.isfinite(g)


def test_stage_protocol(runs):
    """Stage B trains a copy of the baseline model under a fresh Adam state;
    the control continues the baseline's own state; CPU tensors launch no
    kernel."""
    _, got, launches = runs
    base, warp = got.base_state, got.warp_state
    assert warp.model is not base.model
    base_params = {id(p) for p in base.model.parameters()}
    assert not base_params & {id(p) for p in warp.model.parameters()}
    # Each optimizer holds its own model's parameters only.
    assert {id(p) for p in warp.optimizer.state} == {id(p) for p in warp.model.parameters()}
    assert {id(p) for p in base.optimizer.state} == base_params
    # OptaxAdam counts its updates per group: the warp copy's from 0.
    assert warp.step == SMALL["STEPS_WARP"]
    assert {g["count"] for g in warp.optimizer.param_groups} == {SMALL["STEPS_WARP"]}
    total = SMALL["STEPS_BASE"] + SMALL["STEPS_WARP"]
    assert base.step == total
    assert {g["count"] for g in base.optimizer.param_groups} == {total}
    assert launches == [0, 0, 0, 0]
    assert set(got.seconds) == {"datasets", *STAGES}


def test_tool_prints_the_reference_line(runs, monkeypatch, capsys, tmp_path):
    """The tool's own end-to-end run on the CPU (its own datasets, 32 px,
    bf16 autocast): one JSON line on stdout with the reference's keys in its
    order, which ``scripts/summarize_consistency.py`` reads."""
    want, _, _ = runs
    _small(monkeypatch, tool)
    monkeypatch.setattr(tool, "RES", 32)
    capsys.readouterr()
    result = tool.main(SEED, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert list(record) == list(want.record)
    assert record == result.record
    assert all(math.isfinite(v) for v in record.values())
    assert record["consistency_gain_mm"] == round(_gain(result.mpjpe), 2)
    log = tmp_path / "port.log"
    log.write_text("[baseline] step 0 loss=1.0\n" + lines[0] + "\n")
    summarize.main([str(log)])
    out = capsys.readouterr().out.splitlines()
    head = out.index("box (12-face), fraction=0.125, 8-frame videos: n=3 seeds=[0, 1, 2]")
    # Seed 0's committed gain is replaced by the line's.
    assert out[head + 1].startswith(f"  gains: [{record['consistency_gain_mm']}, ")


def test_tool_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(SEED)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.cli_main(["0", "--frames", "16"])


_SWALLOWED = {
    # name: (the flags, the seeds typed after them)
    "fraction": (["--fraction", "0.25", "0.125"], ["0", "1", "2"]),
    "spacing": (["--frames", "16", "--spacing", "3"], ["0", "1"]),
}


@pytest.mark.parametrize("case", list(_SWALLOWED))
def test_swallowed_seeds_are_refused(case, capsys):
    """Seeds after ``--fraction`` / ``--spacing`` are taken as values; the
    tool refuses them with the reference's message and exit code."""
    flags, seeds = _SWALLOWED[case]
    argv = flags + seeds
    with pytest.raises(SystemExit) as exc:
        tool.parse_args(argv)
    err = capsys.readouterr().err.splitlines()[-1]
    r = subprocess.run([sys.executable, "scripts/repro_synthetic_consistency.py", *argv],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert exc.value.code == r.returncode == 2
    assert err == r.stderr.splitlines()[-1].replace("repro_synthetic_consistency",
                                                    "repro_torch_consistency")
    assert "put seeds before" in err
    # Seeds first is the command line the guard asks for.
    assert tool.parse_args(seeds + flags)[0] == [int(s) for s in seeds]


if __name__ == "__main__":
    # The reference's own spread between builds beside the port (f32, SMALL).
    mp = pytest.MonkeyPatch()
    rows = {}
    for name, backend, eager in (("reference pallas", "pallas", False),
                                 ("reference xla", "xla", False),
                                 ("reference xla eager", "xla", True)):
        rows[name] = reference_run(mp, backend, eager)
        mp.undo()
    port, _ = port_run(mp, rows["reference pallas"])
    mp.undo()
    table = {name: r.figures for name, r in rows.items()}
    table["port (tool, auto)"] = port.mpjpe
    for name, figs in table.items():
        cells = " ".join(f"{figs[f]:.4f}" for f in FIGURES)
        print(f"{name:22s} {cells} gain {_gain(figs):.4f}")
