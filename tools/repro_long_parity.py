#!/usr/bin/env python3
"""Long f32 parity of the consistency-gain protocol on the CPU: does the
port's warp stage follow ``hocon``'s over ~100 steps?

``tests/test_torch_repro.py`` holds ``tools/repro_torch_consistency.py``
to ``scripts/repro_synthetic_consistency.py`` over 2 steps a stage. This
tool runs the same bridge for longer, at the test's ``SMALL`` size (64 px,
batch 4, 2 videos x 8 frames, 1 of 8 annotated, hand + box, ``--seed``,
default 0), both models in f32:

- ``port``: the reference script (loaded by path, its constants
  overridden) with its warp step on ``backend="pallas"`` (the culled
  raster, Pallas in interpret mode) and jitted, then the port tool from the
  reference's initial weights (``load_flax_variables``) on the reference's
  datasets and loaders, so both see the same batches. Writes
  ``ref_pallas.json`` and ``port.json``;
- ``xla``: the jitted reference with ``backend="xla"`` (``ref_xla.json``);
- ``eager``: the reference with every jit off (``jax.disable_jit()``,
  ``backend="xla"``), its own spread against the jitted build
  (``ref_eager.json``).

Each run records the terms of every train step (the wrapped step reads
them on the host) and the six MPJPE figures. The baseline and control
stages are cut to ``--steps_base`` / ``--steps_control`` steps, the warp
stage runs ``--steps_warp``; the control stage's length is set when the
last warp step returns, since both scripts read ``STEPS_WARP`` for it.

    python -u tools/repro_long_parity.py run port --out DIR
    python -u tools/repro_long_parity.py run xla --out DIR
    python -u tools/repro_long_parity.py run eager --out DIR
    python tools/repro_long_parity.py summary DIR

``summary`` prints every warp step's loss for each run, the six figures,
and the verdict: the port is faithful in f32 if at every 10th warp step
|port - jitted ref| <= max(2 |eager ref - jitted ref|, 1 % of the jitted
ref's loss), and its loss is below the jitted reference's at no more than
80 % of the warp steps. When it is not, it prints the first step out of
the band term by term. Runs on the CPU only (``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import time
from unittest import mock

os.environ["JAX_PLATFORMS"] = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __package__ in (None, ""):
    sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")  # as the test suite runs it

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZE = dict(RES=64, BATCH=4, VIDEOS=2, FRAMES=8)
FRACTION = 0.125
STAGES = ("baseline", "warp", "control")
FIGURES = [f"{stage}_{part}" for stage in STAGES for part in ("all", "unannotated")]
CHECK_EVERY = 10
SPREAD_FACTOR = 2.0
LOSS_RTOL = 0.01
MAX_LOWER_SHARE = 0.8
RUNS = ("port", "xla", "eager")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load_reference():
    """A fresh module of the reference script (its step cache is module
    state)."""
    path = os.path.join(REPO, "scripts", "repro_synthetic_consistency.py")
    spec = importlib.util.spec_from_file_location("repro_synthetic_consistency", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _floats(terms) -> dict:
    return {k: float(np.asarray(v)) for k, v in terms.items()}


def _recorded(make, trace: list, script, steps_warp: int = 0, steps_control: int = 0,
              **overrides):
    """``make`` wrapped so that its step appends each step's terms to
    ``trace``; a warp step also cuts the control stage once the last warp
    step has run."""

    def wrapped(*a, **kw):
        step = make(*a, **dict(kw, **overrides))

        def run(state, batch):
            state, terms = step(state, batch)
            trace.append(_floats(terms))
            if steps_warp and len(trace) == steps_warp:
                script.STEPS_WARP = steps_control
            return state, terms

        return run

    return wrapped


def _sized(script, args) -> None:
    for k, v in SIZE.items():
        setattr(script, k, v)
    script.STEPS_BASE, script.STEPS_WARP = args.steps_base, args.steps_warp


def reference_run(args, backend: str, eager: bool) -> tuple[dict, dict, object]:
    """The reference's ``main`` in f32 with the warp step on ``backend``;
    returns (record, initial variables, MANO model)."""
    import hocon.evaluation.zimeval as ref_zimeval
    import hocon.models.hocnet as ref_hocnet
    import hocon.train.state as ref_state
    import hocon.train.steps as ref_steps

    ref = _load_reference()
    _sized(ref, args)
    warp, supervised, figures, inits = [], [], [], []
    ref_net, get_measures, create = (ref_hocnet.HOCNet, ref_zimeval.EvalUtil.get_measures,
                                     ref_state.create_train_state)

    def record_measures(self, *a):
        out = get_measures(self, *a)
        figures.append(float(out[0]))
        return out

    def record_init(*a, **kw):
        state = create(*a, **kw)
        # Before the train step donates the state's buffers.
        inits.append(jax.device_get({"params": state.params, "batch_stats": state.batch_stats}))
        return state

    patches = (
        mock.patch.object(ref_hocnet, "HOCNet",
                          lambda **kw: ref_net(**dict(kw, dtype=jnp.float32))),
        mock.patch.object(ref_steps, "make_warp_train_step",
                          _recorded(ref_steps.make_warp_train_step, warp, ref, args.steps_warp,
                                    args.steps_control, backend=backend)),
        mock.patch.object(ref_steps, "make_train_step",
                          _recorded(ref_steps.make_train_step, supervised, ref)),
        mock.patch.object(ref_zimeval.EvalUtil, "get_measures", record_measures),
        mock.patch.object(ref_state, "create_train_state", record_init),
    )
    out = io.StringIO()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(out))
        if eager:
            stack.enter_context(jax.disable_jit())
        ref.main(args.seed, obj_faces=0, fraction=FRACTION, frames=SIZE["FRAMES"])
    record = {"figures": dict(zip(FIGURES, figures)), "warp": warp, "supervised": supervised,
              "line": json.loads(out.getvalue().splitlines()[-1]),
              "seconds": time.time() - t0, "backend": backend, "eager": eager}
    return record, inits[0], ref._ENGINE[(False, 2.0)]["mano"]


def port_run(args, variables, mano) -> dict:
    """The port tool's ``main`` in f32 on the CPU, from the reference's
    weights on the reference's datasets and loaders."""
    import hocon.data.factory as ref_factory
    import hocon.data.pipeline as ref_pipeline
    from hocon_torch.utils.flax_weights import load_flax_variables
    from tools import repro_torch_consistency as tool

    _sized(tool, args)
    warp, supervised = [], []
    port_net = tool.HOCNet

    def bridged(**kw):
        net = port_net(**dict(kw, dtype=torch.float32))
        load_flax_variables(net, variables)
        return net

    def ref_get_dataset(*a, device=None, **kw):
        return ref_factory.get_dataset(*a, **dict(kw, mano=mano))

    patches = (
        mock.patch.object(tool, "get_dataset", ref_get_dataset),
        mock.patch.object(tool, "BatchLoader", ref_pipeline.BatchLoader),
        mock.patch.object(tool, "HOCNet", bridged),
        mock.patch.object(tool, "make_warp_train_step",
                          _recorded(tool.make_warp_train_step, warp, tool, args.steps_warp,
                                    args.steps_control)),
        mock.patch.object(tool, "make_train_step",
                          _recorded(tool.make_train_step, supervised, tool)),
    )
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        run = tool.main(args.seed, obj_faces=0, fraction=FRACTION, frames=SIZE["FRAMES"],
                        device="cpu")
    figures = {f"{s}_{p}": float(run.mpjpe[s, p]) for s in STAGES for p in ("all", "unannotated")}
    return {"figures": figures, "warp": warp, "supervised": supervised, "line": run.record,
            "seconds": time.time() - t0, "backend": "auto", "eager": True}


def cmd_run(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    torch.set_num_threads(args.threads)
    if args.run == "port":
        runs = {}
        runs["ref_pallas"], variables, mano = reference_run(args, "pallas", eager=False)
        runs["port"] = port_run(args, variables, mano)
    elif args.run == "xla":
        runs = {"ref_xla": reference_run(args, "xla", eager=False)[0]}
    else:
        runs = {"ref_eager": reference_run(args, "xla", eager=True)[0]}
    for name, rec in runs.items():
        rec["steps"] = dict(base=args.steps_base, warp=args.steps_warp,
                            control=args.steps_control, seed=args.seed)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(rec, f)
        log(f"{name}: {len(rec['warp'])} warp steps, {len(rec['supervised'])} supervised "
            f"steps in {rec['seconds']:.1f} s; figures {rec['figures']}")


def _rel_term(got: dict, want: dict, key: str) -> float:
    return abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)


def _gain(fig: dict) -> float:
    return fig["control_unannotated"] - fig["warp_unannotated"]


def cmd_summary(args) -> int:
    names = ("port", "ref_pallas", "ref_eager", "ref_xla")
    runs = {}
    for name in names:
        path = os.path.join(args.dir, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                runs[name] = json.load(f)
    missing = {"port", "ref_pallas", "ref_eager"} - set(runs)
    if missing:
        raise SystemExit(f"missing runs: {sorted(missing)}")
    n = min(len(r["warp"]) for r in runs.values())
    loss = {k: np.array([t["loss_total"] for t in r["warp"][:n]]) for k, r in runs.items()}
    print(f"# steps per stage: {runs['port']['steps']}; seconds: "
          + ", ".join(f"{k} {r['seconds']:.1f}" for k, r in runs.items()))
    for k in runs:
        for i in range(n):
            print(f"[{k}] [warp] step {i} loss={loss[k][i]:.6f}")
    print("# six MPJPE figures (mm) and the gain, unrounded")
    print("run         " + " ".join(f"{f:>22s}" for f in FIGURES) + "   gain")
    for k, r in runs.items():
        print(f"{k:11s} " + " ".join(f"{r['figures'][f]:22.6f}" for f in FIGURES)
              + f"   {_gain(r['figures']):.6f}")

    port, jit, eager = loss["port"], loss["ref_pallas"], loss["ref_eager"]
    d_port, d_ref = np.abs(port - jit), np.abs(eager - jit)
    band = np.maximum(SPREAD_FACTOR * d_ref, LOSS_RTOL * np.abs(jit))
    checked = list(range(0, n, CHECK_EVERY)) + ([n - 1] if (n - 1) % CHECK_EVERY else [])
    print("# every 10th warp step: loss of port, jitted ref (pallas), eager ref (xla)"
          + (", jitted ref (xla)" if "ref_xla" in loss else "")
          + "; |port - jit|, |eager - jit|, band, inside")
    for i in checked:
        xla = f" {loss['ref_xla'][i]:12.6f}" if "ref_xla" in loss else ""
        print(f"step {i:4d} {port[i]:12.6f} {jit[i]:12.6f} {eager[i]:12.6f}{xla} "
              f"{d_port[i]:11.6f} {d_ref[i]:11.6f} {band[i]:11.6f} {bool(d_port[i] <= band[i])}")
    lower = float(np.mean(port < jit))
    inside = all(d_port[i] <= band[i] for i in checked)
    faithful = inside and lower <= MAX_LOWER_SHARE
    print(f"# the port's loss below the jitted reference's at {lower:.1%} of {n} warp steps "
          f"(rule: <= {MAX_LOWER_SHARE:.0%}); every checked step inside its band: {inside}")
    print("# divergence from the jitted reference (pallas) by run: relative |d| of the loss and "
          "of grad_norm at early steps; over all steps the share below it and the mean relative "
          "|d loss|")
    for k in runs:
        if k == "ref_pallas":
            continue
        early = " ".join(
            f"{i}:{abs(loss[k][i] - jit[i]) / abs(jit[i]):.2e}/"
            f"{_rel_term(runs[k]['warp'][i], runs['ref_pallas']['warp'][i], 'grad_norm'):.2e}"
            for i in (1, 2, 5, 10, 20) if i < n)
        print(f"{k:11s} steps {early}; below {np.mean(loss[k] < jit):.0%}, mean relative |d| "
              f"{np.mean(np.abs(loss[k] - jit) / np.abs(jit)):.4f}")
    print(f"# gains: port {_gain(runs['port']['figures']):.4f} mm, jitted ref "
          f"{_gain(runs['ref_pallas']['figures']):.4f}, eager ref "
          f"{_gain(runs['ref_eager']['figures']):.4f}")
    if not faithful:
        first = next(i for i in checked if d_port[i] > band[i]) if not inside else checked[-1]
        print(f"# first checked step out of the band: {first}; its terms, port against jitted ref")
        for k in sorted(runs["port"]["warp"][first]):
            a, b = runs["port"]["warp"][first][k], runs["ref_pallas"]["warp"][first].get(k)
            print(f"  {k:28s} {a:14.6f} {b if b is None else f'{b:14.6f}'}")
    print(json.dumps({"faithful_f32": faithful, "lower_share": lower, "checked_inside": inside,
                      "warp_steps": n}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("repro_long_parity")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("run", choices=RUNS)
    r.add_argument("--out", required=True)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--steps_base", type=int, default=20)
    r.add_argument("--steps_warp", type=int, default=100)
    r.add_argument("--steps_control", type=int, default=20)
    r.add_argument("--threads", type=int, default=2)
    s = sub.add_parser("summary")
    s.add_argument("dir")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        cmd_run(args)
        return 0
    return cmd_summary(args)


if __name__ == "__main__":
    sys.exit(main())
