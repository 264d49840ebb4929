#!/usr/bin/env python3
"""The consistency-gain ablation with the warp's kernels swapped for their
plain versions: do K1-K4 change what the warp stage learns?

Runs ``tools/repro_torch_consistency.py:main`` on the card twice per seed:

1. ``kernel``: as it is (K1 at C = 2, K2, K3 and K4 on the warp step);
2. ``plain``: with the four kernels' launchers rebound, in this process
   only, to their plain PyTorch versions (``raster_fwd_plain``, ``raster_bwd_plain``,
   ``sample_fwd_plain``, ``sample_bwd_plain``) on the same CUDA tensors.

The dispatchers (``raster_cuda.raster_fwd`` / ``raster_bwd``,
``sample_cuda.sample_fwd`` / ``sample_bwd``) look their ``*_cuda``
launcher up at call time, so rebinding the module attribute reroutes them.
K1 at C = 3 (the synthetic dataset's render) keeps its kernel in both runs,
so the two runs train on the same frames and their baseline and control
stages must give the same figures: only the warp stage differs.

Every step the tool takes is wrapped to read the kernels' launch counters
and the plain versions' call counts around it: a warp step must launch
each kernel once in the kernel run, and call each plain version once
(with no launch) in the plain run; supervised and eval steps touch
neither. A step that breaks this stops the run.

    python -u tools/repro_plain_kernels.py [SEED ...] [--obj_faces N]
        [--frames 16] [--fraction 0.125]

Prints the card's ``nvidia-smi`` name and power limit first, the repro
tool's progress and JSON lines for each run, and a summary: per seed the
six MPJPE figures of both runs, the warp losses at steps 0/100/200, and
d = plain warp MPJPE - kernel warp MPJPE on the unannotated frames, then
the mean and standard deviation of d over seeds. For the box
(``--obj_faces 0``) the baseline and control figures of both runs are
held to ``measurements/torch_repro_box_pr10.log``'s, to the printed digit.
Needs CUDA: without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script: the repo root holds hocon_torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hocon_torch.device import resolve_device
from hocon_torch.render import raster_cuda as RC
from hocon_torch.render import sample_cuda as SC
from tools import repro_torch_consistency as repro

KERNELS = ("K1", "K2", "K3", "K4")
WARP_ATTRS = 2  # K1 at C = 2 renders the warp; C = 3 is the dataset's render
LOGGED_STEPS = (0, 100, 200)
FIGURES = ("baseline_mpjpe_unannotated_mm", "control_extra_steps_mpjpe_unannotated_mm",
           "warp_mpjpe_unannotated_mm", "baseline_mpjpe_all_mm", "warp_mpjpe_all_mm",
           "consistency_gain_mm")
SAME_DATA = ("baseline_mpjpe_unannotated_mm", "control_extra_steps_mpjpe_unannotated_mm",
             "baseline_mpjpe_all_mm")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_REFERENCE = os.path.join(HERE, "measurements", "torch_repro_box_pr10.log")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def launches() -> dict:
    """The four kernels' launch counters, K1 at C = 2 only."""
    return {"K1": RC.raster_fwd.launches_by_attrs.get(WARP_ATTRS, 0),
            "K2": RC.raster_bwd.launches, "K3": SC.sample_fwd.launches,
            "K4": SC.sample_bwd.launches}


class PlainSwap:
    """Rebinds the four kernels' ``*_cuda`` launchers to their plain
    versions while it is entered; ``calls`` counts the plain calls made in
    their place. K1 is swapped at C = 2 only."""

    def __init__(self):
        self.calls = dict.fromkeys(KERNELS, 0)
        self.saved = []

    def _stand_ins(self) -> tuple:
        calls, k1_cuda = self.calls, RC.raster_fwd_cuda

        def k1(coeffs, bounds, krange, image_size, sigma, gamma, config, *, far_logit=None):
            if coeffs.shape[2] // 3 - RC.N_GEOM_ROWS != WARP_ATTRS:
                return k1_cuda(coeffs, bounds, krange, image_size, sigma, gamma, config,
                               far_logit=far_logit)
            calls["K1"] += 1
            return RC.raster_fwd_plain(coeffs, bounds, krange, image_size, sigma, gamma, config)

        def k2(*args):
            calls["K2"] += 1
            return RC.raster_bwd_plain(*args)

        def k3(image, coords):
            calls["K3"] += 1
            return SC.sample_fwd_plain(image, coords)

        def k4(image, coords, g):
            calls["K4"] += 1
            return SC.sample_bwd_plain(image, coords, g)

        return ((RC, "raster_fwd_cuda", k1), (RC, "raster_bwd_cuda", k2),
                (SC, "sample_fwd_cuda", k3), (SC, "sample_bwd_cuda", k4))

    def __enter__(self):
        for mod, name, fn in self._stand_ins():
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.saved.clear()
        return False


def counted_run(seed: int, swap: PlainSwap | None, device, **kwargs) -> dict:
    """One ``repro.main`` run with every step wrapped to read the counters
    around it; returns the record, the unrounded figures, the warp losses
    logged at ``LOGGED_STEPS``, the per-kind counter deltas and the stage
    seconds. A step whose deltas break the rule of the module note raises."""
    plain_calls = swap.calls if swap is not None else dict.fromkeys(KERNELS, 0)
    kinds = {"make_train_step": "supervised", "make_warp_train_step": "warp",
             "make_eval_step": "eval"}
    saved = {name: getattr(repro, name) for name in (*kinds, "log")}
    steps = {kind: 0 for kind in kinds.values()}
    losses = {}

    def now() -> tuple:
        return tuple(launches().values()) + tuple(plain_calls.values())

    def want(kind: str) -> tuple:
        if kind != "warp":
            return (0,) * 8
        return (0,) * 4 + (1,) * 4 if swap is not None else (1,) * 4 + (0,) * 4

    def counting(kind, make):
        def make_counted(*args, **kw):
            step = make(*args, **kw)

            def counted(*a, **k):
                before = now()
                out = step(*a, **k)
                delta = tuple(x - y for x, y in zip(now(), before))
                if delta != want(kind):
                    raise RuntimeError(
                        f"{kind} step {steps[kind]}: launches K1 C=2/K2/K3/K4 {delta[:4]}, "
                        f"plain calls {delta[4:]}, want {want(kind)[:4]} and {want(kind)[4:]}")
                steps[kind] += 1
                return out
            return counted
        return make_counted

    def logged(msg: str) -> None:
        if msg.startswith("[warp] step "):
            step, loss = msg[len("[warp] step "):].split(" loss=")
            losses[int(step)] = float(loss)
        log(msg)

    for name, kind in kinds.items():
        setattr(repro, name, counting(kind, saved[name]))
    repro.log = logged
    by_c_before = dict(RC.raster_fwd.launches_by_attrs)
    try:
        if swap is not None:
            with swap:
                run = repro.main(seed, device=device, **kwargs)
        else:
            run = repro.main(seed, device=device, **kwargs)
    finally:
        for name, value in saved.items():
            setattr(repro, name, value)
    c3 = RC.raster_fwd.launches_by_attrs.get(3, 0) - by_c_before.get(3, 0)
    return {"record": run.record, "mpjpe": {f"{s} {p}": v for (s, p), v in run.mpjpe.items()},
            "losses": losses, "steps": steps, "k1_c3": c3, "seconds": run.seconds}


def reference_records(path: str | None) -> dict:
    """seed -> the JSON record of an earlier log, for the same workload."""
    if path is None:
        return {}
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("{"):
                rec = json.loads(line)
                out[rec["seed"]] = rec
    return out


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def summary(results: list, reference: dict, ref_path) -> tuple[list, bool]:
    """The summary lines and whether the same-data figures agreed."""
    lines, agreed, ds = [], True, []
    lines.append(f"summary: MPJPE (mm) per seed, runs 'kernel' and 'plain'; figures "
                 f"{', '.join(FIGURES)}")
    for r in results:
        k, p = r["kernel"], r["plain"]
        d = p["mpjpe"]["warp unannotated"] - k["mpjpe"]["warp unannotated"]
        ds.append(d)
        for name, run in (("kernel", k), ("plain", p)):
            figs = " / ".join(f"{run['record'][f]:.2f}" for f in FIGURES)
            loss = " / ".join(f"{run['losses'].get(s, math.nan):.3f}" for s in LOGGED_STEPS)
            lines.append(f"  seed {r['seed']} {name:>6}: {figs}; [warp] loss at steps "
                         f"{'/'.join(map(str, LOGGED_STEPS))}: {loss}; warp stage "
                         f"{run['seconds']['warp']:.1f} s")
        same = [f for f in SAME_DATA if k["record"][f] != p["record"][f]]
        bits = all(k["mpjpe"][f"{s} {part}"] == p["mpjpe"][f"{s} {part}"]
                   for s in ("baseline", "control") for part in ("all", "unannotated"))
        ref = reference.get(r["seed"])
        off_ref = ([f for f in SAME_DATA if ref[f] != k["record"][f]] if ref else None)
        agreed &= not same and not off_ref
        lines.append(
            f"  seed {r['seed']}: d = {d:+.4f} mm (plain - kernel warp, unannotated); "
            f"baseline/control equal between the runs: {'yes' if not same else same} "
            f"(bit for bit: {bits}); against {os.path.basename(ref_path) if ref else 'no log'}: "
            f"{'n/a' if ref is None else ('equal' if not off_ref else off_ref)}")
    arr = np.asarray(ds, np.float64)
    std = float(arr.std(ddof=1)) if len(arr) > 1 else math.nan
    lines.append(f"summary: d over {len(arr)} seeds: mean {arr.mean():+.4f} mm, std {std:.4f} mm, "
                 f"min {arr.min():+.4f}, max {arr.max():+.4f}")
    lines.append(json.dumps({"plain": list(KERNELS), "seeds": [r["seed"] for r in results],
                             "d_mm": [round(x, 4) for x in ds], "d_mean_mm": round(float(arr.mean()), 4),
                             "d_std_mm": None if math.isnan(std) else round(std, 4),
                             "same_data_figures_equal": agreed}))
    return lines, agreed


def parse_args(argv=None):
    ap = argparse.ArgumentParser("repro_plain_kernels")
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--obj_faces", type=int, default=0)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--fraction", type=float, default=repro.FRACTION)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    cli = parse_args(argv)
    dev = resolve_device(device)
    if dev.type == "cuda":
        print(smi_line(), flush=True)
    seeds = cli.seeds or [0, 1, 2, 3]
    swap = PlainSwap()
    log(f"=== {time.strftime('%H:%M:%S')} :: repro_plain_kernels seeds {seeds} --obj_faces "
        f"{cli.obj_faces} --frames {cli.frames} --fraction {cli.fraction}; plain run swaps "
        f"{', '.join(KERNELS)} (K1 at C = {WARP_ATTRS} only)")
    kwargs = dict(obj_faces=cli.obj_faces, fraction=cli.fraction, frames=cli.frames)
    results = []
    for seed in seeds:
        r = {"seed": seed}
        for name, s in (("kernel", None), ("plain", swap)):
            log(f"--- seed {seed}, run '{name}'")
            before = dict(swap.calls)
            r[name] = counted_run(seed, s, dev, **kwargs)
            calls = {k: swap.calls[k] - before[k] for k in KERNELS}
            log(f"--- seed {seed}, run '{name}': steps {r[name]['steps']}, K1 at C = 3 "
                f"{r[name]['k1_c3']}, plain calls {calls}; every warp step launched "
                f"{list(KERNELS) if name == 'kernel' else []} once and called the plain "
                f"version of {list(KERNELS) if name == 'plain' else []} once")
        results.append(r)
    reference = BOX_REFERENCE if cli.obj_faces == 0 else None
    lines, agreed = summary(results, reference_records(reference), reference)
    for line in lines:
        print(line, flush=True)
    return 0 if agreed else 1


if __name__ == "__main__":
    sys.exit(main())
