#!/usr/bin/env python3
"""The consistency-gain ablation with the TPU's bf16 rounding emulated on
the card: does the reference's matrix-unit rounding explain why the port's
warp stage learns more than the TPU's did?

On the TPU, every f32 ``einsum`` / ``matmul`` of ``hocon`` that does not ask
for ``precision=HIGHEST`` ran at the ``DEFAULT`` precision, which rounds
both operands to bf16 and accumulates in f32; the transposed products of
its backward round theirs too. The TPU sampler cast the image to bf16 and
rounded its y-lerp weights in the kernel body. The port computes all of
this in f32. This tool runs ``tools/repro_torch_consistency.py:main`` with
those products rounded, in this process only, through all three stages,
by group:

- G1, MANO and rotations: every product of ``hocon_torch/geometry/mano.py``
  (``pca_to_full_pose``'s ``@``, ``mano_forward``'s einsums and matmuls)
  and ``geometry/rot.py``'s ``rodrigues`` matmul
  (``hocon/geometry/mano.py:333``, ``:376-407``; ``rot.py:56``);
- G2, projection: ``geometry/project.py``'s two einsums
  (``hocon/geometry/project.py:24``, ``:38``);
- G3, plane rows: the z and attribute rows of ``render/raster.py``
  ``face_planes`` (``hocon/render/raster.py:230``, ``:234``), before the
  rows are packed for K1 and K2, which keep their kernels;
- G4, sampler: K3's launcher is replaced by ``sample_fwd_rounded`` (the
  plain version with the image and the y-lerp weights in bf16, the x-lerp
  in f32, as ``hocon/render/sample_pallas.py:118-121`` and ``:270-274``),
  and K4 launches on the bf16 image. K4's kernel body cannot round the
  y-lerp weights of its x-gradient (``sample_pallas.py:160-166``): that
  rounding is not emulated.

A product at ``DEFAULT`` precision is emulated as ``bf16(a) x bf16(b)`` in
f32 whose backward rounds the incoming cotangent to bf16 before the
transposed products, and passes the operands' gradients through unrounded
(``_Operand``, ``_Cotangent``). Each module's ``torch`` global is replaced
by a stand-in whose ``einsum`` / ``matmul`` round (``_RoundingTorch``); the
port's sources are not touched. K1 at C = 3 (the dataset's render) also
builds its rows through G3, as the TPU's dataset render did.

Every step the tool takes is wrapped to read the kernels' launch counters
and the groups' call counts around it: a warp step must launch K1 at C = 2,
K2 and K4 once each, and K3 once unless G4 replaced it (then the rounded
forward is called once); each active group must be called in every warp
step, G1 and G2 also in every supervised and eval step. A step that breaks
this stops the run. On the card HOCNet replays MANO from CUDA graphs
(``hocon_torch/models/graphs.py``) captured on a signature's first
call, so G1's count adds MANO's graph replays: every graph of a run is
captured inside the swap, since ``repro.main`` builds its models there
(the warp stage's on a deep copy, whose cache starts empty).

    python -u tools/repro_tpu_rounding.py [SEED ...] [--groups [G1 G2 G3 G4]]
        [--obj_faces N] [--frames 16] [--fraction 0.125]
    python tools/repro_tpu_rounding.py --summary LOG [LOG ...]

A run prints the repro tool's progress on stderr and, per seed, one JSON
line on stdout (``{"rounding": [groups], ...}``). ``--summary`` reads such
lines and prints, per group set and seed, baseline, control, warp and gain
(unannotated frames, mm) beside the TPU record
(``measurements/tpu_batch_r5c.log``, ``r5d``, ``r5e``) and the port's run
without rounding (``measurements/torch_repro_box_pr10.log``), the means,
and the verdict
for the full set. A run needs CUDA: without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script: the repo root holds hocon_torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hocon_torch.device import resolve_device
from hocon_torch.geometry import mano as mano_mod
from hocon_torch.geometry import project as project_mod
from hocon_torch.geometry import rot as rot_mod
from hocon_torch.models.graphs import graphed_mano
from hocon_torch.render import raster as raster_mod
from hocon_torch.render import raster_cuda as RC
from hocon_torch.render import sample_cuda as SC
from tools import repro_torch_consistency as repro

GROUPS = ("G1", "G2", "G3", "G4")
KERNELS = ("K1", "K2", "K3", "K4")
WARP_ATTRS = 2
PLANE_ROWS = ("bfk,bfkc->bfc", "bfkc,bfkm->bfcm")  # face_planes' z and attribute rows
LOGGED_STEPS = (0, 100, 200)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_LOGS = [os.path.join(HERE, "measurements", f"tpu_batch_r5{x}.log") for x in "cde"]
PORT_LOG = os.path.join(HERE, "measurements", "torch_repro_box_pr10.log")
TPU_WARP_MM, TPU_GAIN_MM = 17.71, 2.08  # PERF.md section 6: box, seeds 0-7
PORT_WARP_MM = 13.84
FIGURES = {"baseline": "baseline_mpjpe_unannotated_mm",
           "control": "control_extra_steps_mpjpe_unannotated_mm",
           "warp": "warp_mpjpe_unannotated_mm", "gain": "consistency_gain_mm"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class _Operand(torch.autograd.Function):
    """An operand rounded to bf16; its gradient passes through unrounded
    (the product's f32 output gradient, as XLA's transposed dot gives)."""

    @staticmethod
    def forward(ctx, x):
        return bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Cotangent(torch.autograd.Function):
    """Identity whose backward rounds the cotangent to bf16: the operand of
    the transposed products."""

    @staticmethod
    def forward(ctx, y):
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return bf16(g)


def rounded_product(fn, *operands):
    """``fn(*operands)`` at TPU ``DEFAULT`` precision: bf16 operands, f32
    accumulation, in the forward and the backward."""
    return _Cotangent.apply(fn(*(_Operand.apply(x) for x in operands)))


class _RoundingTorch:
    """Stands in for ``torch`` inside one port module: ``einsum`` (those in
    ``equations``, or all) and ``matmul`` round their operands; everything
    else is torch's."""

    def __init__(self, calls: dict, group: str, equations=None, matmul: bool = True):
        self._calls, self._group = calls, group
        self._equations, self._matmul = equations, matmul

    def __getattr__(self, name):
        return getattr(torch, name)

    def einsum(self, equation, *operands):
        if self._equations is not None and equation not in self._equations:
            return torch.einsum(equation, *operands)
        self._calls[self._group] += 1
        return rounded_product(lambda *x: torch.einsum(equation, *x), *operands)

    def matmul(self, a, b):
        if not self._matmul:
            return torch.matmul(a, b)
        self._calls[self._group] += 1
        return rounded_product(torch.matmul, a, b)


def sample_fwd_rounded(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """K3's plain version with the TPU kernel's rounding: the image and the
    y-lerp weights in bf16, the rows lerped in y first, the x-lerp in f32."""
    b, h, w, c = image.shape
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0i = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0i = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0i, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0i, 0.0, 1.0)[..., None]
    flat = bf16(image).reshape(b, h * w, c)
    bidx = torch.arange(b, device=image.device).view((b,) + (1,) * (x.dim() - 1))

    def tap(dy, dx):
        return flat[bidx, (y0i + dy) * w + (x0i + dx)]

    wy0, wy1 = bf16(1 - fy), bf16(fy)
    col0 = tap(0, 0) * wy0 + tap(1, 0) * wy1
    col1 = tap(0, 1) * wy0 + tap(1, 1) * wy1
    return col0 * (1 - fx) + col1 * fx


class TpuRounding:
    """Replaces the products of ``groups`` by their bf16-rounded versions
    while it is entered; ``calls`` counts the rounded calls per group (G4:
    the rounded K3 forward) and ``k4_bf16`` the K4 launches it fed a bf16
    image."""

    def __init__(self, groups=GROUPS):
        unknown = set(groups) - set(GROUPS)
        if unknown:
            raise ValueError(f"unknown groups {sorted(unknown)}")
        self.groups = tuple(g for g in GROUPS if g in groups)
        self.calls = dict.fromkeys(self.groups, 0)
        self.k4_bf16 = 0
        self.saved = []

    def _stand_ins(self) -> list:
        calls, out = self.calls, []
        if "G1" in self.groups:
            pca = mano_mod.pca_to_full_pose

            def pca_to_full_pose(model, pose_pca, use_pca=True, flat_hand_mean=False):
                if not use_pca:
                    return pca(model, pose_pca, use_pca, flat_hand_mean)
                calls["G1"] += 1
                full = rounded_product(torch.matmul, pose_pca,
                                       model.hands_components[: pose_pca.shape[-1]])
                return full if flat_hand_mean else full + model.hands_mean

            out += [(mano_mod, "torch", _RoundingTorch(calls, "G1")),
                    (mano_mod, "pca_to_full_pose", pca_to_full_pose),
                    (rot_mod, "torch", _RoundingTorch(calls, "G1", equations=()))]
        if "G2" in self.groups:
            out.append((project_mod, "torch", _RoundingTorch(calls, "G2", matmul=False)))
        if "G3" in self.groups:
            out.append((raster_mod, "torch",
                        _RoundingTorch(calls, "G3", equations=PLANE_ROWS, matmul=False)))
        if "G4" in self.groups:
            k4_cuda = SC.sample_bwd_cuda

            def k3(image, coords):
                calls["G4"] += 1
                return sample_fwd_rounded(image, coords)

            def k4(image, coords, g):
                self.k4_bf16 += 1
                return k4_cuda(bf16(image).contiguous(), coords, g)

            out += [(SC, "sample_fwd_cuda", k3), (SC, "sample_bwd_cuda", k4)]
        return out

    def __enter__(self):
        for mod, name, fn in self._stand_ins():
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()
        return False


def launches() -> dict:
    """The four kernels' launch counters, K1 at C = 2 only."""
    return {"K1": RC.raster_fwd.launches_by_attrs.get(WARP_ATTRS, 0),
            "K2": RC.raster_bwd.launches, "K3": SC.sample_fwd.launches,
            "K4": SC.sample_bwd.launches}


def counted_run(seed: int, swap: TpuRounding, device, **kwargs) -> dict:
    """One ``repro.main`` run under ``swap`` with every step wrapped to read
    the counters around it (the rule of the module note); returns the
    record, the unrounded figures, the warp losses at ``LOGGED_STEPS``, the
    steps and calls per kind, K1's launches at C = 3 and the stage seconds."""
    kinds = {"make_train_step": "supervised", "make_warp_train_step": "warp",
             "make_eval_step": "eval"}
    saved = {name: getattr(repro, name) for name in (*kinds, "log")}
    steps = dict.fromkeys(kinds.values(), 0)
    calls = {kind: dict.fromkeys(swap.groups, 0) for kind in kinds.values()}
    losses = {}
    g4 = "G4" in swap.groups

    def check(kind: str, launched: dict, called: dict, k4_bf16: int) -> None:
        want = dict.fromkeys(KERNELS, 0)
        if kind == "warp":
            want = {"K1": 1, "K2": 1, "K3": 0 if g4 else 1, "K4": 1}
        needs = {g for g in swap.groups if kind == "warp" or g in ("G1", "G2")}
        wrong = [g for g in needs if called[g] < 1]
        if kind != "warp":
            wrong += [g for g in swap.groups if g in ("G3", "G4") and called[g]]
        if launched != want or wrong or k4_bf16 != (launched["K4"] if g4 else 0) \
                or (g4 and kind == "warp" and called["G4"] != 1):
            raise RuntimeError(f"{kind} step {steps[kind]}: launches {launched} (want {want}), "
                               f"rounded calls {called}, K4 on a bf16 image {k4_bf16}")

    def counting(kind, make):
        def make_counted(*args, **kw):
            step = make(*args, **kw)

            def counted(*a, **k):
                l0, c0, b0 = launches(), dict(swap.calls), swap.k4_bf16
                r0 = graphed_mano.replays
                out = step(*a, **k)
                launched = {n: v - l0[n] for n, v in launches().items()}
                called = {g: swap.calls[g] - c0[g] for g in swap.groups}
                if "G1" in called:
                    called["G1"] += graphed_mano.replays - r0
                check(kind, launched, called, swap.k4_bf16 - b0)
                for g, n in called.items():
                    calls[kind][g] += n
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
    c3_before = RC.raster_fwd.launches_by_attrs.get(3, 0)
    try:
        with swap:
            run = repro.main(seed, device=device, **kwargs)
    finally:
        for name, value in saved.items():
            setattr(repro, name, value)
    return {"rounding": list(swap.groups), "seed": seed, "record": run.record,
            "mpjpe": {f"{s} {p}": v for (s, p), v in run.mpjpe.items()},
            "losses": losses, "steps": steps, "calls": calls,
            "k1_c3": RC.raster_fwd.launches_by_attrs.get(3, 0) - c3_before,
            "seconds": run.seconds}


def _records(paths, key=None) -> dict:
    """JSON lines of the logs; with ``key``, only the box workload of the
    repro's regime (16-frame videos, 1/8 annotated), by seed."""
    out = {}
    for path in paths:
        with open(path) as fh:
            for line in fh:
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if key is None:
                    if "rounding" in rec and "record" in rec:  # a run's line, not a summary's
                        out.setdefault(tuple(rec["rounding"]), {})[rec["seed"]] = rec
                elif (rec.get("obj_faces"), rec.get("fraction"),
                      rec.get("frames_per_video")) == key:
                    out[rec["seed"]] = rec
    return out


def summary(paths) -> list:
    box = (0, 0.125, 16)
    tpu, port = _records(TPU_LOGS, box), _records([PORT_LOG], box)
    lines = []
    for groups, runs in sorted(_records(paths).items()):
        name = "+".join(groups) or "none"
        lines.append(f"rounding {name}: per seed, unannotated MPJPE (mm) baseline / control / "
                     "warp / gain; TPU record; port unrounded")
        rows = []
        for seed in sorted(runs):
            r = runs[seed]["record"]
            cells = [r[FIGURES[k]] for k in FIGURES]
            t = [tpu[seed][FIGURES[k]] for k in FIGURES] if seed in tpu else [np.nan] * 4
            p = [port[seed][FIGURES[k]] for k in FIGURES] if seed in port else [np.nan] * 4
            rows.append((cells, t, p))
            fmt = lambda v: " / ".join(f"{x:.2f}" for x in v)  # noqa: E731
            lines.append(f"  seed {seed}: {fmt(cells)}; TPU {fmt(t)}; port {fmt(p)}")
        arr = np.asarray(rows, np.float64)  # (seeds, run, figure)
        mean = arr.mean(axis=0)
        for label, i in (("emulated", 0), ("TPU", 1), ("port unrounded", 2)):
            lines.append(f"  mean over {len(rows)} seeds, {label}: "
                         + " / ".join(f"{x:.2f}" for x in mean[i]))
        warp, gain = mean[0, 2], mean[0, 3]
        closed = (warp - mean[2, 2]) / (mean[1, 2] - mean[2, 2])
        lines.append(f"  the emulated warp mean closes {closed:.1%} of the gap between the "
                     f"port's {mean[2, 2]:.2f} and the TPU's {mean[1, 2]:.2f} mm on these seeds")
        if len(groups) == len(GROUPS):
            if abs(warp - TPU_WARP_MM) <= 1.0 and abs(gain - TPU_GAIN_MM) <= 1.0:
                verdict = "explains the excess"
            elif warp - PORT_WARP_MM > (TPU_WARP_MM - PORT_WARP_MM) / 2:
                verdict = "explains part of the excess (closes more than half of the gap)"
            else:
                verdict = "does not explain the excess (closes half of the gap or less)"
            lines.append(f"  verdict: warp {warp:.2f} mm against {TPU_WARP_MM} (+-1.0), gain "
                         f"{gain:+.2f} against +{TPU_GAIN_MM} (+-1.0): the rounding {verdict}")
        lines.append(json.dumps({"rounding": list(groups), "seeds": sorted(runs),
                                 "warp_mean_mm": round(float(warp), 4),
                                 "gain_mean_mm": round(float(gain), 4),
                                 "gap_closed": round(float(closed), 4)}))
    return lines


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("repro_tpu_rounding")
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--groups", nargs="*", default=list(GROUPS), choices=GROUPS,
                    help="groups to round; none (a bare --groups) runs the port unrounded, "
                         "its kernels' counters still read around every step")
    ap.add_argument("--obj_faces", type=int, default=0)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--fraction", type=float, default=repro.FRACTION)
    ap.add_argument("--summary", nargs="+", metavar="LOG")
    cli = ap.parse_args(argv)
    if cli.summary:
        for line in summary(cli.summary):
            print(line, flush=True)
        return 0
    dev = resolve_device(device)
    swap = TpuRounding(cli.groups)
    for seed in cli.seeds or [0]:
        log(f"--- seed {seed}, rounding {'+'.join(swap.groups)}")
        r = counted_run(seed, swap, dev, obj_faces=cli.obj_faces, fraction=cli.fraction,
                        frames=cli.frames)
        log(f"--- seed {seed}: steps {r['steps']}, rounded calls {r['calls']}, K1 at C = 3 "
            f"{r['k1_c3']}; every warp step launched K1 (C = 2), K2, K4"
            f"{'' if 'G4' in swap.groups else ', K3'} once")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
