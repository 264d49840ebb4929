#!/usr/bin/env python3
"""The paper's consistency-gain ablation on the port, on one CUDA card:

    sparse supervision + photometric consistency  >  sparse supervision alone

Port of ``scripts/repro_synthetic_consistency.py``, with its protocol,
constants, command line and output. MPJPE is measured over ALL frames of
the synthetic training videos, only ``--fraction`` of which carry
annotations; the rest are covered only by the warp loss. Three stages per
seed:

A. baseline: a fresh ``HOCNet(seed=seed)`` (ResNet-18 in bf16 autocast,
   frozen batch norm) trained ``STEPS_BASE`` supervised steps with Adam at
   2e-4 on the annotated frames;
B. warp: a copy of the baseline model with a fresh Adam state, trained
   ``STEPS_WARP`` frame-pair steps (supervised terms on the annotated
   frames + ``lambda_consist`` x the photometric loss through K1-K4);
C. control: the baseline's own train state (weights, Adam moments, step
   count) continued ``STEPS_WARP`` more supervised steps: the
   equal-compute control.

    python -u tools/repro_torch_consistency.py [SEED ...] [--obj_faces 1280]
        [--frames 16] [--fraction F ...] [--lambda_consist 2.0] [--spacing S ...]

Prints one JSON line per run on stdout, with the reference's keys, which
``scripts/summarize_consistency.py <log>`` reads; progress goes to stderr.
Runs on CUDA (``hocon_torch.device``): without a card it raises.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script: the repo root holds hocon_torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hocon_torch.data.factory import get_dataset
from hocon_torch.data.pipeline import BatchLoader
from hocon_torch.device import resolve_device
from hocon_torch.evaluation.zimeval import EvalUtil
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.train.state import TrainState, create_train_state, make_optimizer
from hocon_torch.train.steps import make_eval_step, make_train_step, make_warp_train_step


def log(msg):
    print(msg, file=sys.stderr, flush=True)


FRACTION = 0.125  # 1 annotated frame per 8-frame video (default)
RES = 128
BATCH = 16
STEPS_BASE = 300
STEPS_WARP = 300
VIDEOS, FRAMES = 8, 8  # defaults; --frames overrides (sparsity ablation)


@dataclasses.dataclass
class Run:
    """One seed's run: the printed record, its six MPJPE figures unrounded
    (mm; ``(stage, "all" | "unannotated")``), the seconds of each part, and
    the train states the stages left."""

    record: dict
    mpjpe: dict
    seconds: dict
    base_state: TrainState
    warp_state: TrainState


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def main(seed: int = 0, obj_faces: int = 0, fraction: float = FRACTION,
         frames: int = FRAMES, lambda_consist: float = 2.0, spacing: int = 3,
         device: str | torch.device | None = None) -> Run:
    """Stages A, B and C for one seed; prints its JSON line on stdout and
    returns the ``Run``."""
    dev = resolve_device(device)
    with_object = obj_faces > 0
    mano = synthetic_mano_model(0, device=dev)
    seconds = {}

    common = dict(
        image_size=RES, use_objects=with_object, mano=mano,
        synth_videos=VIDEOS, synth_frames=frames, seed=seed,
        synth_obj_faces=obj_faces, device=dev,
    )
    t0 = time.time()
    ds_single = get_dataset("synthetic", "train", fraction=fraction,
                            train=True, **common)
    ds_pair = get_dataset("synthetic", "train", fraction=fraction,
                          train=True, pair_mode=True, pair_spacing=spacing,
                          **common)
    ds_eval = get_dataset("synthetic", "train", fraction=1.0, train=False,
                          **common)
    seconds["datasets"] = time.time() - t0
    log(f"datasets built in {seconds['datasets']:.1f}s")

    loader_single = BatchLoader(ds_single, BATCH, seed=0)
    loader_pair = BatchLoader(ds_pair, BATCH, seed=0)
    loader_eval = BatchLoader(ds_eval, BATCH, shuffle=False, drop_last=False)

    def train(state, loader, step_fn, n_steps, tag):
        t0 = time.time()
        it, epoch = iter(loader.epoch(0)), 0
        for i in range(n_steps):
            try:
                batch = next(it)
            except StopIteration:
                epoch += 1
                it = iter(loader.epoch(epoch))
                batch = next(it)
            state, terms = step_fn(state, batch)
            if i % 100 == 0:  # the only host reads of the loss
                log(f"[{tag}] step {i} loss={float(terms['loss_total']):.3f}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[tag] = time.time() - t0
        log(f"[{tag}] {n_steps} steps in {seconds[tag]:.1f}s")
        return state

    mpjpe = {}

    def evaluate(state, eval_step, tag):
        ev_all, ev_unsup = EvalUtil(), EvalUtil()
        # Supervised flags from the TRAIN dataset (same frames, identical
        # ordering; asserted against the eval split's length).
        sup_train = np.asarray(ds_single.pose_dataset.supervised)
        assert len(sup_train) == len(ds_eval.pose_dataset.supervised)
        idx = 0
        for batch in loader_eval.epoch(0):
            # drop_last=False wrap-around padding rows carry _valid=0 and
            # must not be scored (they would double-count early frames).
            pred = _host(eval_step(state, batch)["joints_c_mm"])
            gt = _host(batch["joints3d"])
            valid = _host(batch.get("_valid", np.ones(gt.shape[0]))) > 0
            for k in range(gt.shape[0]):
                if not valid[k]:
                    continue
                ev_all.feed(gt[k], pred[k])
                if not sup_train[idx]:
                    ev_unsup.feed(gt[k], pred[k])
                idx += 1
        assert idx == len(sup_train), (idx, len(sup_train))
        mpjpe[tag, "all"] = ev_all.get_measures(0, 50, 20)[0]
        mpjpe[tag, "unannotated"] = ev_unsup.get_measures(0, 50, 20)[0]
        log(f"[{tag}] MPJPE all={mpjpe[tag, 'all']:.2f}mm "
            f"unannotated={mpjpe[tag, 'unannotated']:.2f}mm")

    # --- Stage A: sparse supervision only ---
    optimizer = make_optimizer("adam", 2e-4)
    model = HOCNet(with_object=with_object, freeze_batchnorm=True,
                   dtype=torch.bfloat16, seed=seed, device=dev)
    state = create_train_state(model, optimizer)
    step_base = make_train_step(model, mano, optimizer, device=dev)
    eval_base = make_eval_step(model, mano, device=dev)
    state = train(state, loader_single, step_base, STEPS_BASE, "baseline")
    evaluate(state, eval_base, "baseline")

    # --- Stage B: + photometric consistency (warm start, ref protocol) ---
    # A copy of the baseline's weights under a fresh Adam state at step 0;
    # the steps are bound to the copy.
    warp_model = copy.deepcopy(model)
    warp_state = create_train_state(warp_model, optimizer)
    step_warp = make_warp_train_step(
        warp_model, mano, optimizer, image_size=(RES, RES),
        lambda_consist=lambda_consist, consist_gt_refs=True, backend="auto",
        device=dev,
    )
    warp_state = train(warp_state, loader_pair, step_warp, STEPS_WARP, "warp")
    evaluate(warp_state, make_eval_step(warp_model, mano, device=dev), "warp")

    # --- Control: continue sparse-only for the same extra steps ---
    state = train(state, loader_single, step_base, STEPS_WARP, "control")
    evaluate(state, eval_base, "control")

    base_unsup = mpjpe["baseline", "unannotated"]
    ctrl_unsup = mpjpe["control", "unannotated"]
    warp_unsup = mpjpe["warp", "unannotated"]
    record = {
        "seed": seed,
        "obj_faces": obj_faces,
        "fraction": fraction,
        "frames_per_video": frames,
        "lambda_consist": lambda_consist,
        "spacing": spacing,
        "baseline_mpjpe_unannotated_mm": round(base_unsup, 2),
        "control_extra_steps_mpjpe_unannotated_mm": round(ctrl_unsup, 2),
        "warp_mpjpe_unannotated_mm": round(warp_unsup, 2),
        "baseline_mpjpe_all_mm": round(mpjpe["baseline", "all"], 2),
        "warp_mpjpe_all_mm": round(mpjpe["warp", "all"], 2),
        "consistency_gain_mm": round(ctrl_unsup - warp_unsup, 2),
    }
    print(json.dumps(record), flush=True)
    return Run(record, mpjpe, seconds, state, warp_state)


def parse_args(argv=None):
    """The reference's command line: (seeds, obj_faces, fractions, frames,
    lambda_consist, spacings)."""
    import argparse

    ap = argparse.ArgumentParser("repro_torch_consistency")
    ap.add_argument("--obj_faces", type=int, default=0)
    ap.add_argument("--fraction", type=float, default=[FRACTION], nargs="+",
                    help="annotated-frame fraction(s); several values run "
                         "a sparsity ablation in one process")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help="frames per synthetic video (16 enables "
                         "fractions down to 1/16)")
    ap.add_argument("--lambda_consist", type=float, default=2.0,
                    help="photometric-consistency loss weight in the warp "
                         "phase (diagnostic knob for divergent runs)")
    ap.add_argument("--spacing", type=int, default=[3], nargs="+",
                    help="temporal pair spacing(s) in frames (the "
                         "reference's --spacing; several values run a "
                         "spacing ablation in one process)")
    ap.add_argument("seeds_pos", nargs="*", type=int)
    cli = ap.parse_args(argv)
    seeds, fractions, spacings = cli.seeds_pos or [0], cli.fraction, cli.spacing
    # Guard against the nargs="+" footgun: `--fraction 0.25 0.125 0 1 2`
    # silently eats trailing SEEDS as fractions. Pass seeds FIRST:
    # `... 0 1 2 --fraction 0.25 0.125`.
    bad = [f for f in fractions if not 0.0 <= f <= 1.0]
    if bad:
        ap.error(f"--fraction values outside [0, 1]: {bad} "
                 "(did trailing positional seeds get consumed? "
                 "put seeds before --fraction)")
    bad_s = [s for s in spacings if not 1 <= s < cli.frames]
    if bad_s:
        ap.error(f"--spacing values outside [1, frames): {bad_s} "
                 "(did trailing positional seeds get consumed? "
                 "put seeds before --spacing)")
    return seeds, cli.obj_faces, fractions, cli.frames, cli.lambda_consist, spacings


def cli_main(argv=None, device: str | torch.device | None = None) -> list:
    """Every (fraction, spacing, seed) run of the command line, in one
    process, in the reference's order; returns the ``Run``s."""
    seeds, obj_faces, fractions, frames, lambda_consist, spacings = parse_args(argv)
    return [main(seed, obj_faces=obj_faces, fraction=fraction, frames=frames,
                 lambda_consist=lambda_consist, spacing=spacing, device=device)
            for fraction in fractions for spacing in spacings for seed in seeds]


if __name__ == "__main__":
    cli_main()
