"""Epoch loop.

Port of ``hocon/train/loop.py``: iterate the loader, run the step on each
batch, keep running means of every loss term, and in eval mode feed
``EvalUtil`` and the object vertex / corner meters. Each batch goes onto
``device`` with ``steps.batch_to_device``, or with a data-parallel ``mesh``
onto the rank's device (``sharding.shard_batch``, as the reference's
``mesh``). Under a mesh the train terms come out of the step already summed
over the ranks, and an eval pass gathers each batch's scored rows in shard
order, so every rank's metrics are the global batch's.

The host never waits on the card per step. Train terms stay on the device
and are fetched in one transfer per ``METRIC_SYNC_STEPS`` steps; eval runs
one batch deep, scoring the previous batch's predictions while the card
computes the current one.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hocon_torch.device import resolve_device
from hocon_torch.evaluation.zimeval import EvalUtil, VertexErrorMeter
from hocon_torch.train.metrics import AverageMeters, StepTimer
from hocon_torch.train.sharding import Mesh, gather_rows, shard_batch
from hocon_torch.train.steps import batch_to_device
from hocon_torch.utils.trace import span

METRIC_SYNC_STEPS = 20
# What an eval pass scores: batch fields and predictions gathered over a mesh.
SCORED_FIELDS = ("joints3d", "_valid", "objverts3d", "obj_verts_mask", "objcorners3d")
SCORED_PREDS = ("joints_c_mm", "obj_verts_c_mm", "obj_corners_c_mm")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fetch_terms(pending: list) -> list:
    """Scalar term dicts -> dicts of floats. Tensors are stacked and copied
    to the host in one transfer (float64, so f32 values stay exact)."""
    flat = [(i, k, v) for i, terms in enumerate(pending) for k, v in terms.items()]
    if all(isinstance(v, torch.Tensor) for _, _, v in flat):
        values = torch.stack([v.detach().reshape(()).double() for _, _, v in flat]).cpu().tolist()
    else:
        values = [float(np.asarray(v)) for _, _, v in flat]
    out = [{} for _ in pending]
    for (i, k, _), v in zip(flat, values):
        out[i][k] = v
    return out


def _waited(batches):
    """``batches`` with each wait for the next one in a ``data.wait`` span."""
    batches, end = iter(batches), object()
    while True:
        with span("data.wait"):
            batch = next(batches, end)
        if batch is end:
            return
        yield batch


def epoch_pass(
    loader,
    state,
    step_fn: Callable,
    train: bool,
    epoch: int = 0,
    device: str | torch.device | None = None,
    writer=None,
    max_steps: Optional[int] = None,
    vis_fn: Optional[Callable] = None,
    vis_freq: int = 0,
    pck_thresholds: Sequence[float] = (15.0, 30.0, 45.0),
    mesh: Optional[Mesh] = None,
) -> tuple:
    """Run one epoch on ``device`` (CUDA when None), or on the rank's device
    of a data-parallel ``mesh``. Returns (state, metrics).

    In train mode ``step_fn(state, batch) -> (state, terms)``.
    In eval mode ``step_fn(state, batch) -> preds`` and MPJPE / AUC / PCK /
    object vertex and corner errors are accumulated on the host; ``vis_fn``
    runs on rank 0's shard.
    """
    if not train and getattr(loader, "train_only", False):
        raise ValueError(
            f"{type(loader).__name__} is train-only (drops the dataset tail "
            "and carries no _valid masks); evaluation must use BatchLoader "
            "so every sample is scored exactly once."
        )
    dev = mesh.device if mesh is not None else resolve_device(device)
    meters = AverageMeters()
    timer = StepTimer()
    evaluator = EvalUtil() if not train else None
    obj_meter = VertexErrorMeter() if not train else None
    corner_meter = VertexErrorMeter() if not train else None

    step_base = None
    pending: list = []
    flushed = 0

    def flush_pending():
        nonlocal flushed
        if not pending:
            return
        for off, terms in enumerate(fetch_terms(pending)):  # one transfer
            meters.update(terms)
            if writer is not None:
                writer.log_step(step_base + flushed + off, terms)
        flushed += len(pending)
        pending.clear()

    pending_eval = None

    def score_eval(i, batch, preds):
        preds = {k: _host(v) for k, v in preds.items()}
        if vis_fn is not None and vis_freq and i % vis_freq == 0 and (
                mesh is None or mesh.is_main):
            vis_fn(epoch, i, batch, preds)
        if mesh is not None and mesh.world > 1:
            rows = gather_rows({**{k: np.asarray(batch[k]) for k in SCORED_FIELDS if k in batch},
                                **{f"pred/{k}": preds[k] for k in SCORED_PREDS if k in preds}},
                               mesh)
            batch = {k: v for k, v in rows.items() if not k.startswith("pred/")}
            preds = {k[len("pred/"):]: v for k, v in rows.items() if k.startswith("pred/")}
        gt_j = np.asarray(batch["joints3d"])
        # Wrap-around padding rows (drop_last=False) carry _valid == 0 and
        # must not bias the metrics.
        keep = (
            np.asarray(batch["_valid"]) > 0
            if "_valid" in batch
            else np.ones(gt_j.shape[0], bool)
        )
        evaluator.feed(gt_j[keep], preds["joints_c_mm"][keep])
        if "obj_verts_c_mm" in preds and "objverts3d" in batch:
            ovm = (
                np.asarray(batch["obj_verts_mask"])[keep]
                if "obj_verts_mask" in batch
                else None
            )
            obj_meter.feed(
                np.asarray(batch["objverts3d"])[keep],
                preds["obj_verts_c_mm"][keep],
                ovm,
            )
        if "obj_corners_c_mm" in preds and "objcorners3d" in batch:
            corner_meter.feed(
                np.asarray(batch["objcorners3d"])[keep],
                preds["obj_corners_c_mm"][keep],
            )

    for i, batch in enumerate(_waited(loader.epoch(epoch))):
        if max_steps is not None and i >= max_steps:
            break
        with span("data.to_device"):
            dev_batch = (shard_batch(batch, mesh) if mesh is not None
                         else batch_to_device(batch, dev))
        if train:
            if step_base is None:
                step_base = int(state.step) + 1
            state, terms = step_fn(state, dev_batch)
            pending.append(terms)
            if len(pending) >= METRIC_SYNC_STEPS:
                flush_pending()
        else:
            # Queue this batch's forward, then score the previous batch (on
            # the host copy) while the card runs.
            preds = step_fn(state, dev_batch)
            if pending_eval is not None:
                score_eval(*pending_eval)
            pending_eval = (i, batch, preds)
        timer.tick()

    if pending_eval is not None:
        score_eval(*pending_eval)
    flush_pending()
    metrics = meters.averages()
    metrics["steps_per_sec"] = timer.rate()
    if not train:
        epe_mean, epe_med, auc, pck, thresh = evaluator.get_measures(0.0, 50.0, 20)
        metrics.update(mpjpe_mm=epe_mean, mpjpe_median_mm=epe_med, auc=auc)
        # PCK at the requested thresholds, interpolated on the measured curve.
        thresh = np.asarray(thresh, np.float64)
        pck = np.asarray(pck, np.float64)
        for t in pck_thresholds:
            metrics[f"pck@{float(t):.1f}mm"] = float(np.interp(t, thresh, pck))
        if obj_meter._count:
            metrics["obj_verts_err_mm"] = obj_meter.mean
        if corner_meter._count:
            metrics["obj_corners_err_mm"] = corner_meter.mean
    if writer is not None:
        writer.log_epoch(epoch, "train" if train else "val", metrics)
    return state, metrics
