"""Baseline supervised training CLI.

Port of ``hocon/cli/train.py``: the same flags, dataset / model / optimizer
construction, resume / auto-restore / warm start, and the epoch loop with
periodic eval and snapshots under ``checkpoints/<exp_id>/``.

  python -m hocon_torch.cli.train --dataset synthetic --image_size 64 \\
      --batch_size 8 --epochs 2 --use_objects

``main(argv, device=None)`` runs on CUDA (or raises without it); tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from hocon_torch.cli import opts
from hocon_torch.data.check import check_dataset
from hocon_torch.data.factory import get_dataset
from hocon_torch.data.pipeline import BatchLoader, WorkerEpochLoader, WorkerEvalLoader
from hocon_torch.device import resolve_device
from hocon_torch.exp.args import save_args
from hocon_torch.models.backbone import STAGE_SIZES as _IMPORT_STAGE_SIZES
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.train.checkpoints import CheckpointManager, restore_for_warm_start
from hocon_torch.train.loop import epoch_pass
from hocon_torch.train.metrics import MetricWriter
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_eval_step, make_train_step


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("hocon_torch.train")
    opts.add_exp_opts(parser)
    opts.add_net_opts(parser)
    opts.add_data_opts(parser)
    return parser


def build_model(args, mano, device: torch.device, seed: int = 0) -> HOCNet:
    if getattr(args, "torch_ckpt", "") and args.use_objects and args.obj_rot_param != "axisang":
        print(
            "[hocon] --torch_ckpt implies --obj_rot_param axisang (the "
            "reference regresses axis-angle; the 6d head has a different "
            "output width) — overriding."
        )
        args.obj_rot_param = "axisang"
    return HOCNet(
        ncomps=args.ncomps,
        center_idx=args.center_idx,
        with_object=args.use_objects,
        block_rot=args.block_rot,
        obj_rot_param=args.obj_rot_param,
        backbone=args.backbone,
        freeze_batchnorm=args.freeze_batchnorm,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        seed=seed,
        device=device,
    )


def apply_torch_init(args, model, state):
    """``--torch_trunk`` / ``--torch_ckpt``: import PyTorch weights into the
    freshly created train state's model, in place (its optimizer keeps
    holding the same parameters). Returns ``state``.

    Callers apply it before resume, auto-restore and warm start, so any
    checkpoint restore overrides the import: the import is an init.
    """
    trunk_path = getattr(args, "torch_trunk", "")
    ckpt_path = getattr(args, "torch_ckpt", "")
    if not trunk_path and not ckpt_path:
        return state
    if trunk_path and ckpt_path:
        raise ValueError("--torch_trunk and --torch_ckpt are exclusive")
    if args.backbone not in _IMPORT_STAGE_SIZES:
        raise ValueError(
            f"torch import supports backbones {sorted(_IMPORT_STAGE_SIZES)}, "
            f"not {args.backbone!r}"
        )
    from hocon_torch.utils.torch_import import (
        import_hocnet,
        import_trunk_into_hocnet,
        load_torch_checkpoint,
    )

    stages = _IMPORT_STAGE_SIZES[args.backbone]
    if ckpt_path:
        import_hocnet(
            model, load_torch_checkpoint(ckpt_path), trunk_prefix=args.torch_trunk_prefix,
            stage_sizes=stages, strict_heads=not getattr(args, "torch_loose", False),
        )
        print(f"[hocon] imported reference checkpoint {ckpt_path}")
    else:
        import_trunk_into_hocnet(model, load_torch_checkpoint(trunk_path), prefix="",
                                 stage_sizes=stages)
        print(f"[hocon] imported ImageNet trunk weights from {trunk_path}")
    return state


def hand_lambdas(args):
    return dict(
        lambda_verts3d=args.mano_lambda_verts3d,
        lambda_joints3d=args.mano_lambda_joints3d,
        lambda_joints2d=args.mano_lambda_joints2d,
        lambda_shape=args.mano_lambda_shape,
        lambda_pose=args.mano_lambda_pose_reg,
    )


def obj_lambdas(args):
    return dict(
        lambda_obj_verts3d=args.obj_lambda_verts3d,
        lambda_obj_verts2d=args.obj_lambda_verts2d,
    )


def setup_common(args, device: torch.device):
    """MANO, the run directory (flags saved), its metric writer, and the
    train and val loaders over datasets made on ``device``. With
    ``--check_data``, checks both datasets instead and exits (code 1 if
    either shows an anomaly)."""
    mano = opts.load_mano_or_synthetic(args.mano_assets, args.mano_side, device=device)
    run_dir = os.path.join("checkpoints", args.exp_id)
    save_args(args, run_dir)
    writer = MetricWriter(run_dir)

    train_ds = get_dataset(
        args.dataset, args.split, args.data_root, args.image_size,
        fraction=args.fraction, use_objects=args.use_objects,
        pair_mode=getattr(args, "pair_mode", False),
        clip_len=getattr(args, "clip_len", 2),
        pair_spacing=args.spacing,
        pair_fixed_spacing=args.pair_fixed_spacing,
        train=True, mano=mano, seed=args.seed,
        center_idx=args.center_idx,
        synth_videos=args.synth_videos, synth_frames=args.synth_frames,
        decimate_objects_to=args.decimate_objects_to,
        uint8_images=args.uint8_images, device=device,
    )
    if getattr(args, "pair_mode", False) and getattr(args, "consist_gt_refs", False):
        from hocon_torch.data.queries import BaseQueries

        pose_ds = train_ds.pose_dataset
        if (
            hasattr(pose_ds, "available_queries")
            and BaseQueries.VERTS3D not in pose_ds.available_queries()
        ):
            print(
                "[hocon] WARNING: --consist_gt_refs requested but the "
                f"{type(pose_ds).__name__} dataset serves no GT hand "
                "vertices; the warp will anchor on PREDICTED ref meshes instead."
            )
    val_ds = get_dataset(
        args.dataset, args.val_split, args.data_root, args.image_size,
        use_objects=args.use_objects, train=False, mano=mano, seed=args.seed,
        center_idx=args.center_idx,
        synth_videos=max(2, args.synth_videos // 4), synth_frames=args.synth_frames,
        decimate_objects_to=args.decimate_objects_to,
        uint8_images=args.uint8_images, device=device,
    )
    if args.check_data:
        n_bad = check_dataset(train_ds, args.split, max_seqs=args.check_data_seqs)
        n_bad += check_dataset(val_ds, args.val_split, max_seqs=args.check_data_seqs)
        raise SystemExit(1 if n_bad else 0)
    if args.workers > 0:
        train_loader = WorkerEpochLoader(train_ds, args.batch_size, seed=args.seed,
                                         worker_count=args.workers)
    else:
        train_loader = BatchLoader(train_ds, args.batch_size, seed=args.seed,
                                   prefetch=args.prefetch)
    # drop_last=False: validation scores every sample exactly once; the
    # tail's padding rows carry _valid = 0. With --workers > 0 the samples
    # are assembled in worker processes, into BatchLoader's exact batches.
    val_loader = WorkerEvalLoader(val_ds, args.batch_size, worker_count=args.workers)
    return mano, run_dir, writer, train_loader, val_loader


def restore(args, state, run_dir: str):
    """``--resume``, else the run's latest snapshot, else ``--warm_start``.
    Returns (state, the run's checkpoint manager)."""
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    if args.resume:
        state = CheckpointManager(args.resume).restore(state)
        print(f"resumed from {args.resume} at step {state.step}")
    elif ckpt.latest_step is not None:
        state = ckpt.restore(state)
        print(f"auto-restored latest snapshot (step {state.step})")
    elif args.warm_start:
        state = restore_for_warm_start(args.warm_start, state)
        print(f"warm-started params from {args.warm_start}")
    return state, ckpt


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def fit(args, state, train_step, eval_step, run_dir, writer, train_loader, val_loader,
        ckpt, device, train_line, vis_fn=None, epoch_vis=None) -> object:
    """The epoch loop: train, eval every ``--eval_freq`` epochs, snapshot
    every ``--snapshot_freq``; ``train_line(metrics)`` formats the train
    summary. ``--profile`` traces epoch 0 into ``<run_dir>/trace``. The
    loaders are closed when it returns or raises.

    With ``--vis_freq N``: ``vis_fn(epoch, i, batch, preds)`` runs on every
    N-th batch of the eval pass (``epoch_pass``'s hook), and
    ``epoch_vis(epoch, state)`` after every N-th train pass."""
    max_steps = args.max_steps_per_epoch or None
    # Worker processes start with a loader's first epoch and stop here.
    with contextlib.closing(train_loader), contextlib.closing(val_loader):
        for epoch in range(args.epochs):
            traced = args.profile and epoch == 0
            with _profiler(device) if traced else contextlib.nullcontext() as prof:
                state, train_metrics = epoch_pass(
                    train_loader, state, train_step, train=True, epoch=epoch,
                    device=device, writer=writer, max_steps=max_steps,
                )
                if traced and device.type == "cuda":
                    torch.cuda.synchronize(device)
            if traced:
                os.makedirs(os.path.join(run_dir, "trace"), exist_ok=True)
                prof.export_chrome_trace(os.path.join(run_dir, "trace", "epoch0.json"))
            if epoch_vis is not None and args.vis_freq and (epoch + 1) % args.vis_freq == 0:
                epoch_vis(epoch, state)
            print(f"[epoch {epoch}] train {train_line(train_metrics)} "
                  f"({train_metrics['steps_per_sec']:.2f} steps/s)")
            if (epoch + 1) % args.eval_freq == 0:
                _, val_metrics = epoch_pass(
                    val_loader, state, eval_step, train=False, epoch=epoch,
                    device=device, writer=writer, max_steps=max_steps,
                    vis_fn=vis_fn, vis_freq=args.vis_freq,
                )
                print(f"[epoch {epoch}] val MPJPE={val_metrics['mpjpe_mm']:.2f}mm "
                      f"AUC={val_metrics['auc']:.3f}")
            if (epoch + 1) % args.snapshot_freq == 0:
                ckpt.save(state.step, state)
    ckpt.wait()
    writer.plot_curves()
    writer.close()
    return state


def main(argv=None, device: str | torch.device | None = None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    t0 = time.perf_counter()

    mano, run_dir, writer, train_loader, val_loader = setup_common(args, dev)
    model = build_model(args, mano, dev, seed=args.seed)
    optimizer = make_optimizer(
        args.optimizer, args.lr, args.momentum, args.weight_decay,
        args.lr_decay_step, args.lr_decay_gamma, args.grad_clip,
    )
    state = create_train_state(model, optimizer)
    state = apply_torch_init(args, model, state)
    state, ckpt = restore(args, state, run_dir)

    train_step = make_train_step(
        model, mano, optimizer, hand_lambdas(args), obj_lambdas(args), device=dev
    )
    eval_step = make_eval_step(model, mano, device=dev)
    vis_fn = None
    if args.vis_freq:
        from hocon_torch.visualize.samplevis import sample_vis

        def vis_fn(ep, i, batch, preds):
            sample_vis(batch, preds, os.path.join(run_dir, "images", f"ep{ep}_b{i}.png"))
    print(f"[hocon] set-up {time.perf_counter() - t0:.3f} s (data, model, restore)")
    return fit(
        args, state, train_step, eval_step, run_dir, writer, train_loader, val_loader,
        ckpt, dev,
        lambda m: f"loss={m.get('loss_total', float('nan')):.4f}",
        vis_fn=vis_fn,
    )


if __name__ == "__main__":
    main()
