"""Evaluation CLI.

Port of ``hocon/cli/evaluate.py``: load a checkpoint, run the val / test
split, print MPJPE / AUC / object vertex error, or with ``--dump_codalab``
write the HO-3D CodaLab ``pred.zip``. Batches are ``BatchLoader``'s with
``shuffle=False, drop_last=False``: every sample once, the tail's padding
rows masked by ``_valid``; with ``--workers N`` they are assembled in N
worker processes (``WorkerEvalLoader``), bit for bit the same.

  python -m hocon_torch.cli.evaluate --dataset synthetic --image_size 64 \\
      --resume checkpoints/run/ckpt

``main(argv, device=None)`` runs on CUDA (or raises without it); tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hocon_torch.cli import opts
from hocon_torch.cli.train import apply_torch_init, build_model
from hocon_torch.data.check import check_dataset
from hocon_torch.data.factory import get_dataset
from hocon_torch.data.pipeline import WorkerEvalLoader
from hocon_torch.device import resolve_device
from hocon_torch.evaluation.codalab import dump_ho3d_codalab
from hocon_torch.train.checkpoints import CheckpointManager
from hocon_torch.train.loop import epoch_pass
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_eval_step


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("hocon_torch.evaluate")
    opts.add_exp_opts(parser)
    opts.add_net_opts(parser)
    opts.add_data_opts(parser)
    parser.add_argument("--dump_codalab", default="",
                        help="dir to write HO-3D pred.zip into")
    return parser


def load_for_eval(args, device: torch.device, optimizer=None):
    """The val split's loader (every sample once; the caller closes it),
    and the train state of the model, restored from ``--resume`` when
    given; returns (loader, state, eval step). With ``--check_data``,
    checks the split instead and exits (code 1 on an anomaly)."""
    mano = opts.load_mano_or_synthetic(args.mano_assets, args.mano_side, device=device)
    ds = get_dataset(
        args.dataset, args.val_split, args.data_root, args.image_size,
        use_objects=args.use_objects, train=False, mano=mano, seed=args.seed,
        center_idx=args.center_idx,  # must match the model's root joint
        synth_videos=args.synth_videos, synth_frames=args.synth_frames,
        decimate_objects_to=args.decimate_objects_to,
        uint8_images=args.uint8_images, device=device,
    )
    if args.check_data:
        raise SystemExit(1 if check_dataset(ds, args.val_split,
                                            max_seqs=args.check_data_seqs) else 0)
    # --workers > 0 assembles the samples in worker processes, into
    # BatchLoader's exact batches and _valid masks.
    loader = WorkerEvalLoader(ds, args.batch_size, worker_count=args.workers)
    model = build_model(args, mano, device)
    state = create_train_state(model, optimizer or make_optimizer())
    state = apply_torch_init(args, model, state)
    if args.resume:
        state = CheckpointManager(args.resume).restore(state)
        print(f"loaded checkpoint from {args.resume}")
    return loader, state, make_eval_step(model, mano, device=device)


def predictions(loader, state, eval_step):
    """Per batch: the predictions of the valid rows, on the host."""
    for batch in loader.epoch(0):
        keep = np.asarray(batch.pop("_valid")) > 0
        preds = eval_step(state, batch)
        yield {k: v.cpu().numpy()[keep] for k, v in preds.items()}


def main(argv=None, device: str | torch.device | None = None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    loader, state, eval_step = load_for_eval(args, dev, make_optimizer(args.optimizer, args.lr))
    with loader:
        if args.dump_codalab:
            all_joints, all_verts = [], []
            for preds in predictions(loader, state, eval_step):
                all_joints.append(preds["joints_cam"])
                all_verts.append(preds["verts_cam"])
            zip_path = dump_ho3d_codalab(
                np.concatenate(all_joints), np.concatenate(all_verts), args.dump_codalab,
            )
            print(f"CodaLab submission written to {zip_path}")
            return zip_path

        _, metrics = epoch_pass(
            loader, state, eval_step, train=False, epoch=0, device=dev,
            max_steps=args.max_steps_per_epoch or None,
        )
    print(f"MPJPE: {metrics['mpjpe_mm']:.2f} mm (median "
          f"{metrics['mpjpe_median_mm']:.2f}), AUC(0-50mm): {metrics['auc']:.4f}")
    if "obj_verts_err_mm" in metrics:
        print(f"object vertex error: {metrics['obj_verts_err_mm']:.2f} mm")
    return metrics


if __name__ == "__main__":
    main()
