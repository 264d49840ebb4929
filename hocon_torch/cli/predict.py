"""Batch inference CLI: per-frame predictions for downstream use.

Port of ``hocon/cli/predict.py``: load a checkpoint, run a dataset split
and write ``predictions.npz`` (camera-frame joints / vertices,
root-centred mm outputs, 2D keypoints and, with objects, object vertices),
covering the split exactly once: the padding rows of the tail batch are
dropped by their ``_valid`` mask.

  python -m hocon_torch.cli.predict --dataset synthetic --image_size 64 \\
      --resume checkpoints/run/ckpt --out preds/

``main(argv, device=None)`` runs on CUDA (or raises without it); tests
pass ``device="cpu"``. On N cards (``torchrun --nproc_per_node N -m
hocon_torch.cli.predict ...``) each rank predicts its shard of every
batch and rank 0 writes the gathered predictions, in the split's order.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hocon_torch.cli import opts
from hocon_torch.cli.evaluate import load_for_eval, predictions
from hocon_torch.train.sharding import Mesh, process_mesh


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("hocon_torch.predict")
    opts.add_exp_opts(parser)
    opts.add_net_opts(parser)
    opts.add_data_opts(parser)
    parser.add_argument("--out", default="preds", help="output directory")
    return parser


def main(argv=None, device: str | torch.device | None = None, mesh: Mesh | None = None):
    args = build_parser().parse_args(argv)
    with process_mesh(device, mesh) as mesh:
        loader, state, eval_step = load_for_eval(args, mesh)

        collected: dict[str, list] = {}
        with loader:
            for preds in predictions(loader, state, eval_step, mesh):
                for k, v in preds.items():
                    collected.setdefault(k, []).append(v)
        if not mesh.is_main:
            return None
        os.makedirs(args.out, exist_ok=True)
        out_path = os.path.join(args.out, "predictions.npz")
        np.savez_compressed(
            out_path, **{k: np.concatenate(v) for k, v in collected.items()}
        )
        total = sum(len(a) for a in collected.get("joints_cam", []))
        print(f"wrote {total} frame predictions ({sorted(collected)}) to {out_path}")
        return out_path


if __name__ == "__main__":
    main()
