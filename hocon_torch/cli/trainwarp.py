"""Photometric-consistency training CLI (frame pairs, sparse supervision).

Port of ``hocon/cli/trainwarp.py``: the frame-pair dataset, the warp loss
through the soft rasterizer and the sampler, usually warm-started from a
baseline checkpoint (``--warm_start``) with a small ``--fraction``. This
is the port's main path: ``get_dataset`` renders the synthetic frames with
kernel K1 at 3 colour channels, and every train step launches K1 (2
attributes) and K3, whose backward launches K2 and K4
(``--raster_backend auto`` or ``pallas``; ``xla`` takes the plain unculled
raster instead).

  python -m hocon_torch.cli.trainwarp --dataset synthetic --image_size 64 \\
      --batch_size 4 --epochs 2 --fraction 0.25 --use_objects

``main(argv, device=None)`` runs on CUDA (or raises without it); tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch

from hocon_torch.cli import opts
from hocon_torch.cli.train import (
    build_model,
    build_parser as _train_parser,
    fit,
    hand_lambdas,
    obj_lambdas,
    restore,
    setup_common,
)
from hocon_torch.device import resolve_device
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_eval_step, make_warp_train_step


def build_parser():
    parser = _train_parser()
    parser.prog = "hocon_torch.trainwarp"
    opts.add_warp_opts(parser)
    return parser


def main(argv=None, device: str | torch.device | None = None):
    args = build_parser().parse_args(argv)
    args.pair_mode = True
    opts.check_unported(args)
    dev = resolve_device(device)
    t0 = time.perf_counter()

    mano, run_dir, writer, train_loader, val_loader = setup_common(args, dev)
    model = build_model(args, mano, dev, seed=args.seed)
    optimizer = make_optimizer(
        args.optimizer, args.lr, args.momentum, args.weight_decay,
        args.lr_decay_step, args.lr_decay_gamma, args.grad_clip,
    )
    state = create_train_state(model, optimizer)
    state, ckpt = restore(args, state, run_dir)

    train_step = make_warp_train_step(
        model, mano, optimizer,
        image_size=(args.image_size, args.image_size),
        hand_lambdas=hand_lambdas(args), obj_lambdas=obj_lambdas(args),
        lambda_consist=args.lambda_consist,
        consist_gt_refs=args.consist_gt_refs,
        sigma=args.raster_sigma, gamma=args.raster_gamma,
        backend=args.raster_backend, photo_downscale=args.photo_downscale,
        device=dev,
    )
    eval_step = make_eval_step(model, mano, device=dev)
    print(f"[hocon] set-up {time.perf_counter() - t0:.3f} s (data, model, restore)")
    return fit(
        args, state, train_step, eval_step, run_dir, writer, train_loader, val_loader,
        ckpt, dev,
        lambda m: (f"loss={m.get('loss_total', float('nan')):.4f} "
                   f"photo={m.get('photo_total', float('nan')):.4f}"),
    )


if __name__ == "__main__":
    main()
