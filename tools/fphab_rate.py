#!/usr/bin/env python3
"""The trainer's step rate on FPHAB frames, with three decode variants.

    python3 tools/fphab_rate.py [--frames 64] [--rounds 1] [--out DIR]   # one CUDA card

Writes an FPHAB tree as ``chip_smoke.py``'s ``real_data`` phase does (3
train sequences and 1 test sequence of ``--frames`` 1920 x 1080 nvJPEG
frames, a 20000-face PLY object), then runs ``hocon_torch.cli.trainwarp``
on it (batch 16, 256^2, objects, one epoch, the CLI's default prefetch of
2 batches) once per variant and round, in the order A B C C B A:

- ``own``: the code as it is: ``read_image`` decodes each frame on its
  thread's own non-blocking stream, the colour stage by ``jpeg_ycc_rgb``;
- ``default``: the decodes on the default stream, which the train step
  uses too (the decoder context's stream replaced by the default stream);
- ``plain``: the colour stage by ``ycc_to_rgb_plain`` on the card, in
  place of the ``jpeg_ycc_rgb`` kernel.

Prints one line per run (the CLI's ``steps_per_sec``, past its 2 warm-up
steps, and the call's wall time) and a summary line, each ending with the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("own", "default", "plain", "plain", "default", "own")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64, help="frames per sequence")
    ap.add_argument("--rounds", type=int, default=1, help="repeats of A B C C B A")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "hocon_torch", "fphab_rate"),
                    help="directory for the tree and the runs (removed at the end)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as CS
    from hocon_torch.cli import trainwarp
    from hocon_torch.data import images
    from hocon_torch.geometry.mano import synthetic_mano_model

    if not torch.cuda.is_available():
        CS.fail("fphab_rate runs on a CUDA card")
    smi = CS.phase_device(torch)
    device = "cuda"
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="fphab-", dir=args.out)
    here = os.getcwd()
    own_context, kernel = images._context, images.ycc_to_rgb_cuda

    def default_stream_context(dev):
        ctx = own_context(dev)
        return types.SimpleNamespace(lib=ctx.lib, ptr=ctx.ptr,
                                     stream=torch.cuda.default_stream(dev))

    variants = {"own": (own_context, kernel), "default": (default_stream_context, kernel),
                "plain": (own_context, images.ycc_to_rgb_plain)}
    rates = {name: [] for name in variants}
    try:
        os.chdir(work)
        CS.REAL_FRAMES = args.frames
        tree, assets = os.path.join(work, "fphab"), os.path.join(work, "mano")
        os.makedirs(assets)
        t0 = time.perf_counter()
        CS.write_fphab_tree(torch, device, synthetic_mano_model(0, device=device), tree)
        CS.log(f"fphab_rate: wrote 4 sequences of {args.frames} frames in "
               f"{time.perf_counter() - t0:.1f} s; card {smi}")
        for i, name in enumerate(ORDER * args.rounds):
            images._context, images.ycc_to_rgb_cuda = variants[name]
            argv = CS.cli_argv({"dataset": "fhbhands", "data_root": tree, "image_size": CS.RES,
                                "batch_size": CS.PAIRS, "use_objects": True,
                                "mano_assets": assets, "fraction": 0.25, "epochs": 1,
                                "lr": 5e-4, "exp_id": f"rate{i}"})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CS.run_cli(trainwarp.main, argv, device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(work, "checkpoints", f"rate{i}", "epochs.json")) as fh:
                rate = [e["steps_per_sec"] for e in json.load(fh) if e["split"] == "train"][0]
            rates[name].append(rate)
            CS.log(f"fphab_rate: {name}: steps_per_sec {rate:.4f}, the call {wall:.2f} s; "
                   f"card {smi}")
    finally:
        images._context, images.ycc_to_rgb_cuda = own_context, kernel
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    CS.log("fphab_rate: steps_per_sec " + "; ".join(
        f"{name} {' / '.join(f'{r:.4f}' for r in rs)}" for name, rs in rates.items())
        + f"; card {smi}")


if __name__ == "__main__":
    main()
