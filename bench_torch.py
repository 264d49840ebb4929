#!/usr/bin/env python3
"""Throughput benchmark of hocon_torch on one CUDA card.

    python3 bench_torch.py [--obj_faces N | --toy]

The workload of ``bench.py`` on the port: the synthetic dataset at 256^2
(2 videos x 16 frames, a quarter of the frames annotated, the hand plus a
1280-face UV sphere, or the 12-face box with ``--toy``) rendered on the card
with kernel K1, one batch of 16 frame pairs from ``BatchLoader``, then the
photometric-consistency train step (HOCNet with a ResNet-18 trunk in bf16
autocast and frozen batch norm, the MANO layer, the CUDA soft raster and
sampler at 256^2, masked SSIM + L1 warp loss, full backward, Adam at 1e-4):
3 warm-up steps, then 60 timed steps on that batch ending in
``torch.cuda.synchronize()``.

Prints exactly one JSON line on stdout, with ``bench.py``'s keys; the
card's ``nvidia-smi`` name and power limit, the data set-up and the warm-up
go to stderr. Runs on CUDA only: without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PROVISIONAL_BASELINE_PAIRS_PER_SEC = 25.0  # bench.py's estimate for the reference
BATCH_PAIRS = 16
RES = 256
TIMED_STEPS = 60
WARMUP_STEPS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def dataset_kwargs(obj_faces: int) -> dict:
    """``get_dataset`` arguments of ``bench.py``'s workload, ``mano`` and
    ``device`` aside; ``chip_smoke.py`` builds its data from them too."""
    return dict(
        name="synthetic", split="train", image_size=RES, use_objects=True, train=True,
        pair_mode=True, fraction=0.25, synth_videos=2,
        synth_frames=max(4, (2 * BATCH_PAIRS) // 2), seed=0, synth_obj_faces=obj_faces,
    )


def main(argv=None) -> None:
    import torch

    from hocon_torch.data.factory import get_dataset
    from hocon_torch.data.pipeline import BatchLoader
    from hocon_torch.device import resolve_device
    from hocon_torch.geometry.mano import synthetic_mano_model
    from hocon_torch.models.hocnet import HOCNet
    from hocon_torch.train.state import create_train_state, make_optimizer
    from hocon_torch.train.steps import batch_to_device, make_warp_train_step

    ap = argparse.ArgumentParser("bench_torch")
    ap.add_argument("--obj_faces", type=int, default=1280,
                    help="object mesh faces before the hand is merged (default: the "
                         "realistic decimated-YCB-scale sphere)")
    ap.add_argument("--toy", action="store_true", help="the 12-face box object")
    cli = ap.parse_args(argv)
    obj_faces = 0 if cli.toy else cli.obj_faces

    dev = resolve_device(None)  # CUDA, or raise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"workload: {'toy 12-face box' if obj_faces == 0 else f'{obj_faces}-face object'}")

    mano = synthetic_mano_model(0, device=dev)
    t0 = time.perf_counter()
    ds = get_dataset(**dataset_kwargs(obj_faces), mano=mano, device=dev)
    loader = BatchLoader(ds, batch_size=BATCH_PAIRS, seed=0, drop_last=False)
    batch = batch_to_device(next(iter(loader)), dev)
    torch.cuda.synchronize()
    log(f"data setup: {time.perf_counter() - t0:.2f}s (K1 render, crop/augment, H2D)")

    # The port's batch norm is always frozen (bench.py: freeze_batchnorm=True).
    model = HOCNet(with_object=True, dtype=torch.bfloat16, seed=0, device=dev)
    optimizer = make_optimizer("adam", 1e-4)
    state = create_train_state(model, optimizer)
    step = make_warp_train_step(model, mano, optimizer, image_size=(RES, RES),
                                backend="auto", device=dev)

    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        state, terms = step(state, batch)
    torch.cuda.synchronize()
    log(f"warmup ({WARMUP_STEPS} steps): {time.perf_counter() - t0:.2f}s; "
        f"loss={float(terms['loss_total']):.4f}")

    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, terms = step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    n_chips = 1
    pairs_per_sec_per_chip = BATCH_PAIRS * TIMED_STEPS / dt / n_chips
    log(f"{TIMED_STEPS} steps in {dt:.3f}s -> {pairs_per_sec_per_chip:.2f} pairs/s/chip; "
        f"loss={float(terms['loss_total']):.4f}; card {smi}")
    workload = "toy box object" if obj_faces == 0 else f"realistic {obj_faces}-face object"
    print(json.dumps({
        "metric": "frame-pairs/sec/chip, photometric-consistency train step "
                  "(256px, ResNet-18 bf16, CUDA soft raster, batch 16, "
                  f"{workload})",
        "value": round(pairs_per_sec_per_chip, 3),
        "unit": "pairs/s/chip",
        "vs_baseline": round(pairs_per_sec_per_chip / PROVISIONAL_BASELINE_PAIRS_PER_SEC, 3),
    }))


if __name__ == "__main__":
    main()
